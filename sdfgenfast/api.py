"""Public API, mirroring the reference's Python surface.

The reference exposes ``load_mesh, generate_sdf, save_sdf, load_sdf,
is_gpu_available`` from the nanobind extension (``python/sdfgen_py.cpp:316-411``)
plus the pure-Python ``generate_from_mesh`` / ``generate_from_file`` wrappers
(``python/sdfgen.py:47-265``). We keep the same signatures, argument
validation, error types and backend vocabulary:
``backend = "auto" | "cpu" | "gpu"`` (the unified-dispatch semantics of
``common/sdfgen_unified.cpp:30-71``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .grid import GridSpec, sizing_python_api
from .mesh import Mesh
from .io import mesh_io as _mesh_io
from .io import sdf_io as _sdf_io
from .pipeline import SDFConfig, make_level_set3

__all__ = [
    "generate_sdf_batch",
    "load_mesh",
    "generate_sdf",
    "save_sdf",
    "load_sdf",
    "is_gpu_available",
    "generate_from_mesh",
    "generate_from_file",
]


def _gpu_devices():
    import jax

    try:
        return jax.local_devices(backend="gpu")
    except RuntimeError:  # no CUDA backend in this process
        return []


def is_gpu_available() -> bool:
    """Runtime CUDA-device probe (common/sdfgen_unified.cpp:19-28)."""
    return bool(_gpu_devices())


def _resolve_backend(backend: str):
    """'auto' -> gpu if available else cpu; forced 'gpu' raises if absent,
    matching the forced-GPU throw (common/sdfgen_unified.cpp:60-63)."""
    import jax

    if backend not in ("auto", "cpu", "gpu"):
        raise ValueError(
            f"Invalid backend: {backend} (must be 'auto', 'cpu', or 'gpu')"
        )
    gpus = _gpu_devices() if backend != "cpu" else []
    if backend == "gpu" and not gpus:
        raise RuntimeError("GPU backend requested but no GPU is available")
    if gpus:
        return gpus[0]
    return jax.local_devices(backend="cpu")[0]


def load_mesh(filename: str) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """Returns (vertices (N,3) f32, triangles (M,3) u32, bounds tuple) like
    sdfgen_py.cpp:101-157."""
    mesh, mn, mx = _mesh_io.load_mesh(str(filename))
    bounds = (tuple(float(v) for v in mn), tuple(float(v) for v in mx))
    return mesh.verts, mesh.tris, bounds


def _validate_mesh_arrays(vertices, triangles):
    """Shape/dtype validation with the reference's conversion semantics:
    compatible numeric dtypes are AUTO-CONVERTED to float32/uint32 (the
    nanobind layer converts int32 inputs, python/tests/test_sdfgen.py:770-800)
    and non-contiguous inputs are copied; wrong shapes/kinds raise."""
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise TypeError(f"vertices must have shape (N, 3), got {vertices.shape}")
    if triangles.ndim != 2 or triangles.shape[1] != 3:
        raise TypeError(f"triangles must have shape (M, 3), got {triangles.shape}")
    if not np.issubdtype(vertices.dtype, np.floating) and not np.issubdtype(
        vertices.dtype, np.integer
    ):
        raise TypeError(f"vertices dtype must be numeric, got {vertices.dtype}")
    if not np.issubdtype(triangles.dtype, np.integer):
        raise TypeError(f"triangles dtype must be an integer type, got {triangles.dtype}")
    if np.issubdtype(triangles.dtype, np.signedinteger) and triangles.size:
        if int(triangles.min()) < 0:
            raise ValueError("triangle indices must be non-negative")
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    triangles = np.ascontiguousarray(triangles, dtype=np.uint32)
    return vertices, triangles


def generate_sdf(
    vertices: np.ndarray,
    triangles: np.ndarray,
    origin,
    dx: float,
    nx: int,
    ny: int,
    nz: int,
    exact_band: int = 1,
    backend: str = "auto",
    num_threads: int = 0,
    far_field: str = "exact",
) -> np.ndarray:
    """Generate an (nx, ny, nz) float32 SDF. Signature and validation follow
    sdfgen_py.cpp:160-218 (`num_threads` is accepted for compatibility and
    ignored: parallelism is device-level here)."""
    import jax

    vertices, triangles = _validate_mesh_arrays(vertices, triangles)
    if vertices.shape[0] == 0 or triangles.shape[0] == 0:
        raise ValueError(
            "Cannot generate SDF from empty mesh (vertices or triangles are empty)"
        )
    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError("Grid dimensions must be positive (nx, ny, nz > 0)")
    if not (float(dx) > 0.0):
        raise ValueError("Cell spacing dx must be positive")
    del num_threads
    dev = _resolve_backend(backend)

    grid = GridSpec(tuple(float(v) for v in origin), float(dx), (int(nx), int(ny), int(nz)))
    mesh = Mesh(vertices, triangles)
    config = SDFConfig(exact_band=exact_band, far_field=far_field)
    with jax.default_device(dev):
        phi = make_level_set3(mesh, grid, config)
        return np.asarray(phi)


def generate_sdf_batch(
    meshes,
    origin,
    dx: float,
    nx: int,
    ny: int,
    nz: int,
    exact_band: int = 1,
    backend: str = "auto",
    far_field: str = "exact",
    device_mesh=None,
):
    """Generate SDFs for a BATCH of meshes on one shared grid.

    `meshes` is a sequence of (vertices, triangles) pairs (the reference has
    no batch API; this serves the "batch of 100k-triangle
    meshes at 512-class grids across hosts"). Returns a list of
    (nx, ny, nz) float32 arrays.

    `device_mesh`: a ``jax.sharding.Mesh`` from
    ``parallel.make_device_mesh`` (single process) or
    ``parallel.multihost.global_device_mesh`` (multi-process). When given,
    each SDF runs the SHARDED pipeline over the mesh — the grid is tiled
    over the devices and each shard runs the same Pallas band + pyramid
    far-field kernels as a single-device run; in multi-process mode the
    assembled grids are gathered to every process.

    Device-efficiency design: one compiled program is REUSED across the
    whole batch — host-side binning pads candidate shapes to coarse buckets
    (pipeline._bucket), so meshes of similar size hit the jit cache instead
    of recompiling, and the persistent compilation cache covers the rest.
    Each mesh's host binning (NumPy/C++) runs while the previous mesh's
    device program executes, overlapping the two pipelines (one-deep:
    bin mesh k+1 while mesh k computes, then collect mesh k).
    """
    import jax

    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError("Grid dimensions must be positive (nx, ny, nz > 0)")
    if not (float(dx) > 0.0):
        raise ValueError("Cell spacing dx must be positive")
    dev = _resolve_backend(backend)
    grid = GridSpec(tuple(float(v) for v in origin), float(dx),
                    (int(nx), int(ny), int(nz)))
    config = SDFConfig(exact_band=exact_band, far_field=far_field)

    from .pipeline import bin_mesh

    validated = []
    for vertices, triangles in meshes:
        v, t = _validate_mesh_arrays(vertices, triangles)
        if v.shape[0] == 0 or t.shape[0] == 0:
            raise ValueError(
                "Cannot generate SDF from empty mesh "
                "(vertices or triangles are empty)"
            )
        validated.append(Mesh(v, t))

    if device_mesh is not None:
        return _sharded_batch(validated, grid, config, device_mesh)

    out = []
    with jax.default_device(dev):
        pending = None  # device array still computing while we bin the next
        cross_rows = 0  # running max crossings bucket: keeps ONE traced
        # program across meshes whose natural C buckets differ
        for mesh in validated:
            binned = bin_mesh(mesh, grid, config,
                              min_cross_rows=cross_rows)
            if binned.parity_crossings is not None:
                cross_rows = max(cross_rows,
                                 binned.parity_crossings.shape[0])
            if pending is not None:
                out.append(np.asarray(pending))
            pending = make_level_set3(mesh, grid, config, binned=binned)
            try:
                # start the device->host copy NOW so it overlaps the next
                # mesh's host binning (and, on remote links, the next
                # dispatch): the grids are 10s-100s of MB each
                pending.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
        if pending is not None:
            out.append(np.asarray(pending))
    return out


def _sharded_batch(validated, grid: GridSpec, config: SDFConfig,
                   device_mesh):
    """Batch x sharded x (optionally) multihost composition: each mesh's
    host binning overlaps the previous mesh's sharded device compute
    (dispatch is asynchronous until the result is fetched), and every
    process collects identical assembled grids."""
    import jax

    from .parallel.sharded import bin_mesh_sharded, sharded_sdf
    from .parallel.multihost import (
        assemble_blocks, fetch_global, sharded_sdf_multihost,
    )

    dims = tuple(device_mesh.devices.shape)
    multi = jax.process_count() > 1

    def launch(mesh):
        sb = bin_mesh_sharded(mesh, grid, dims, config)
        if multi:
            return sharded_sdf_multihost(sb, device_mesh, mesh.verts)
        return sharded_sdf(sb, device_mesh, verts=mesh.verts,
                           assemble=False)

    def collect(blocks):
        return assemble_blocks(fetch_global(blocks))

    out = []
    pending = None
    for mesh in validated:
        if pending is not None:
            launched = launch(mesh)  # bin k+1 while k computes
            out.append(collect(pending))
            pending = launched
        else:
            pending = launch(mesh)
    if pending is not None:
        out.append(collect(pending))
    return out


def save_sdf(filename: str, sdf_array: np.ndarray, origin, dx: float) -> None:
    sdf_array = np.asarray(sdf_array)
    if sdf_array.ndim != 3:
        raise ValueError("SDF array must be 3-dimensional")
    if 0 in sdf_array.shape:
        raise ValueError("SDF array dimensions cannot be zero")
    _sdf_io.write_sdf(str(filename), sdf_array, origin, float(dx))


def load_sdf(filename: str):
    """Returns (sdf, origin, dx, bounds); dx derived from the x extent only,
    like sdfgen_py.cpp:300."""
    phi, mn, mx = _sdf_io.read_sdf(str(filename))
    dx = float((mx[0] - mn[0]) / phi.shape[0])
    origin = (float(mn[0]), float(mn[1]), float(mn[2]))
    bounds = (origin, (float(mx[0]), float(mx[1]), float(mx[2])))
    return phi, origin, dx, bounds


def generate_from_mesh(
    vertices: np.ndarray,
    triangles: np.ndarray,
    nx: int,
    ny: Optional[int] = None,
    nz: Optional[int] = None,
    dx: Optional[float] = None,
    padding: int = 1,
    exact_band: int = 1,
    backend: str = "auto",
    num_threads: int = 0,
    far_field: str = "exact",
) -> Tuple[np.ndarray, dict]:
    """Auto grid sizing from array bounds — python/sdfgen.py:47-142 semantics."""
    vertices = np.asarray(vertices)
    min_box = vertices.min(axis=0)
    max_box = vertices.max(axis=0)
    extents = max_box - min_box
    if ny is None or nz is None:
        if dx is None:
            dx = float(extents[0]) / nx
        ny = int(np.ceil(extents[1] / dx)) if ny is None else ny
        nz = int(np.ceil(extents[2] / dx)) if nz is None else nz
    else:
        if dx is None:
            dx = float(max(extents[0] / nx, extents[1] / ny, extents[2] / nz))
    nx += 2 * padding
    ny += 2 * padding
    nz += 2 * padding
    origin = min_box - padding * np.float32(dx)
    sdf = generate_sdf(
        vertices,
        triangles,
        tuple(origin),
        dx,
        nx,
        ny,
        nz,
        exact_band=exact_band,
        backend=backend,
        num_threads=num_threads,
        far_field=far_field,
    )
    metadata = {
        "origin": tuple(float(v) for v in origin),
        "dx": dx,
        "bounds": (tuple(float(v) for v in min_box), tuple(float(v) for v in max_box)),
        "backend": backend,
    }
    return sdf, metadata


def generate_from_file(
    filename: str,
    nx: Optional[int] = None,
    ny: Optional[int] = None,
    nz: Optional[int] = None,
    dx: Optional[float] = None,
    padding: int = 1,
    exact_band: int = 1,
    backend: str = "auto",
    num_threads: int = 0,
    far_field: str = "exact",
) -> Tuple[np.ndarray, dict]:
    """Load + size + generate — python/sdfgen.py:145-265 semantics."""
    vertices, triangles, bounds = load_mesh(filename)
    min_box = np.array(bounds[0], dtype=np.float32)
    max_box = np.array(bounds[1], dtype=np.float32)
    spec = sizing_python_api(min_box, max_box, nx, ny, nz, dx, padding)
    sdf = generate_sdf(
        vertices,
        triangles,
        spec.origin,
        spec.dx,
        *spec.shape,
        exact_band=exact_band,
        backend=backend,
        num_threads=num_threads,
        far_field=far_field,
    )
    metadata = {
        "origin": spec.origin,
        "dx": spec.dx,
        "bounds": (tuple(float(v) for v in min_box), tuple(float(v) for v in max_box)),
        "backend": backend,
    }
    return sdf, metadata
