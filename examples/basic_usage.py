#!/usr/bin/env python
"""Walkthrough examples for sdfgenfast — the analog of the reference's
``python/examples/basic_usage.py`` (6 examples, same progression), plus a
seventh for the capability the reference lacks: differentiable SDFs.

Run:  python examples/basic_usage.py [example_number ...]
With no arguments, all examples run in order. Everything uses the tiny
bundled test meshes so each example finishes in seconds (first JAX compile
of a new grid shape is the slow part).
"""

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import sdfgenfast as sg  # noqa: E402

RESOURCES = os.path.join(REPO, "tests", "resources")
BOX_STL = os.path.join(RESOURCES, "box345.stl")
BOX_OBJ = os.path.join(RESOURCES, "box345.obj")


def banner(title):
    print("\n" + "=" * 60)
    print(title)
    print("=" * 60)


def example_1_load_and_generate():
    """Low-level API: load a mesh, size a grid manually, generate."""
    banner("Example 1: Load mesh and generate SDF (low-level API)")

    vertices, triangles, bounds = sg.load_mesh(BOX_STL)
    print(f"Loaded {len(vertices)} vertices, {len(triangles)} triangles")
    print(f"Bounds: {bounds[0]} to {bounds[1]}")

    min_box = np.array(bounds[0], dtype=np.float32)
    max_box = np.array(bounds[1], dtype=np.float32)
    nx = ny = nz = 32
    dx = float((max_box - min_box).max()) / (nx - 2)
    origin = tuple(min_box - dx)

    sdf = sg.generate_sdf(vertices, triangles, origin, dx, nx, ny, nz)
    print(f"SDF shape: {sdf.shape}, dtype: {sdf.dtype}")
    print(f"Value range: [{sdf.min():.4f}, {sdf.max():.4f}]")
    print(f"Inside cells: {(sdf < 0).sum()} ({100.0 * (sdf < 0).mean():.1f}%)")


def example_2_high_level_api():
    """High-level one-call API with automatic grid sizing."""
    banner("Example 2: High-level API (generate_from_file)")

    sdf, meta = sg.generate_from_file(BOX_STL, nx=48, padding=2)
    print(f"SDF shape: {sdf.shape}")
    print(f"Grid spacing dx: {meta['dx']:.6f}")
    print(f"Origin: {meta['origin']}")
    print(f"Mesh bounds: {meta['bounds']}")
    print(f"Backend: {meta['backend']}")


def example_3_programmatic_mesh():
    """Build a mesh in NumPy (no file) and generate from the arrays."""
    banner("Example 3: Programmatic mesh (unit cube from arrays)")

    from sdfgenfast.mesh import box_mesh

    mesh = box_mesh((1.0, 1.0, 1.0), (0.0, 0.0, 0.0))
    sdf, meta = sg.generate_from_mesh(mesh.verts, mesh.tris, nx=24, padding=2)
    print(f"Cube mesh: {len(mesh.verts)} verts, {len(mesh.tris)} tris")
    print(f"SDF shape: {sdf.shape}")
    center = tuple(s // 2 for s in sdf.shape)
    print(f"SDF at grid center {center}: {sdf[center]:.4f} (negative = inside)")


def example_4_save_and_load():
    """Round-trip through the reference-compatible binary .sdf format."""
    banner("Example 4: Save and load .sdf files")

    sdf, meta = sg.generate_from_file(BOX_OBJ, nx=32)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "example.sdf")
        sg.save_sdf(path, sdf, meta["origin"], meta["dx"])
        print(f"Saved: {path} ({os.path.getsize(path)} bytes)")

        sdf2, origin2, dx2, bounds2 = sg.load_sdf(path)
        print(f"Loaded shape: {sdf2.shape}, dx: {dx2:.6f}")
        print(f"Round-trip exact: {np.array_equal(sdf.astype(np.float32), sdf2)}")


def example_5_backend_selection():
    """Backend dispatch: auto / cpu / gpu (the reference's vocabulary)."""
    banner("Example 5: Backend selection")

    print(f"GPU available: {sg.is_gpu_available()}")
    sdf_auto, _ = sg.generate_from_file(BOX_STL, nx=32, backend="auto")
    sdf_cpu, _ = sg.generate_from_file(BOX_STL, nx=32, backend="cpu")
    diff = np.abs(sdf_auto - sdf_cpu).max()
    print(f"auto vs cpu max |diff|: {diff:.2e}")
    try:
        sg.generate_from_file(BOX_STL, nx=32, backend="gpu")
        print("backend='gpu': OK")
    except RuntimeError as e:
        print(f"backend='gpu' raised (no GPU here): {e}")


def example_6_different_resolutions():
    """Resolution sweep — how cell count scales cost and fidelity."""
    banner("Example 6: Multi-resolution SDF generation")

    import time

    for nx in (16, 32, 64):
        t0 = time.perf_counter()
        sdf, meta = sg.generate_from_file(BOX_STL, nx=nx)
        t = time.perf_counter() - t0
        print(
            f"nx={nx:4d}: grid={sdf.shape}, cells={sdf.size:9d}, "
            f"dx={meta['dx']:.5f}, time={t:.2f}s (includes compile)"
        )


def example_7_differentiable_sdf():
    """The new capability: gradients of the SDF w.r.t. vertices."""
    banner("Example 7: Differentiable SDF (vertex gradients)")

    import jax
    import jax.numpy as jnp
    from sdfgenfast.grid import GridSpec
    from sdfgenfast.mesh import icosphere
    from sdfgenfast.pipeline import SDFConfig, bin_mesh, make_level_set3

    mesh = icosphere(1, radius=1.0)
    grid = GridSpec((-1.4, -1.4, -1.4), 2.8 / 23, (24, 24, 24))
    config = SDFConfig()
    binned = bin_mesh(mesh, grid, config)

    def mean_sdf(verts):
        phi = make_level_set3(mesh, grid, config, binned=binned, verts=verts)
        return jnp.mean(phi)

    verts = jnp.asarray(mesh.verts)
    value, grad = jax.value_and_grad(mean_sdf)(verts)
    print(f"mean SDF: {float(value):.5f}")
    print(f"vertex gradient shape: {grad.shape}, norm: {float(jnp.linalg.norm(grad)):.5f}")
    print("Growing the sphere should decrease the mean SDF everywhere outside:")
    directional = float(jnp.sum(grad * verts))  # d/dt mean_sdf((1+t) * verts)
    print(f"  d(mean SDF)/d(scale) = {directional:.5f} (expected < 0)")


def example_8_batch_generation():
    """Batch SDF generation: one shared grid, many meshes (e.g. a dataset of
    deformations) — compiled programs are reused across the batch and each
    mesh's host preprocessing overlaps the previous mesh's device compute."""
    banner("Example 8: Batch generation (shared grid)")

    import numpy as np
    import sdfgenfast as sdfgen
    from sdfgenfast.mesh import icosphere

    rng = np.random.default_rng(0)
    base = icosphere(2, radius=1.0)
    meshes = [
        (base.verts + rng.normal(scale=0.01, size=base.verts.shape
                                 ).astype(np.float32), base.tris)
        for _ in range(4)
    ]
    sdfs = sdfgen.generate_sdf_batch(
        meshes, origin=(-1.3, -1.3, -1.3), dx=2.6 / 32, nx=32, ny=32, nz=32)
    for i, sdf in enumerate(sdfs):
        print(f"  mesh {i}: inside fraction {float((sdf < 0).mean()):.3f}")


def example_9_sharded_multi_device():
    """Multi-device (sharded) generation: the voxel grid tiles over a
    (j, k) jax.sharding.Mesh and every shard runs the same kernels as a
    single-device run (band kernel + pyramid far field on a GPU). On one
    device this degenerates gracefully; on a CPU test host set
    XLA_FLAGS=--xla_force_host_platform_device_count=8 to see real
    sharding. Batches compose with the mesh via
    generate_sdf_batch(..., device_mesh=dmesh)."""
    banner("Example 9: Sharded multi-device generation")

    import numpy as np
    from sdfgenfast import GridSpec, SDFConfig
    from sdfgenfast.mesh import icosphere
    from sdfgenfast.parallel import (
        bin_mesh_sharded, make_device_mesh, sharded_sdf,
    )

    dmesh = make_device_mesh()
    print(f"  device mesh: {dmesh.devices.shape} ({dmesh.devices.size} devices)")
    m = icosphere(3, radius=1.0)
    g = GridSpec((-1.25, -1.25, -1.25), 2.5 / 64, (64, 64, 64))
    sb = bin_mesh_sharded(m, g, dmesh.devices.shape, SDFConfig())
    phi = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
    print(f"  sharded SDF {phi.shape}: inside fraction "
          f"{float((phi < 0).mean()):.3f}")


EXAMPLES = {
    1: example_1_load_and_generate,
    2: example_2_high_level_api,
    3: example_3_programmatic_mesh,
    4: example_4_save_and_load,
    5: example_5_backend_selection,
    6: example_6_different_resolutions,
    7: example_7_differentiable_sdf,
    8: example_8_batch_generation,
    9: example_9_sharded_multi_device,
}


def main():
    wanted = [int(a) for a in sys.argv[1:]] or sorted(EXAMPLES)
    for n in wanted:
        EXAMPLES[n]()
    print("\nAll requested examples completed.")


if __name__ == "__main__":
    main()
