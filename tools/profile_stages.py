#!/usr/bin/env python
"""Per-stage wall-clock breakdown of the single-device pipeline.

The production path runs as ONE jitted program (pipeline._exact_core /
_dense_sign_core); here the stages are timed separately, each through the
route `platform.kernel_route()` picks for the default device (Pallas
kernels on a GPU, plain XLA on the CPU), to attribute device time. Times are
the min of 3 warm calls ending in block_until_ready.

Usage: python tools/profile_stages.py [Nx ...] [box|sphere|torus] [tiled]
(default 256 box). Set PROFILE_TRACE=<dir> to also capture a jax.profiler
trace of the steady-state end-to-end run.
"""

import os
import subprocess
import sys
import time
from functools import partial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdfgenfast.aot import setup_compile_cache  # noqa: E402
from sdfgenfast.grid import sizing_mode2a_proportional  # noqa: E402
from sdfgenfast.mesh import box36_mesh, icosphere, torus_mesh  # noqa: E402
from sdfgenfast.ops import vdt as vdt_ops  # noqa: E402
from sdfgenfast.ops.dense import dense_distance_field  # noqa: E402
from sdfgenfast.pipeline import (  # noqa: E402
    SDFConfig, _sign_apply_stage, _unpack_parity_stage, band_seeds, bin_mesh,
    make_level_set3, use_dense,
)
from sdfgenfast.platform import KERNEL, kernel_route  # noqa: E402


def timed(name, fn, *args, repeats=3, **kw):
    out = jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    print(f"  {name:28s} {min(ts)*1e3:9.2f} ms", flush=True)
    return out


def parity_of(binned, ni):
    pdata = (binned.parity_packed if binned.parity_packed is not None
             else binned.parity_crossings)
    return timed("parity reconstruct", _unpack_parity_stage,
                 jnp.asarray(pdata), ni)


def profile_dense(mesh, grid, binned, route):
    tri_verts = jnp.asarray(mesh.verts)[jnp.asarray(binned.tris)]
    origin = jnp.asarray(grid.origin, jnp.float32)
    parity = parity_of(binned, grid.shape[0])
    phi, _ = timed(f"dense ({route})", dense_distance_field, tri_verts,
                   origin, jnp.float32(grid.dx), grid_shape=grid.shape,
                   route=route)
    timed("sign apply", _sign_apply_stage, phi, parity)


def profile_binned(mesh, grid, binned, cfg, route):
    bb, csr = binned.band, binned.band_csr
    kernel = route == KERNEL
    dx = jnp.float32(grid.dx)
    args = (jnp.asarray(mesh.verts)[jnp.asarray(binned.tris)],
            jnp.asarray(grid.origin, jnp.float32), dx,
            jnp.asarray(csr["ids"]), jnp.asarray(bb.cand),
            jnp.asarray(bb.cand_valid), jnp.asarray(csr["pair"]),
            jnp.asarray(csr["off"]), jnp.asarray(csr["cnt"]))
    seeds = jax.jit(partial(band_seeds, kernel=kernel, grid_shape=grid.shape,
                            tile_shape=bb.tile_shape, tiles_dim=bb.tiles_dim))
    phi0, tid0, cpx, cpy, cpz = timed(f"band seeds ({route})", seeds, *args)
    freeze = (tid0 >= 0) & (phi0 <= 3.0 * dx)
    pyr = jax.jit(partial(vdt_ops.vdt_pyramid_far_field, use_pallas=kernel))
    phi, _ = timed(f"pyramid VDT ({route})", pyr, cpx, cpy, cpz, tid0, phi0,
                   dx, freeze)
    cham = jax.jit(partial(vdt_ops.chamfer_relax, passes=cfg.chamfer_passes))
    phi = timed("chamfer", cham, phi, dx)
    parity = parity_of(binned, grid.shape[0])
    timed("sign apply", _sign_apply_stage, phi, parity)


def run_e2e(mesh, grid, cfg, binned):
    trace_dir = os.environ.get("PROFILE_TRACE", "")
    timed("END-TO-END (warm, binned)", make_level_set3, mesh, grid, cfg,
          binned=binned)
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(make_level_set3(mesh, grid, cfg,
                                                  binned=binned))
        print(f"  trace written to {trace_dir}")


def profile(nx, mesh_name="box", force_tiled=False):
    mesh = {"box": box36_mesh, "torus": torus_mesh,
            "sphere": lambda: icosphere(6)}[mesh_name]()
    mn, mx = mesh.bounds()
    grid = sizing_mode2a_proportional(mn, mx, nx, 1)
    cfg = SDFConfig(dense_max_tris=0) if force_tiled else SDFConfig()
    route = kernel_route()
    print(f"== Nx={nx} ({mesh_name}, {mesh.num_tris} tris): grid={grid.shape},"
          f" cells={grid.num_cells/1e6:.2f}M, route={route} ==", flush=True)
    t_bin = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        binned = bin_mesh(mesh, grid, cfg)
        t_bin = min(t_bin, time.perf_counter() - t0)
    print(f"  {'bin_mesh (host, min of 3)':28s} {t_bin*1e3:9.2f} ms",
          flush=True)
    if use_dense(cfg, mesh.num_tris):
        profile_dense(mesh, grid, binned, route)
    else:
        profile_binned(mesh, grid, binned, cfg, route)
    run_e2e(mesh, grid, cfg, binned)


if __name__ == "__main__":
    setup_compile_cache()
    dev = jax.devices()[0]
    smi = ""
    if dev.platform == "gpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    print(f"device: {dev.platform} {dev.device_kind} {smi}")
    sizes = [int(a) for a in sys.argv[1:] if a.isdigit()] or [256]
    mesh_name = ("torus" if "torus" in sys.argv
                 else "sphere" if "sphere" in sys.argv else "box")
    for nx in sizes:
        profile(nx, mesh_name, force_tiled="tiled" in sys.argv)
