#!/usr/bin/env python
"""Hand-written kernels vs XLA's plain forms, on the card, at benchmark shapes.

For every kernel of the GPU route (ops/dense.py, ops/band_pallas.py,
ops/vdt_pallas.py) and every plain contender, prints the device time per
call (back-to-back calls, one block at the end, median of 5 windows) and
how far the two results are apart; then the whole single-program pipeline
with every kernel on vs every kernel off. Needs a GPU.

Usage: python tools/kernel_bench.py [dense] [band] [round] [e2e]
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdfgenfast.aot import setup_compile_cache  # noqa: E402
from sdfgenfast.grid import sizing_mode2a_proportional  # noqa: E402
from sdfgenfast.mesh import box36_mesh, icosphere, torus_mesh  # noqa: E402
from sdfgenfast.ops import vdt as vdt_ops  # noqa: E402
from sdfgenfast.ops.dense import dense_distance_field  # noqa: E402
from sdfgenfast.ops.vdt_pallas import pallas_round_phase  # noqa: E402
from sdfgenfast.pipeline import (  # noqa: E402
    SDFConfig, _dense_sign_core, _exact_core, band_seeds, bin_mesh,
)
from sdfgenfast.platform import KERNEL, XLA  # noqa: E402


def device_ms(fn, *args, calls=10, windows=5):
    """Median over `windows` of the mean wall time of `calls` back-to-back
    calls (one block per window) — the device time once dispatch overlaps."""
    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / calls * 1e3)
    return float(np.median(per))


def report(name, ms_kernel, ms_plain, plain_name="xla", kernel_name="kernel"):
    print(f"  {name:28s} {kernel_name} {ms_kernel:9.3f} ms   {plain_name} "
          f"{ms_plain:9.3f} ms   {plain_name}/{kernel_name} "
          f"{ms_plain / ms_kernel:6.2f}x", flush=True)


def parity(binned):
    """The host parity in whichever transport the binning chose."""
    p = binned.parity_crossings
    return jnp.asarray(binned.parity_packed if p is None else p)


def grid_for(mesh, nx):
    mn, mx = mesh.bounds()
    return sizing_mode2a_proportional(mn, mx, nx, 1)


def bench_dense():
    mesh = box36_mesh()
    grid = grid_for(mesh, 256)
    tv = jnp.asarray(mesh.verts)[jnp.asarray(mesh.tris.astype(np.int32))]
    o = jnp.asarray(grid.origin, jnp.float32)
    dx = jnp.float32(grid.dx)
    print(f"dense box36@256 grid={grid.shape} tris={mesh.num_tris}")
    f = {r: jax.jit(lambda t, o, d, r=r: dense_distance_field(
        t, o, d, grid_shape=grid.shape, route=r)) for r in (KERNEL, XLA)}
    a, b = (np.asarray(f[r](tv, o, dx)[0]) for r in (KERNEL, XLA))
    print(f"  max |kernel - xla| = {np.abs(a - b).max():.3e}")
    report("dense stage", device_ms(f[KERNEL], tv, o, dx),
           device_ms(f[XLA], tv, o, dx))
    par = parity(bin_mesh(mesh, grid, SDFConfig()))
    v = jnp.asarray(mesh.verts)
    t = jnp.asarray(mesh.tris.astype(np.int32))
    e2e = {r: jax.jit(lambda v, t, p, o, d, r=r: _dense_sign_core(
        v, t, p, o, d, grid_shape=grid.shape, route=r)) for r in (KERNEL, XLA)}
    report("dense + sign program", device_ms(e2e[KERNEL], v, t, par, o, dx),
           device_ms(e2e[XLA], v, t, par, o, dx))


def _band_args(mesh, grid):
    binned = bin_mesh(mesh, grid, SDFConfig())
    bb, csr = binned.band, binned.band_csr
    tv = jnp.asarray(mesh.verts)[jnp.asarray(binned.tris)]
    args = (tv, jnp.asarray(grid.origin, jnp.float32), jnp.float32(grid.dx),
            jnp.asarray(csr["ids"]), jnp.asarray(bb.cand),
            jnp.asarray(bb.cand_valid), jnp.asarray(csr["pair"]),
            jnp.asarray(csr["off"]), jnp.asarray(csr["cnt"]))
    statics = dict(grid_shape=grid.shape, tile_shape=bb.tile_shape,
                   tiles_dim=bb.tiles_dim)
    return binned, args, statics


def bench_band():
    for name, mesh, nx in (("sphere82k@256", icosphere(6), 256),
                           ("torus100k@512", torus_mesh(), 512)):
        grid = grid_for(mesh, nx)
        binned, args, st = _band_args(mesh, grid)
        print(f"band {name} grid={grid.shape} active={binned.band.num_active}"
              f" K={binned.band.cand.shape[1]} P={binned.band_csr['pair'].size}")
        f = {k: jax.jit(lambda *a, k=k: band_seeds(*a, kernel=k, **st))
             for k in (True, False)}
        ka, xa = (jax.device_get(f[k](*args)) for k in (True, False))
        print(f"  max |phi diff| = {np.abs(ka[0] - xa[0]).max():.3e}, "
              f"tid mismatches = {(ka[1] != xa[1]).mean():.2e}")
        report("band seeds", device_ms(f[True], *args, calls=3),
               device_ms(f[False], *args, calls=3))


def _round_state(nx):
    mesh = icosphere(6)
    grid = grid_for(mesh, nx)
    _, args, st = _band_args(mesh, grid)
    phi0, tid0, cpx, cpy, cpz = jax.jit(
        lambda *a: band_seeds(*a, kernel=True, **st))(*args)
    px, py, pz = vdt_ops._level_pos_axes(grid.shape, args[2], 1)
    d2 = vdt_ops._dist2(px, py, pz, cpx, cpy, cpz)
    return vdt_ops.pack_state(cpx, cpy, cpz, tid0, d2), args[2], phi0


def bench_round():
    state, dx, _ = _round_state(512)
    print(f"round sphere82k@512 state={state.shape}")
    pos = vdt_ops._level_pos_axes(state.shape[1:], dx, 1)
    offs = jnp.asarray(vdt_ops._OFFSETS26)
    for s in (1, 2, 8):
        kern = jax.jit(lambda st, s=s: pallas_round_phase(st, dx, (s,)))
        fori = jax.jit(lambda st, s=s: vdt_ops._jacobi_round(
            st, *pos, s, offs))
        a, b = (np.asarray(f(state)) for f in (kern, fori))
        diff = (a[:4].view(np.int32) != b[:4].view(np.int32)).any(0)
        print(f"  stride {s}: payload mismatches {diff.mean():.2e}; max rel"
              f" d2 {np.max(np.abs(a[4] - b[4]) / np.maximum(b[4], 1e-30)):.2e}")
        report(f"round stride {s}", device_ms(kern, state, calls=3),
               device_ms(fori, state, calls=3), "fori")


def bench_e2e():
    for name, mesh, nx in (("sphere82k@256", icosphere(6), 256),
                           ("torus100k@512", torus_mesh(), 512)):
        grid = grid_for(mesh, nx)
        binned, args, st = _band_args(mesh, grid)
        tv, o, dx, ids, cand, valid, pair, off, cnt = args
        par = parity(binned)
        v = jnp.asarray(mesh.verts)
        t = jnp.asarray(binned.tris)
        for label, kernels in (("all kernels", True), ("all xla", False)):
            f = jax.jit(lambda *a, kernels=kernels: _exact_core(
                *a, strides=(), chamfer_passes=2, band_chunk=128,
                seed_band=3, jacobi=False, apply_sign=True, pyramid=True,
                kernels=kernels, **st))
            a = (v, t, ids, cand, valid, par, o, dx, pair, off, cnt)
            ms = device_ms(f, *a, calls=2, windows=3)
            print(f"  e2e {name:14s} {label:12s} {ms:9.3f} ms", flush=True)


def main():
    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("kernel_bench needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {dev.device_kind}; nvidia-smi: {smi.stdout.strip()}")
    sections = dict(dense=bench_dense, band=bench_band, round=bench_round,
                    e2e=bench_e2e)
    failed = []
    for name in sys.argv[1:] or list(sections):
        try:
            sections[name]()
        except Exception as e:  # report every section, then fail
            print(f"{name}: FAILED {type(e).__name__}: {e}", flush=True)
            failed.append(name)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
