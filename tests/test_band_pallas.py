"""Pallas band kernel vs the XLA tile path, and the plain chamfer.

Interpret mode on the forced-CPU backend validates the CSR layout, the
per-tile candidate loop, tie-breaks, and closest-point reconstruction. The
compiled kernel is checked on the GPU by tests/test_gpu.py (`pytest -m gpu`)
and chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from sdfgenfast.mesh import icosphere
from sdfgenfast.grid import sizing_mode2a_proportional
from sdfgenfast.pipeline import SDFConfig, bin_mesh
from sdfgenfast.ops import tiled as tiled_ops
from sdfgenfast.ops import band_pallas, vdt as vdt_ops


@pytest.fixture(scope="module")
def sphere_setup():
    mesh = icosphere(4, radius=1.0)  # 5120 triangles
    mn, mx = mesh.bounds()
    grid = sizing_mode2a_proportional(mn, mx, 64, 1)
    binned = bin_mesh(mesh, grid, SDFConfig())
    return mesh, grid, binned


def test_band_rows_match_xla(sphere_setup):
    mesh, grid, binned = sphere_setup
    bb = binned.band
    csr = binned.band_csr
    tv = jnp.asarray(mesh.verts)[jnp.asarray(binned.tris)]
    origin = jnp.asarray(grid.origin, jnp.float32)
    dxj = jnp.float32(grid.dx)
    ids = jnp.asarray(bb.active_ids)

    phi_r, tid_r, cpx_r, cpy_r, cpz_r = band_pallas.band_rows_pallas(
        tv - origin, jnp.asarray(csr["pair"]), ids,
        jnp.asarray(csr["off"]), jnp.asarray(csr["cnt"]), dxj,
        tiles_dim=bb.tiles_dim, grid_shape=grid.shape, interpret=True,
    )
    phi_x, tid_x = tiled_ops.tile_candidate_rows(
        tv, ids, jnp.asarray(bb.cand), jnp.asarray(bb.cand_valid),
        origin, dxj, tile_shape=bb.tile_shape, tiles_dim=bb.tiles_dim,
        grid_shape=grid.shape,
    )
    A = bb.num_active
    rows = np.asarray(bb.active_ids[:A])
    phi_p = np.asarray(phi_r)[rows]
    tid_p = np.asarray(tid_r)[rows]
    # every active tile's row written (interpret mode leaves NaN otherwise)
    for r in (phi_r, cpx_r, cpy_r, cpz_r):
        assert np.isfinite(np.asarray(r)[rows]).all()
    phi_x = np.asarray(phi_x)[:A]
    tid_x = np.asarray(tid_x)[:A]

    # distances: ulp-level agreement (different but equivalent op orders)
    np.testing.assert_allclose(phi_p, phi_x, rtol=3e-6, atol=1e-6)
    # ids: equal except ulp-level distance ties
    mism = tid_p != tid_x
    assert mism.mean() < 0.02, f"{mism.sum()} tid mismatches"
    if mism.any():
        np.testing.assert_allclose(phi_p[mism], phi_x[mism], rtol=3e-6, atol=1e-6)

    # closest points reproduce the distances: |p - cp| == phi where found
    ni, nj, nk = grid.shape
    T = int(np.prod(bb.tiles_dim))
    phi0 = tiled_ops.untile_rows(
        jnp.asarray(phi_r)[:T], bb.tile_shape, bb.tiles_dim, grid.shape)
    tid0 = tiled_ops.untile_rows(
        jnp.asarray(tid_r)[:T], bb.tile_shape, bb.tiles_dim, grid.shape)
    cpx = tiled_ops.untile_rows(
        jnp.asarray(cpx_r)[:T], bb.tile_shape, bb.tiles_dim, grid.shape)
    cpy = tiled_ops.untile_rows(
        jnp.asarray(cpy_r)[:T], bb.tile_shape, bb.tiles_dim, grid.shape)
    cpz = tiled_ops.untile_rows(
        jnp.asarray(cpz_r)[:T], bb.tile_shape, bb.tiles_dim, grid.shape)
    act = np.zeros(T + 1, bool)
    act[np.asarray(bb.active_ids[:A])] = True
    mask3 = tiled_ops.untile_rows(
        jnp.broadcast_to(jnp.asarray(act[:T, None]), (T, 512)),
        bb.tile_shape, bb.tiles_dim, grid.shape)
    found = np.asarray(mask3) & (np.asarray(tid0) >= 0)
    px, py, pz = vdt_ops._level_pos_axes(grid.shape, dxj, 1)
    d = np.sqrt(np.asarray(vdt_ops._dist2(px, py, pz, cpx, cpy, cpz)))
    np.testing.assert_allclose(
        d[found], np.asarray(phi0)[found], rtol=3e-5, atol=1e-6)


def test_band_tid_ids_valid(sphere_setup):
    mesh, grid, binned = sphere_setup
    bb = binned.band
    csr = binned.band_csr
    tv = jnp.asarray(mesh.verts)[jnp.asarray(binned.tris)]
    origin = jnp.asarray(grid.origin, jnp.float32)
    _, tid_r, *_ = band_pallas.band_rows_pallas(
        tv - origin, jnp.asarray(csr["pair"]), jnp.asarray(bb.active_ids),
        jnp.asarray(csr["off"]), jnp.asarray(csr["cnt"]),
        jnp.float32(grid.dx),
        tiles_dim=bb.tiles_dim, grid_shape=grid.shape, interpret=True,
    )
    A = bb.num_active
    tids = np.asarray(tid_r)[np.asarray(bb.active_ids[:A])]
    assert tids.min() >= -1 and tids.max() < mesh.num_tris


def test_csr_builder_prefix_dense():
    rng = np.random.default_rng(0)
    A, K = 37, 21
    counts = rng.integers(1, K + 1, A)
    cand = np.zeros((A, K), np.int32)
    valid = np.zeros((A, K), bool)
    for i, c in enumerate(counts):
        cand[i, :c] = rng.integers(0, 999, c)
        valid[i, :c] = True
    pair, off, cnt = band_pallas.band_csr_from_binning(cand, valid, 999)
    np.testing.assert_array_equal(cnt, counts)
    for i in range(A):
        seg = pair[off[i]:off[i] + cnt[i]]
        np.testing.assert_array_equal(seg[:counts[i]], cand[i, :counts[i]])
        assert (seg[counts[i]:] == 999).all()


def _chamfer_np(phi, dx, passes):
    """Brute-force 26-offset min-plus passes in NumPy float32."""
    phi = np.asarray(phi, np.float32)
    for _ in range(passes):
        ext = np.pad(phi, 1, constant_values=np.float32(3e38))
        out = phi.copy()
        for o in vdt_ops._OFFSETS26:
            step = np.float32(np.sqrt(float((o ** 2).sum()))) * np.float32(dx)
            nb = ext[tuple(slice(1 + int(a), 1 + int(a) + n)
                           for a, n in zip(o, phi.shape))]
            out = np.minimum(out, nb + step)
        phi = out
    return phi


@pytest.mark.parametrize("shape", [(64, 64, 128), (48, 41, 75)])
def test_chamfer_matches_bruteforce(shape):
    # the chamfer has no kernel (a fused static-shift XLA form measured
    # faster on the GPU); the plain form must equal brute-force passes
    rng = np.random.default_rng(1)
    phi = np.abs(rng.normal(size=shape)).astype(np.float32)
    dx = np.float32(0.02)
    a = vdt_ops.chamfer_relax(jnp.asarray(phi), dx, passes=2)
    np.testing.assert_allclose(np.asarray(a), _chamfer_np(phi, dx, 2),
                               rtol=2e-7)
