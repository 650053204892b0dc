"""tile_candidate_field (batched affine-form evaluator) vs the v1 band evaluator and
the float64 oracle: same binning in, near-identical distances out."""

import jax.numpy as jnp
import numpy as np

from sdfgenfast import GridSpec
from sdfgenfast.mesh import box_mesh, icosphere
from sdfgenfast.ops import band as band_ops
from sdfgenfast.ops import tiled as tiled_ops
from oracle import brute_force_sdf


def _binned_case(mesh, grid, tile_shape=(8, 8, 8)):
    bb = band_ops.bin_triangles(mesh.verts, mesh.tris, grid, 1, tile_shape)
    tv = jnp.asarray(mesh.verts)[jnp.asarray(mesh.tris.astype(np.int32))]
    origin = jnp.asarray(grid.origin, jnp.float32)
    dx = jnp.float32(grid.dx)
    args = (
        tv,
        jnp.asarray(bb.active_ids),
        jnp.asarray(bb.cand),
        jnp.asarray(bb.cand_valid),
        origin,
        dx,
    )
    kw = dict(
        tile_shape=bb.tile_shape,
        tiles_dim=bb.tiles_dim,
        grid_shape=grid.shape,
    )
    return args, kw


class TestTileCandidateField:
    def test_matches_v1_band_evaluator(self):
        m = icosphere(2, radius=1.0, center=(0.07, -0.04, 0.06))
        g = GridSpec((-1.4, -1.35, -1.3), 0.11, (26, 25, 24))
        args, kw = _binned_case(m, g)
        phi1, tid1 = band_ops.band_distance_field(*args, chunk=16, **kw)
        phi2, tid2 = tiled_ops.tile_candidate_field(*args, chunk=16, **kw)
        # same candidates, same math to f32 ulps (relative error only spikes
        # for on-surface cells where the distance itself is ~0)
        np.testing.assert_allclose(
            np.asarray(phi1), np.asarray(phi2), rtol=2e-5, atol=1e-6
        )
        t1, t2 = np.asarray(tid1), np.asarray(tid2)
        agree = (t1 == t2) | (t1 < 0)
        assert agree.mean() > 0.9, f"tid agreement {agree.mean()}"
        # ids may differ only at (ulp-level) distance ties: re-evaluating the
        # disagreeing cells' distances through either id must agree closely
        dis = ~agree
        if dis.any():
            np.testing.assert_allclose(
                np.asarray(phi1)[dis], np.asarray(phi2)[dis], rtol=1e-4, atol=1e-5
            )

    def test_band_cells_match_oracle(self):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.31, (18, 20, 24))
        args, kw = _binned_case(m, g)
        phi, tid = tiled_ops.tile_candidate_field(*args, chunk=8, **kw)
        ref = np.abs(brute_force_sdf(m.verts, m.tris, g.origin, g.dx, g.shape))
        got = np.asarray(phi)
        # exactness holds inside the true narrow band; active-tile cells
        # further out legitimately hold upper bounds the far field improves
        band = (np.asarray(tid) >= 0) & (ref <= g.dx)
        assert band.any()
        np.testing.assert_allclose(got[band], ref[band], rtol=3e-5, atol=3e-6)

    def test_empty_candidates(self):
        m = box_mesh((1, 1, 1))
        g = GridSpec((0, 0, 0), 0.5, (8, 8, 8))
        tv = jnp.asarray(m.verts)[jnp.asarray(m.tris.astype(np.int32))]
        phi, tid = tiled_ops.tile_candidate_field(
            tv,
            jnp.zeros((0,), jnp.int32),
            jnp.zeros((0, 4), jnp.int32),
            jnp.zeros((0, 4), bool),
            jnp.zeros((3,), jnp.float32),
            jnp.float32(0.5),
            tile_shape=(8, 8, 8),
            tiles_dim=(1, 1, 1),
            grid_shape=(8, 8, 8),
        )
        assert (np.asarray(tid) == -1).all()
        np.testing.assert_allclose(np.asarray(phi), 24 * 0.5)

    def test_invalid_slots_and_degenerate(self):
        # one real degenerate triangle + invalid padding slots: the cell on
        # the collapsed point must get the exact point distance, and invalid
        # slots must never win
        pt = np.array([0.45, 0.55, 0.5], np.float32)
        verts = np.broadcast_to(pt, (3, 3)).copy()
        tris = np.array([[0, 1, 2]], np.int32)
        tv = jnp.asarray(verts)[jnp.asarray(tris)]
        cand = jnp.asarray([[0, 0, 0, 0]], jnp.int32)
        valid = jnp.asarray([[True, False, False, False]])
        phi, tid = tiled_ops.tile_candidate_field(
            tv,
            jnp.zeros((1,), jnp.int32),
            cand,
            valid,
            jnp.zeros((3,), jnp.float32),
            jnp.float32(0.1),
            tile_shape=(8, 8, 8),
            tiles_dim=(1, 1, 1),
            grid_shape=(8, 8, 8),
        )
        got = np.asarray(phi)
        idx = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
        ref = np.linalg.norm(idx * 0.1 - pt, axis=-1)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        assert (np.asarray(tid) == 0).all()
