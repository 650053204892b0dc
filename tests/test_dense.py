"""Dense all-triangles distance field: oracle parity, path equivalence, grads.

Small meshes (<= SDFConfig.dense_max_tris) take the fused dense path
through make_level_set3; these tests pin that path against the float64
brute-force oracle AND against the tiled band+JFA path (dense_max_tris=0
forces the latter), so both implementations keep end-to-end coverage. The
kernel tests run both routes of `dense_distance_field`: the plain XLA form
and the Triton kernel in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfgenfast import GridSpec, SDFConfig, box_mesh, make_level_set3
from sdfgenfast.mesh import icosphere
from sdfgenfast.ops import dense as dense_mod
from sdfgenfast.ops.dense import DENSE_MAX_TRIS, dense_distance_field
from sdfgenfast.pipeline import bin_mesh, use_dense
from sdfgenfast.platform import XLA
from oracle import brute_force_sdf, point_triangle_distance_np

SURF_EPS = 1e-5

# the two implementations: plain XLA, and the kernel interpreted on the CPU
IMPLS = {"xla": dict(route=XLA), "kernel": dict(interpret=True)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _field(tv, origin, dx, gs, impl):
    phi, tid = dense_distance_field(
        tv, jnp.asarray(origin, jnp.float32), jnp.float32(dx), grid_shape=gs,
        **impl)
    phi, tid = np.asarray(phi), np.asarray(tid)
    # every cell written (interpret mode leaves unwritten outputs NaN)
    assert np.isfinite(phi).all()
    return phi, tid


class TestDenseKernel:
    @pytest.mark.parametrize("subdiv, ntris, gs, origin, dx", [
        # icosphere(1): 80 triangles
        (1, None, (14, 17, 19), (-1.31, -1.24, -1.18), 0.17),
        # 512 triangles of icosphere(3): a mid-size table
        (3, 512, (9, 10, 11), (-1.2, -1.15, -1.1), 0.24),
    ])
    def test_matches_oracle_unsigned(self, impl, subdiv, ntris, gs, origin,
                                     dx):
        m = icosphere(subdiv, radius=1.0, center=(0.05, -0.03, 0.08))
        tris = m.tris[:ntris]
        tv = jnp.asarray(m.verts)[jnp.asarray(tris.astype(np.int32))]
        phi, tid = _field(tv, origin, dx, gs, impl)
        ref = np.abs(brute_force_sdf(m.verts, tris, origin, dx, gs))
        np.testing.assert_allclose(phi, ref, rtol=2e-5, atol=2e-6)
        # every argmin id actually achieves the min distance
        assert (tid >= 0).all() and (tid < len(tris)).all()

    def test_matches_oracle_off_origin(self, impl):
        # coefficients are built in grid-local coordinates, so a mesh (and
        # grid) modeled ~1e3 from the world origin keeps difference-form
        # accuracy instead of cancelling O(|p|*eps) terms
        off = 1000.0
        m = icosphere(1, radius=1.0, center=(off + 0.05, off - 0.03, off + 0.08))
        tv = jnp.asarray(m.verts)[jnp.asarray(m.tris.astype(np.int32))]
        gs = (14, 17, 19)
        origin = (off - 1.31, off - 1.24, off - 1.18)
        dx = 0.17
        phi, _ = _field(tv, origin, dx, gs, impl)
        ref = np.abs(brute_force_sdf(m.verts, m.tris, origin, dx, gs))
        np.testing.assert_allclose(phi, ref, rtol=2e-4, atol=2e-4)

    def test_degenerate_triangle_gets_point_distance(self, impl):
        # zero-area triangle: the separable evaluation must fall through to
        # the edge/point distance (makelevelset3.cpp:49-70), not the
        # undefined inside-plane branch
        pt = np.array([0.5, 0.5, 0.5], np.float32)
        tv = jnp.asarray(np.broadcast_to(pt, (1, 3, 3)).copy())
        gs = (10, 10, 10)
        phi, _ = _field(tv, (0, 0, 0), 0.1, gs, impl)
        idx = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"), -1)
        ref = np.linalg.norm(idx * 0.1 - pt, axis=-1)
        np.testing.assert_allclose(phi, ref, rtol=1e-5, atol=1e-6)

    def test_segment_triangle_gets_segment_distance(self, impl):
        # two coincident vertices -> segment; edge path must handle it
        tv = jnp.asarray(
            [[[0.2, 0.5, 0.5], [0.8, 0.5, 0.5], [0.8, 0.5, 0.5]]], jnp.float32
        )
        phi, _ = _field(tv, (0, 0, 0), 0.1, (10, 10, 10), impl)
        # cell (5,5,5) = (0.5,0.5,0.5) lies on the segment; (5,5,8) is 0.3 off
        assert abs(float(phi[5, 5, 5])) < 1e-6
        np.testing.assert_allclose(float(phi[5, 5, 8]), 0.3, rtol=1e-5)

    def test_kernel_equals_xla_with_offset(self):
        # sharded blocks pass a global ijk offset; ragged rows and k both
        # end inside a block (masked stores)
        m = icosphere(2, radius=1.0, center=(0.02, -0.01, 0.03))
        tv = jnp.asarray(m.verts)[jnp.asarray(m.tris.astype(np.int32))]
        gs = (5, 7, 37)
        o = jnp.asarray((-1.2, -1.15, -1.1), jnp.float32)
        off = jnp.asarray([3, 6, 2], jnp.int32)
        a = dense_distance_field(tv, o, jnp.float32(0.07), grid_shape=gs,
                                 ijk_offset=off, interpret=True)
        b = dense_distance_field(tv, o, jnp.float32(0.07), grid_shape=gs,
                                 ijk_offset=off, route=XLA)
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                                   rtol=1e-6, atol=1e-6)
        # winner ids differ only at ulp-level ties between two triangles
        ta, tb = np.asarray(a[1]), np.asarray(b[1])
        mism = np.argwhere(ta != tb)
        assert len(mism) < 0.05 * ta.size
        p = ((mism + np.asarray(off)) * np.float32(0.07)
             + np.asarray(o, np.float64))
        tri = m.verts.astype(np.float64)[m.tris.astype(np.int64)]
        da = point_triangle_distance_np(p, *tri[ta[tuple(mism.T)]].transpose(1, 0, 2))
        db = point_triangle_distance_np(p, *tri[tb[tuple(mism.T)]].transpose(1, 0, 2))
        np.testing.assert_allclose(da, db, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("nk, block", [
        (429, (64, 16)), (256, (8, 128)), (75, (64, 16)), (40, (64, 16)),
        (8, (64, 16)),
    ])
    def test_block_shape_pads_k_least(self, nk, block):
        assert dense_mod.block_shape(nk) == block
        br, bk = block
        assert br * bk == dense_mod._BLOCK_CELLS

    def test_default_route_on_cpu_is_xla(self, monkeypatch):
        # the pipeline never picks interpret mode: on the CPU the resolver
        # gives the plain XLA form, and the kernel is not traced at all
        def boom(*a, **k):
            raise AssertionError("kernel traced on the CPU route")

        monkeypatch.setattr(dense_mod, "_dense_pallas", boom)
        tv = jnp.asarray(box_mesh().verts)[jnp.asarray(
            box_mesh().tris.astype(np.int32))]
        phi, _ = dense_distance_field(tv, jnp.zeros(3, jnp.float32),
                                      jnp.float32(0.3), grid_shape=(4, 5, 6))
        assert np.isfinite(np.asarray(phi)).all()

    def test_cap_enforced(self):
        cfg = SDFConfig()
        assert use_dense(cfg, 36)
        assert use_dense(cfg, DENSE_MAX_TRIS)
        assert not use_dense(cfg, DENSE_MAX_TRIS + 1)
        assert not use_dense(SDFConfig(dense_max_tris=0), 36)
        assert not use_dense(SDFConfig(far_field="eikonal"), 36)


class TestDensePipelinePath:
    def test_dense_equals_tiled_path(self):
        m = icosphere(2, radius=1.0, center=(0.1, -0.05, 0.07))
        g = GridSpec((-1.5, -1.5, -1.5), 0.14, (22, 23, 24))
        dense = np.asarray(make_level_set3(m, g, SDFConfig()))
        tiled = np.asarray(make_level_set3(m, g, SDFConfig(dense_max_tris=0)))
        # identical signs; magnitudes agree to f32 roundoff in the band and
        # the tiled path's small fixed-point slack in the far field
        assert ((dense < 0) == (tiled < 0)).all()
        np.testing.assert_allclose(dense, tiled, atol=0.05 * g.dx)

    def test_dense_skips_band_binning(self):
        m = box_mesh((2, 2, 2))
        g = GridSpec((-0.5, -0.5, -0.5), 0.25, (12, 12, 12))
        binned = bin_mesh(m, g, SDFConfig())
        assert binned.band is None  # 12 tris -> dense path, no band binning
        binned_tiled = bin_mesh(m, g, SDFConfig(dense_max_tris=0))
        assert binned_tiled.band is not None

    def test_dense_far_field_is_exact(self):
        # the dense kernel gives the true min distance EVERYWHERE — strictly
        # stronger than the propagated far field's fixed-point guarantee
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.5, (14, 16, 18))
        phi = np.asarray(make_level_set3(m, g, SDFConfig()))
        ref = brute_force_sdf(m.verts, m.tris, g.origin, g.dx, g.shape)
        np.testing.assert_allclose(
            np.abs(phi), np.abs(ref), rtol=5e-5, atol=2e-6
        )


class TestDenseGradients:
    def test_grad_matches_finite_differences(self):
        m = icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
        g = GridSpec((-1.3, -1.3, -1.3), 2.6 / 16, (16, 16, 16))
        cfg = SDFConfig()
        binned = bin_mesh(m, g, cfg)
        assert binned.band is None  # proves the dense path is the one tested

        # random-weighted sum: avoids the mass cancellation a plain sum-of-
        # squares hits (f32 accumulation noise would swamp the FD signal)
        w = jnp.asarray(np.random.default_rng(1).standard_normal(g.shape), jnp.float32)

        def loss(v):
            phi = make_level_set3(m, g, cfg, binned=binned, verts=v)
            return jnp.sum(phi * w)

        grad = np.asarray(jax.grad(loss)(jnp.asarray(m.verts)))
        assert np.isfinite(grad).all()
        eps = 1e-3
        for i, ax in [(0, 0), (5, 1), (17, 2)]:
            vp = m.verts.copy()
            vp[i, ax] += eps
            vm = m.verts.copy()
            vm[i, ax] -= eps
            fd = (float(loss(jnp.asarray(vp))) - float(loss(jnp.asarray(vm)))) / (
                2 * eps
            )
            assert abs(fd - grad[i, ax]) < 2e-2 * max(1.0, abs(fd)), (
                f"vert {i} axis {ax}: fd={fd} ad={grad[i, ax]}"
            )
