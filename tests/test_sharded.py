"""Multi-device tests on the 8-device virtual CPU mesh: the sharded pipeline
must reproduce the single-device result bit-for-bit, and gradients must flow
through shard_map (with the automatic cross-shard psum)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdfgenfast import GridSpec, SDFConfig, make_level_set3
from sdfgenfast.mesh import box_mesh, icosphere
from sdfgenfast.parallel import bin_mesh_sharded, make_device_mesh, sharded_sdf
from sdfgenfast.pipeline import bin_mesh


def _assert_equivalent(a, b):
    # Band cells are frozen to the exact evaluator distances (bit-equal in
    # both settings). In the far field, cells whose nearest triangles TIE in
    # f32 distance (icosphere symmetry points) may adopt different winners
    # across chunkings, and the closest-point reconstructions of tied
    # triangles differ at ~1e-5 — everything else matches to f32 ulps.
    np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-6)
    # parity is host-computed and replicated, so the SIGN of every cell must
    # match the single-device result exactly
    np.testing.assert_array_equal(a < 0, b < 0)


def _mesh_or_skip(shape=None):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    return make_device_mesh(shape=shape)


class TestShardedParity:
    # dense_max_tris=default exercises the per-shard dense Pallas kernel;
    # =0 forces the band+VDT tiled path — both must match single-device
    @pytest.mark.parametrize("dense_cap", [1024, 0])
    def test_sphere_matches_single_device_exactly(self, dense_cap):
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 0.0875, (32, 32, 32))
        cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=dense_cap,
                        vdt_max_hop=4)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_box_on_grid_lines_matches(self):
        # SOS ties + shard boundaries together
        dmesh = _mesh_or_skip()
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.25, (28, 32, 32))
        cfg = SDFConfig(tile_shape=(4, 4, 4), tile2d_shape=(8, 8),
                        vdt_max_hop=4)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_1d_mesh_shapes(self):
        dmesh = _mesh_or_skip(shape=(1, 8))
        m = icosphere(1, radius=1.0)
        g = GridSpec((-1.3, -1.3, -1.3), 0.1625, (16, 16, 32))
        cfg = SDFConfig(tile_shape=(8, 8, 4), tile2d_shape=(8, 4),
                        vdt_max_hop=4)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_indivisible_grid_raises(self):
        dmesh = _mesh_or_skip()
        m = box_mesh()
        g = GridSpec((-0.5, -0.5, -0.5), 0.2, (10, 11, 13))
        with pytest.raises(ValueError):
            bin_mesh_sharded(m, g, dmesh.devices.shape, SDFConfig())


class TestShardedPyramid:
    """The DEFAULT sharded schedule (no vdt_max_hop): the same pyramid far
    field a single-device run uses, distributed via local downsamples +
    an all_gather'ed coarsest ladder + halo-extended repair rounds. Must
    reproduce the single-device pyramid result (identical arithmetic; the
    tolerance covers XLA fusion/FMA reassociation across the two program
    structures plus symmetric-tie adoptions, as in _assert_equivalent)."""

    def test_small_grid_single_level(self):
        # grid <= 48: a one-level pyramid — the whole state is gathered and
        # the ladder runs replicated
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 0.0875, (32, 32, 32))
        cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_two_level_pyramid_matches(self):
        # 64-class: one downsample + halo repair rounds at full resolution
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 2.8 / 64, (64, 64, 64))
        cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_three_level_pyramid_matches(self):
        # 128-wide sharded axes with a thin i: two downsamples, so repair
        # rounds run at intermediate levels too (halo depth up to 8 at the
        # half-resolution level)
        dmesh = _mesh_or_skip()
        m = icosphere(3, radius=1.0, center=(0.03, -0.02, 0.01))
        g = GridSpec((-1.25, -1.25, -1.25), 2.5 / 128, (8, 128, 128))
        cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_block_too_small_raises(self):
        dmesh = _mesh_or_skip(shape=(1, 8))
        m = icosphere(2, radius=1.0)
        # nk_l = 64/8 = 8 < 16 needed for a three-level pyramid
        g = GridSpec((-1.25, -1.25, -1.25), 2.5 / 128, (8, 128, 64))
        cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        with pytest.raises(ValueError, match="pyramid"):
            sharded_sdf(sb, dmesh, verts=m.verts)

    def test_gradient_matches_single_device(self):
        dmesh = _mesh_or_skip()
        m = icosphere(1, radius=0.9, center=(0.02, 0.01, -0.03))
        # break the icosphere's symmetries: tied closest triangles resolve
        # by strict '<' on f32 distances, and XLA's different fusion of the
        # sharded vs single-device programs can flip a 1-ulp tie — a
        # legitimate subgradient ambiguity, not a sharding defect. An
        # asymmetric mesh makes exact ties measure-zero.
        rng = np.random.default_rng(7)
        m = type(m)(
            (m.verts + rng.uniform(-0.02, 0.02, m.verts.shape)
             ).astype(np.float32),
            m.tris,
        )
        g = GridSpec((-1.3, -1.3, -1.3), 2.6 / 64, (64, 64, 64))
        cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        binned = bin_mesh(m, g, cfg)
        rng = np.random.default_rng(3)
        w = jnp.asarray(rng.standard_normal(g.shape).astype(np.float32))
        g_sharded = np.asarray(jax.grad(
            lambda v: jnp.sum(sharded_sdf(sb, dmesh, verts=v) * w)
        )(jnp.asarray(m.verts)))
        g_single = np.asarray(jax.grad(
            lambda v: jnp.sum(
                make_level_set3(m, g, cfg, binned=binned, verts=v) * w
            )
        )(jnp.asarray(m.verts)))
        # At cells whose two closest triangles are within ~1 ulp, the
        # strict-'<' winner can flip between the two program structures
        # (XLA fuses them differently); the flipped cell's gradient then
        # legitimately attributes to the OTHER triangle's vertices. Over a
        # 64^3 far field a handful of such cells is expected, so assert
        # agreement everywhere but a small component fraction, plus a tight
        # aggregate bound.
        diff = np.abs(g_sharded - g_single)
        tol = 1e-4 + 5e-3 * np.abs(g_single)
        frac_bad = float((diff > tol).mean())
        assert frac_bad < 0.03, f"{frac_bad:.3f} of components deviate"
        scale = max(np.abs(g_single).max(), 1e-6)
        assert float(np.median(diff)) < 1e-4 * scale


class TestShardedEikonal:
    def test_matches_single_device(self):
        # the CUDA-backend-semantics mode, sharded: same band evaluator,
        # Jacobi |grad phi|=1 relaxation with 1-cell halos per iteration
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 0.0875, (32, 32, 32))
        cfg = SDFConfig(far_field="eikonal", tile2d_shape=(8, 8),
                        dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_1d_mesh(self):
        dmesh = _mesh_or_skip(shape=(1, 8))
        m = icosphere(1, radius=1.0)
        g = GridSpec((-1.3, -1.3, -1.3), 2.6 / 32, (16, 16, 32))
        cfg = SDFConfig(far_field="eikonal", tile_shape=(8, 8, 4),
                        tile2d_shape=(8, 4), dense_max_tris=0,
                        eikonal_iters=40)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)


class TestShardedDeviceSign:
    """sign_mode="device" sharded: the 2D (j, k) sign tiles are partitioned
    per shard and the double-float SOS predicates run on each shard's own
    rays (the ray axis is unsharded) — the sign of every cell must match a
    single-device device-sign run exactly."""

    @pytest.mark.parametrize("dense_cap", [1024, 0])
    def test_matches_single_device(self, dense_cap):
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 0.0875, (32, 32, 32))
        cfg = SDFConfig(sign_mode="device", tile2d_shape=(8, 8),
                        dense_max_tris=dense_cap, vdt_max_hop=4)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        assert sb.sign_ids is not None and sb.parity_packed.shape[2] == 0
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_box_sos_ties_on_shard_boundaries(self):
        # grid-aligned box faces: every sign decision is an SOS tie-break;
        # crossing shard boundaries must not change any of them
        dmesh = _mesh_or_skip()
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.25, (28, 32, 32))
        cfg = SDFConfig(sign_mode="device", tile_shape=(4, 4, 4),
                        tile2d_shape=(8, 8), vdt_max_hop=4)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)

    def test_eikonal_with_device_sign(self):
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 0.0875, (32, 32, 32))
        cfg = SDFConfig(far_field="eikonal", sign_mode="device",
                        tile2d_shape=(8, 8), dense_max_tris=0)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)


class TestShardedPropagate:
    """Legacy far_field="propagate" sharded: directional plane scans with
    serialized cross-shard rounds must reproduce the single-device fixed
    point bit-for-bit (same plane_update kernel, same pass count)."""

    def test_matches_single_device(self):
        dmesh = _mesh_or_skip()
        m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
        g = GridSpec((-1.4, -1.4, -1.4), 0.0875, (32, 32, 32))
        cfg = SDFConfig(far_field="propagate", tile2d_shape=(8, 8),
                        dense_max_tris=0, max_passes=8)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        np.testing.assert_array_equal(phi_sharded, phi_single)

    def test_1d_mesh_k(self):
        # (1, 8) mesh: all serialization rides the k axis
        dmesh = _mesh_or_skip(shape=(1, 8))
        m = icosphere(1, radius=1.0)
        g = GridSpec((-1.3, -1.3, -1.3), 2.6 / 32, (16, 16, 32))
        cfg = SDFConfig(far_field="propagate", tile_shape=(8, 8, 4),
                        tile2d_shape=(8, 4), dense_max_tris=0,
                        max_passes=8)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        np.testing.assert_array_equal(phi_sharded, phi_single)


class TestShardedGradients:
    @pytest.mark.parametrize("dense_cap", [1024, 0])
    def test_gradient_matches_single_device(self, dense_cap):
        dmesh = _mesh_or_skip()
        m = icosphere(1, radius=0.9, center=(0.02, 0.01, -0.03))
        g = GridSpec((-1.3, -1.3, -1.3), 0.1625, (16, 16, 16))
        cfg = SDFConfig(tile_shape=(8, 8, 4), tile2d_shape=(8, 4),
                        dense_max_tris=dense_cap, vdt_max_hop=4)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        binned = bin_mesh(m, g, cfg)
        rng = np.random.default_rng(1)
        w = jnp.asarray(rng.standard_normal(g.shape).astype(np.float32))

        g_sharded = jax.grad(
            lambda v: jnp.sum(sharded_sdf(sb, dmesh, verts=v) * w)
        )(jnp.asarray(m.verts))
        g_single = jax.grad(
            lambda v: jnp.sum(
                make_level_set3(m, g, cfg, binned=binned, verts=v) * w
            )
        )(jnp.asarray(m.verts))
        # cells whose two closest triangles tie in distance may resolve to
        # different ids across propagation orders; their subgradients differ
        # legitimately, so allow a small fraction of ~1e-4-level deviations
        np.testing.assert_allclose(
            np.asarray(g_sharded), np.asarray(g_single), rtol=5e-3, atol=1e-4
        )


@pytest.mark.slow
class TestSharded512Class:
    def test_512_class_halo_ladder_matches_single_device(self):
        # The 512-class sharded-correctness analog on the virtual CPU
        # mesh: 512-wide sharded axes (blocks 256x128 on the (2,4) mesh), so
        # the capped jump-flood ladder runs deep halo exchanges; the i-axis
        # is kept thin to make the CPU run affordable.
        dmesh = _mesh_or_skip()
        m = icosphere(3, radius=1.0, center=(0.03, -0.02, 0.01))
        g = GridSpec((-1.25, -1.25, -1.25), 2.5 / 512, (8, 512, 512))
        cfg = SDFConfig(tile2d_shape=(8, 8), tile_shape=(8, 8, 8),
                        dense_max_tris=0, vdt_max_hop=32)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)


@pytest.mark.slow
class TestSharded1024Class:
    def test_1024_class_halo_ladder_matches_single_device(self):
        # A 1024-class grid on the virtual CPU mesh: 1024-wide
        # sharded axes (blocks 512x256 on the (2,4) mesh) exercise the
        # capped ladder's deepest halo cascades; thin i keeps the CPU run
        # affordable (8 x 1024 x 1024 = 8.4M cells). The (5, n, n, n) f32
        # VDT state at 1024^3 is ~21.5 GB.
        dmesh = _mesh_or_skip()
        m = icosphere(3, radius=1.0, center=(0.02, 0.015, -0.01))
        g = GridSpec((-1.25, -1.25, -1.25), 2.5 / 1024, (8, 1024, 1024))
        cfg = SDFConfig(tile2d_shape=(8, 8), tile_shape=(8, 8, 8),
                        dense_max_tris=0, vdt_max_hop=32)
        sb = bin_mesh_sharded(m, g, dmesh.devices.shape, cfg)
        phi_sharded = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))
        phi_single = np.asarray(make_level_set3(m, g, cfg))
        _assert_equivalent(phi_sharded, phi_single)
