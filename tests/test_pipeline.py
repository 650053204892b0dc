"""End-to-end pipeline tests against the float64 brute-force oracle."""

import numpy as np
import pytest

from sdfgenfast import GridSpec, SDFConfig, box_mesh, make_level_set3
from sdfgenfast.mesh import icosphere
from sdfgenfast.pipeline import bin_mesh
from sdfgenfast.grid import sizing_mode2a_proportional
from oracle import brute_force_sdf

SURF_EPS = 1e-5  # cells lying exactly on the surface have ambiguous sign


def _check_against_oracle(mesh, grid, config=SDFConfig(), dist_tol=2e-5):
    phi = np.asarray(make_level_set3(mesh, grid, config))
    ref, parity = brute_force_sdf(
        mesh.verts, mesh.tris, grid.origin, grid.dx, grid.shape, return_parity=True
    )
    # Near the surface: exact narrow band -> tight match with true min distance.
    near = np.abs(ref) < 2 * grid.dx
    np.testing.assert_allclose(
        np.abs(phi)[near], np.abs(ref)[near], rtol=dist_tol, atol=dist_tol * grid.dx
    )
    # Far field: closest-triangle propagation can stall at local optima near
    # the medial axis (the reference's Gauss-Seidel sweeps share this; its own
    # far-field tolerance is 25*dx, tests/test_correctness.cpp:195). We see
    # <0.1*dx in practice and never an underestimate.
    err = np.abs(phi) - np.abs(ref)
    assert err.min() > -1e-4 * grid.dx - 1e-6
    assert err.max() < 0.1 * grid.dx
    # inside/outside decisions away from the surface
    off_surface = np.abs(ref) > SURF_EPS
    got_inside = phi < 0
    assert (got_inside == parity)[off_surface].all()
    return phi


class TestBoxPipeline:
    def test_box_on_grid_lines(self):
        # vertices exactly on grid planes: the SOS tie-break gauntlet
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.5, (14, 16, 18))
        phi = _check_against_oracle(m, g)
        # interior cell is inside, corner of grid is outside
        assert phi[4, 5, 6] < 0
        assert phi[0, 0, 0] > 0

    def test_box_irrational_dx(self):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.3, -1.27, -1.11), 0.173, (24, 26, 28))
        _check_against_oracle(m, g)

    def test_box_larger_band(self):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.35, (18, 20, 24))
        _check_against_oracle(m, g, SDFConfig(exact_band=3))

    def test_mesh_partially_outside_grid(self):
        # grid covers only part of the mesh: clamped windows + dropped +x rays
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-0.25, -0.25, -0.25), 0.5, (8, 8, 8))
        _check_against_oracle(m, g)

    def test_single_triangle_open_surface(self):
        # non-watertight input: parity semantics still follow the reference
        from sdfgenfast.mesh import Mesh

        verts = np.array([[0.1, 0.1, 0.1], [1.9, 0.2, 0.15], [0.3, 1.8, 0.2]], np.float32)
        tris = np.array([[0, 1, 2]], np.uint32)
        m = Mesh(verts, tris)
        g = GridSpec((-0.5, -0.5, -0.5), 0.25, (12, 12, 12))
        _check_against_oracle(m, g)


class TestSpherePipeline:
    def test_icosphere(self):
        m = icosphere(2, radius=1.0, center=(0.1, -0.05, 0.07))
        g = GridSpec((-1.5, -1.5, -1.5), 0.125, (24, 24, 24))
        phi = _check_against_oracle(m, g)
        # sanity: near-surface values approximate |r| - 1
        ii, jj, kk = np.meshgrid(*(np.arange(n) for n in g.shape), indexing="ij")
        pos = np.stack([ii, jj, kk], -1) * g.dx + np.asarray(g.origin)
        r = np.linalg.norm(pos - np.array([0.1, -0.05, 0.07]), axis=-1)
        band = np.abs(r - 1.0) < 2 * g.dx
        # chord-vs-arc error of the coarse icosphere dominates; loose tol
        assert np.abs(phi[band] - (r[band] - 1.0)).max() < 0.05

    def test_eikonal_mode_band_exact_far_approx(self):
        m = icosphere(2, radius=1.0)
        g = GridSpec((-1.6, -1.6, -1.6), 0.2, (16, 16, 16))
        phi_e = np.asarray(make_level_set3(m, g, SDFConfig(far_field="eikonal")))
        ref, parity = brute_force_sdf(
            m.verts, m.tris, g.origin, g.dx, g.shape, return_parity=True
        )
        # the reference tolerates CPU/GPU far-field divergence up to 25*dx
        # (tests/test_correctness.cpp:195); eikonal error is far smaller here
        assert np.abs(np.abs(phi_e) - np.abs(ref)).max() < 2 * g.dx
        off = np.abs(ref) > SURF_EPS
        assert ((phi_e < 0) == parity)[off].all()


class TestAlternatePaths:
    """E2E coverage for every public SDFConfig mode combination: the device
    sign path (double-float SOS predicates, ops/sign.py) and the legacy
    directional-scan far field (ops/sweep.py) must agree with the oracle,
    not just have unit-tested micro-ops."""

    def test_device_sign_mode(self):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.5, (14, 16, 18))
        cfg = SDFConfig(sign_mode="device", tile2d_shape=(8, 8))
        _check_against_oracle(m, g, cfg)

    def test_device_sign_mode_sphere(self):
        m = icosphere(1, radius=1.0, center=(0.07, -0.04, 0.02))
        g = GridSpec((-1.4, -1.4, -1.4), 0.2, (14, 14, 14))
        cfg = SDFConfig(sign_mode="device", tile2d_shape=(8, 8))
        _check_against_oracle(m, g, cfg)

    def test_device_sign_matches_host_sign(self):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        # vertices exactly on grid planes: the SOS tie-break gauntlet —
        # device double-float predicates must reproduce the host f64 signs
        g = GridSpec((-1.5, -1.5, -1.5), 0.25, (26, 28, 30))
        a = np.asarray(make_level_set3(m, g, SDFConfig(sign_mode="host")))
        b = np.asarray(
            make_level_set3(m, g, SDFConfig(sign_mode="device", tile2d_shape=(8, 8)))
        )
        # cells ON the surface (|phi| ~ f32 eps of 0) have ambiguous sign —
        # both predicates count the same crossings but at x-coordinates that
        # round to the cell plane itself; everywhere else: exact agreement
        off_surface = np.minimum(np.abs(a), np.abs(b)) > SURF_EPS
        assert ((a < 0) == (b < 0))[off_surface].all()

    def test_propagate_far_field(self):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        g = GridSpec((-1.5, -1.5, -1.5), 0.5, (14, 16, 18))
        _check_against_oracle(m, g, SDFConfig(far_field="propagate"))

    def test_propagate_far_field_sphere(self):
        m = icosphere(2, radius=1.0, center=(0.05, -0.03, 0.06))
        g = GridSpec((-1.5, -1.5, -1.5), 0.15, (20, 20, 20))
        _check_against_oracle(m, g, SDFConfig(far_field="propagate"))


class TestBinningInvariance:
    def test_tile_shape_invariance(self):
        m = icosphere(1, radius=1.0)
        g = GridSpec((-1.4, -1.4, -1.4), 0.2, (14, 14, 14))
        a = np.asarray(make_level_set3(m, g, SDFConfig(tile_shape=(8, 8, 8))))
        b = np.asarray(make_level_set3(m, g, SDFConfig(tile_shape=(4, 4, 16))))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_rebind_reuse(self):
        m = box_mesh((2, 2, 2))
        g = GridSpec((-0.5, -0.5, -0.5), 0.25, (12, 12, 12))
        binned = bin_mesh(m, g, SDFConfig())
        a = np.asarray(make_level_set3(m, g, SDFConfig(), binned=binned))
        b = np.asarray(make_level_set3(m, g, SDFConfig()))
        np.testing.assert_array_equal(a, b)


class TestErrors:
    def test_empty_mesh(self):
        from sdfgenfast.mesh import Mesh

        m = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32))
        g = GridSpec((0, 0, 0), 1.0, (4, 4, 4))
        with pytest.raises(ValueError):
            make_level_set3(m, g)


class TestCrossingsTransport:
    """parity_transport="crossings" must reproduce the packed transport's
    output exactly: same host f64 predicates, parity reconstructed on device
    as XOR of (i >= crossing) compares (ops/sign_host.py:89-96)."""

    def test_dense_path_matches_packed(self):
        mesh = box_mesh((1.2, 1.0, 0.8), (-0.5, -0.5, -0.4))
        mn, mx = mesh.bounds()
        grid = sizing_mode2a_proportional(mn, mx, 32, 2)
        a = np.asarray(make_level_set3(mesh, grid, SDFConfig()))
        b = np.asarray(make_level_set3(
            mesh, grid, SDFConfig(parity_transport="crossings")))
        np.testing.assert_array_equal(a, b)

    def test_band_path_matches_packed(self):
        mesh = icosphere(4, radius=1.0)
        mn, mx = mesh.bounds()
        grid = sizing_mode2a_proportional(mn, mx, 48, 1)
        a = np.asarray(make_level_set3(mesh, grid, SDFConfig()))
        b = np.asarray(make_level_set3(
            mesh, grid, SDFConfig(parity_transport="crossings")))
        np.testing.assert_array_equal(a, b)

    def test_unknown_transport_raises(self):
        mesh = box_mesh()
        mn, mx = mesh.bounds()
        grid = sizing_mode2a_proportional(mn, mx, 16, 1)
        with pytest.raises(ValueError, match="parity_transport"):
            make_level_set3(mesh, grid,
                            SDFConfig(parity_transport="bogus",
                                      dense_max_tris=0))


class TestVdtAxisPermutation:
    """Non-cubic grids run the pyramid VDT with axes permuted (largest dim
    last); results must stay oracle-accurate in the original
    orientation."""

    def test_flat_grid_against_oracle(self):
        m = icosphere(2, radius=1.0, center=(0.04, -0.02, 0.03))
        # k much smaller than i/j: the permutation moves j/i onto lanes
        g = GridSpec((-1.4, -1.4, -0.35), 0.09, (32, 32, 8))
        from sdfgenfast.pipeline import _vdt_axis_perm
        assert _vdt_axis_perm(g.shape) != (0, 1, 2)
        _check_against_oracle(m, g)
