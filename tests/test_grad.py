"""Differentiability: vertex gradients of the SDF grid vs finite differences.

This is the new capability this framework adds over the reference:
d phi(grid) / d vertices via the barycentric closest-point VJP with
the discrete closest-triangle/parity fields frozen (envelope theorem)."""

import numpy as np
import jax
import jax.numpy as jnp

from sdfgenfast import GridSpec, SDFConfig, box_mesh, make_level_set3
from sdfgenfast.mesh import icosphere
from sdfgenfast.pipeline import bin_mesh


def _loss_fn(mesh, grid, binned, weights):
    """Scalar loss = <weights, phi(verts)> so grad check is one VJP."""

    def f(verts):
        phi = make_level_set3(mesh, grid, SDFConfig(), binned=binned, verts=verts)
        return jnp.sum(phi * weights)

    return f


class TestVertexGradients:
    def test_finite_difference_match(self):
        # Offset the sphere so no vertex/cell coincidences create subgradient
        # ambiguity at the FD probe points.
        m = icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
        g = GridSpec((-1.43, -1.41, -1.45), 0.19, (15, 15, 15))
        binned = bin_mesh(m, g, SDFConfig())
        rng = np.random.default_rng(0)
        w = jnp.asarray(rng.standard_normal(g.shape).astype(np.float32))
        f = _loss_fn(m, g, binned, w)

        v0 = jnp.asarray(m.verts)
        grad = np.asarray(jax.grad(f)(v0))
        assert np.isfinite(grad).all()
        assert np.abs(grad).max() > 0

        # central finite differences on a handful of coordinates (float32 =>
        # eps must be large-ish; binning is reused, valid for tiny moves)
        eps = 1e-3
        checked = 0
        for vi, ax in [(0, 0), (3, 1), (7, 2), (11, 0), (20, 1)]:
            dv = np.zeros_like(m.verts)
            dv[vi, ax] = eps
            fp = float(f(jnp.asarray(m.verts + dv)))
            fm = float(f(jnp.asarray(m.verts - dv)))
            fd = (fp - fm) / (2 * eps)
            an = grad[vi, ax]
            # tolerance: float32 loss over ~3000 cells -> FD noise ~1e-2
            assert abs(fd - an) < 2e-2 * max(1.0, abs(fd)), (
                f"vertex {vi} axis {ax}: fd={fd:.5f} analytic={an:.5f}"
            )
            checked += 1
        assert checked == 5

    def test_gradient_of_inside_cells_points_outward(self):
        # Growing a box should make inside cells more negative: d phi / d scale < 0.
        m = box_mesh((2, 2, 2), (-1, -1, -1))
        g = GridSpec((-1.6, -1.6, -1.6), 0.4, (9, 9, 9))
        binned = bin_mesh(m, g, SDFConfig())

        def phi_center(verts):
            phi = make_level_set3(m, g, SDFConfig(), binned=binned, verts=verts)
            return phi[4, 4, 4]  # cell at the box center (inside)

        v0 = jnp.asarray(m.verts)
        val, grad = jax.value_and_grad(phi_center)(v0)
        assert float(val) < 0
        # directional derivative along uniform outward scaling about center
        center = np.array([0.0, 0.0, 0.0], np.float32)
        direction = np.asarray(v0) - center
        dd = float((np.asarray(grad) * direction).sum())
        assert dd < 0  # growing the box deepens the inside distance

    def test_grad_zero_for_far_clamped_cells(self):
        # cells with tid == -1 (mesh far outside grid) contribute no gradient
        m = box_mesh((0.5, 0.5, 0.5), (10.0, 10.0, 10.0))
        g = GridSpec((0.0, 0.0, 0.0), 0.5, (6, 6, 6))
        binned = bin_mesh(m, g, SDFConfig(max_passes=1))

        def f(verts):
            phi = make_level_set3(
                m, g, SDFConfig(max_passes=1), binned=binned, verts=verts
            )
            return jnp.sum(phi)

        grad = np.asarray(jax.grad(f)(jnp.asarray(m.verts)))
        assert np.isfinite(grad).all()
