"""Property tests: JAX geometry kernels vs the float64 NumPy oracle, and
double-float arithmetic accuracy."""

import numpy as np
import jax.numpy as jnp

from sdfgenfast.ops import df as dfm
from sdfgenfast.ops.geometry import (
    closest_point_weights,
    point_segment_distance_sq,
    point_triangle_distance_sq,
)
from oracle import point_triangle_distance_np


def _rand(n, rng, scale=2.0):
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


class TestDistances:
    def test_triangle_distance_matches_oracle(self):
        rng = np.random.default_rng(42)
        n = 4096
        x0, x1, x2, x3 = (_rand(n, rng) for _ in range(4))
        d_jax = np.sqrt(
            np.asarray(point_triangle_distance_sq(*map(jnp.asarray, (x0, x1, x2, x3))))
        )
        d_ref = point_triangle_distance_np(
            *(v.astype(np.float64) for v in (x0, x1, x2, x3))
        )
        np.testing.assert_allclose(d_jax, d_ref, rtol=2e-5, atol=2e-6)

    def test_degenerate_triangle(self):
        # collinear and repeated vertices must stay finite
        x0 = jnp.asarray([[0.0, 1.0, 0.0]])
        x1 = jnp.asarray([[0.0, 0.0, 0.0]])
        x2 = jnp.asarray([[1.0, 0.0, 0.0]])
        d = np.asarray(point_triangle_distance_sq(x0, x1, x2, x2))
        assert np.isfinite(d).all()
        # Reference-faithful degenerate behavior: with x2 == x3 the barycentric
        # case degenerates to w12 = 1 -> closest "point" is x3, giving sqrt(2)
        # (the reference's guarded invdet produces the same, makelevelset3.cpp:54).
        np.testing.assert_allclose(np.sqrt(d), np.sqrt(2.0), rtol=1e-6)
        d2 = np.asarray(point_triangle_distance_sq(x0, x1, x1, x1))
        np.testing.assert_allclose(np.sqrt(d2), 1.0, rtol=1e-6)

    def test_segment_distance(self):
        x0 = jnp.asarray([[2.0, 1.0, 0.0]])
        x1 = jnp.asarray([[0.0, 0.0, 0.0]])
        x2 = jnp.asarray([[1.0, 0.0, 0.0]])
        # beyond the x2 end: closest point is x2
        np.testing.assert_allclose(
            np.asarray(point_segment_distance_sq(x0, x1, x2))[0], 2.0, rtol=1e-6
        )

    def test_closest_point_weights_reproduce_distance(self):
        rng = np.random.default_rng(7)
        n = 4096
        x0, x1, x2, x3 = (jnp.asarray(_rand(n, rng)) for _ in range(4))
        w1, w2, w3 = closest_point_weights(x0, x1, x2, x3)
        w1, w2, w3 = (np.asarray(w) for w in (w1, w2, w3))
        np.testing.assert_allclose(w1 + w2 + w3, 1.0, atol=1e-5)
        assert (w1 >= -1e-6).all() and (w2 >= -1e-6).all() and (w3 >= -1e-6).all()
        c = w1[:, None] * np.asarray(x1) + w2[:, None] * np.asarray(x2) + w3[:, None] * np.asarray(x3)
        d_from_w = np.linalg.norm(np.asarray(x0) - c, axis=-1)
        d_ref = np.sqrt(np.asarray(point_triangle_distance_sq(x0, x1, x2, x3)))
        np.testing.assert_allclose(d_from_w, d_ref, rtol=1e-4, atol=1e-5)


class TestDoubleFloat:
    def test_two_sum_exact(self):
        a = jnp.float32(1.0)
        b = jnp.float32(1e-8)
        s, e = dfm.two_sum(a, b)
        assert float(s) == 1.0
        assert float(e) == float(np.float32(1e-8))  # rounding error recovered exactly

    def test_two_prod_exact(self):
        rng = np.random.default_rng(3)
        a = rng.standard_normal(1000).astype(np.float32)
        b = rng.standard_normal(1000).astype(np.float32)
        p, e = dfm.two_prod(jnp.asarray(a), jnp.asarray(b))
        exact = a.astype(np.float64) * b.astype(np.float64)
        got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        np.testing.assert_array_equal(got, exact)

    def test_df_mul_precision(self):
        rng = np.random.default_rng(4)
        x64 = rng.standard_normal(1000) * 100
        y64 = rng.standard_normal(1000) * 100
        xd = dfm.DF(*_split(x64))
        yd = dfm.DF(*_split(y64))
        z = dfm.mul(xd, yd)
        got = np.asarray(z.hi, np.float64) + np.asarray(z.lo, np.float64)
        rel = np.abs(got - x64 * y64) / np.abs(x64 * y64)
        assert rel.max() < 1e-13

    def test_df_sign_ties(self):
        # exact cancellation: (a*b) - (b*a) == 0
        a = dfm.df(jnp.float32(3.7))
        b = dfm.df(jnp.float32(11.3))
        z = dfm.sub(dfm.mul(a, b), dfm.mul(b, a))
        assert int(dfm.sign(z)) == 0

    def test_df_sign_tiny_difference(self):
        # values differing at ~2^-40: sign must resolve
        x = dfm.DF(jnp.float32(1.0), jnp.float32(2**-40))
        y = dfm.df(jnp.float32(1.0))
        assert int(dfm.sign(dfm.sub(x, y))) == 1
        assert bool(dfm.lt(y, x))


def _split(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)
