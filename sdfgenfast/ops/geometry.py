"""Batched point/segment/triangle geometry kernels (JAX, float32).

Semantics reproduce the reference's scalar kernels — same case analysis and
clamping as ``point_segment_distance`` (cpu_lib/makelevelset3.cpp:21-34) and
``point_triangle_distance`` (cpu_lib/makelevelset3.cpp:49-70) — but as
branchless, broadcast-vectorized JAX suitable for (cells x triangles) batch
evaluation. We compute squared distances and defer the sqrt to
after the min-reduction (argmin of d equals argmin of d^2 for d >= 0).

``closest_point_weights`` additionally returns the barycentric weights of the
closest point for the analytic vertex-gradient VJP (the reference has no
gradients; this is the new differentiable capability).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

__all__ = [
    "gather_tri9",
    "point_segment_distance_sq",
    "point_triangle_distance_sq",
    "point_triangle_distance_sq_soa",
    "point_triangle_distance",
    "closest_point_weights",
]


def gather_tri9(tri9, tid):
    """Gather triangle vertex coordinates as 9 SEPARATE 1-D gathers.

    `tri9` is the (9, M) SoA vertex table, `tid` any integer index array
    (negative ids are clamped to 0 — callers mask by tid >= 0). Returns
    (a, b, c): three length-3 tuples of arrays shaped like `tid`.

    Why not `tri9[:, flat]`: XLA lays that gather out as [N, 9]; nine 1-D
    gathers have no small trailing dim for a tiled layout to pad.
    """
    flat = jnp.maximum(tid, 0).reshape(-1)
    vs = [jnp.take(tri9[r], flat, axis=0).reshape(tid.shape) for r in range(9)]
    return tuple(vs[0:3]), tuple(vs[3:6]), tuple(vs[6:9])


def point_triangle_distance_sq_soa(p, a, b, c):
    """Structure-of-arrays variant: p/a/b/c are length-3 tuples of same-shape
    coordinate arrays. Avoids (..., 3)-stacked intermediates at grid size.
    Same math as the stacked version.
    """

    def d3(ux, uy, uz, vx, vy, vz):
        return ux * vx + uy * vy + uz * vz

    x13 = tuple(a[i] - c[i] for i in range(3))
    x23 = tuple(b[i] - c[i] for i in range(3))
    x03 = tuple(p[i] - c[i] for i in range(3))
    m13 = d3(*x13, *x13)
    m23 = d3(*x23, *x23)
    d = d3(*x13, *x23)
    invdet = 1.0 / jnp.maximum(m13 * m23 - d * d, jnp.float32(1e-30))
    pa = d3(*x13, *x03)
    pb = d3(*x23, *x03)
    w23 = invdet * (m23 * pa - d * pb)
    w31 = invdet * (m13 * pb - d * pa)
    w12 = 1.0 - w23 - w31
    inside = (w23 >= 0.0) & (w31 >= 0.0) & (w12 >= 0.0)
    cin = tuple(w23 * a[i] + w31 * b[i] + w12 * c[i] for i in range(3))
    din = d3(*(p[i] - cin[i] for i in range(3)), *(p[i] - cin[i] for i in range(3)))

    def seg(x1, x2):
        dv = tuple(x2[i] - x1[i] for i in range(3))
        m2 = d3(*dv, *dv)
        s = d3(*(x2[i] - p[i] for i in range(3)), *dv) / jnp.maximum(
            m2, jnp.float32(1e-30)
        )
        s = jnp.clip(s, 0.0, 1.0)
        cc = tuple(s * x1[i] + (1.0 - s) * x2[i] for i in range(3))
        dd = tuple(p[i] - cc[i] for i in range(3))
        return d3(*dd, *dd)

    d12 = seg(a, b)
    d13 = seg(a, c)
    d23 = seg(b, c)
    d_edge = jnp.where(
        w23 > 0.0,
        jnp.minimum(d12, d13),
        jnp.where(w31 > 0.0, jnp.minimum(d12, d23), jnp.minimum(d13, d23)),
    )
    return jnp.where(inside, din, d_edge)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def point_segment_distance_sq(x0, x1, x2):
    """Squared distance from x0 to segment [x1, x2]; broadcasts over leading dims.

    Matches cpu_lib/makelevelset3.cpp:21-34: s12 = clamp(dot(x2-x0, x2-x1)/|x2-x1|^2)
    weights x1 by s12 and x2 by (1-s12).
    """
    d = x2 - x1
    m2 = _dot(d, d)
    s12 = _dot(x2 - x0, d) / jnp.maximum(m2, jnp.float32(1e-30))
    s12 = jnp.clip(s12, 0.0, 1.0)
    c = s12[..., None] * x1 + (1.0 - s12)[..., None] * x2
    diff = x0 - c
    return _dot(diff, diff)


def _triangle_case(x0, x1, x2, x3):
    """Shared case analysis: barycentric weights of the plane projection.

    Returns (w23, w31, w12, inside) following the reference's naming: w23 is
    the weight on x1, w31 on x2, w12 on x3 (cpu_lib/makelevelset3.cpp:51-59).
    """
    x13 = x1 - x3
    x23 = x2 - x3
    x03 = x0 - x3
    m13 = _dot(x13, x13)
    m23 = _dot(x23, x23)
    d = _dot(x13, x23)
    invdet = 1.0 / jnp.maximum(m13 * m23 - d * d, jnp.float32(1e-30))
    a = _dot(x13, x03)
    b = _dot(x23, x03)
    w23 = invdet * (m23 * a - d * b)
    w31 = invdet * (m13 * b - d * a)
    w12 = 1.0 - w23 - w31
    inside = (w23 >= 0.0) & (w31 >= 0.0) & (w12 >= 0.0)
    return w23, w31, w12, inside


def point_triangle_distance_sq(x0, x1, x2, x3):
    """Squared distance from x0 to triangle (x1, x2, x3); broadcasts leading dims."""
    w23, w31, w12, inside = _triangle_case(x0, x1, x2, x3)
    c_in = w23[..., None] * x1 + w31[..., None] * x2 + w12[..., None] * x3
    diff = x0 - c_in
    d_in = _dot(diff, diff)

    d12 = point_segment_distance_sq(x0, x1, x2)
    d13 = point_segment_distance_sq(x0, x1, x3)
    d23 = point_segment_distance_sq(x0, x2, x3)
    # Case selection identical to cpu_lib/makelevelset3.cpp:62-69:
    #   w23>0 -> min(seg12, seg13); elif w31>0 -> min(seg12, seg23);
    #   else -> min(seg13, seg23).
    d_edge = jnp.where(
        w23 > 0.0,
        jnp.minimum(d12, d13),
        jnp.where(w31 > 0.0, jnp.minimum(d12, d23), jnp.minimum(d13, d23)),
    )
    return jnp.where(inside, d_in, d_edge)


def point_triangle_distance(x0, x1, x2, x3):
    return jnp.sqrt(point_triangle_distance_sq(x0, x1, x2, x3))


def _segment_weight(x0, x1, x2):
    d = x2 - x1
    m2 = _dot(d, d)
    s12 = _dot(x2 - x0, d) / jnp.maximum(m2, jnp.float32(1e-30))
    return jnp.clip(s12, 0.0, 1.0)


def closest_point_weights(x0, x1, x2, x3) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Barycentric weights (w1, w2, w3) of the closest point on the triangle.

    closest = w1*x1 + w2*x2 + w3*x3, with the same region selection as
    ``point_triangle_distance_sq``. At region boundaries the closest point is
    continuous, so any consistent choice yields a valid (sub)gradient.
    """
    w23, w31, w12, inside = _triangle_case(x0, x1, x2, x3)

    s_12 = _segment_weight(x0, x1, x2)  # weight on x1 along edge (x1, x2)
    s_13 = _segment_weight(x0, x1, x3)
    s_23 = _segment_weight(x0, x2, x3)
    d12 = point_segment_distance_sq(x0, x1, x2)
    d13 = point_segment_distance_sq(x0, x1, x3)
    d23 = point_segment_distance_sq(x0, x2, x3)

    zeros = jnp.zeros_like(s_12)

    def edge_weights(sel12, sel13, sel23):
        # one-hot over which edge was selected -> barycentric triple
        w1 = sel12 * s_12 + sel13 * s_13
        w2 = sel12 * (1.0 - s_12) + sel23 * s_23
        w3 = sel13 * (1.0 - s_13) + sel23 * (1.0 - s_23)
        return w1, w2, w3

    # Region w23>0: candidates edges 12 and 13
    use12_a = (d12 <= d13).astype(x0.dtype)
    # Region w31>0: candidates edges 12 and 23
    use12_b = (d12 <= d23).astype(x0.dtype)
    # Region else: candidates edges 13 and 23
    use13_c = (d13 <= d23).astype(x0.dtype)

    wa = edge_weights(use12_a, 1.0 - use12_a, zeros)
    wb = edge_weights(use12_b, zeros, 1.0 - use12_b)
    wc = edge_weights(zeros, use13_c, 1.0 - use13_c)

    in_a = (w23 > 0.0) & ~inside
    in_b = (w31 > 0.0) & ~(w23 > 0.0) & ~inside
    in_c = ~(w23 > 0.0) & ~(w31 > 0.0) & ~inside

    def pick(i):
        return (
            inside * [w23, w31, w12][i]
            + in_a * wa[i]
            + in_b * wb[i]
            + in_c * wc[i]
        )

    inside = inside.astype(x0.dtype)
    in_a = in_a.astype(x0.dtype)
    in_b = in_b.astype(x0.dtype)
    in_c = in_c.astype(x0.dtype)
    return pick(0), pick(1), pick(2)
