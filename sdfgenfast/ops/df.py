"""Double-float ("double-word") arithmetic on float32 pairs.

The reference's inside/outside test runs in double precision
(grid-coordinate conversion ``cpu_lib/makelevelset3.cpp:206-208`` and the SOS
orientation/point-in-triangle predicates ``:155-187``). This module rebuilds
that precision from float32 with error-free transformations (Knuth two-sum, Dekker
two-product with Veltkamp splitting — no FMA needed), giving ~48 effective
mantissa bits: enough to reproduce the reference's float64 sign decisions for
any input that isn't within ~2^-45 of a tie, with exact zeros preserved for
the exactly-representable cases the SOS tie-break exists for.

A df number is a pair (hi, lo) with hi = fl(hi + lo) and |lo| <= ulp(hi)/2.
All functions broadcast elementwise over arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# 2^12 + 1 Veltkamp split constant for float32. NumPy (not jnp) so importing
# this module never initializes a JAX backend — jax.distributed.initialize
# must stay callable after `import sdfgenfast` (parallel/multihost.py).
_SPLIT = np.float32(4097.0)


class DF(NamedTuple):
    hi: jnp.ndarray
    lo: jnp.ndarray


def df(hi, lo=None) -> DF:
    hi = jnp.asarray(hi, jnp.float32)
    if lo is None:
        lo = jnp.zeros_like(hi)
    return DF(hi, jnp.asarray(lo, jnp.float32))


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s = fl(a+b), s + e = a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp split of a float32 into high/low 12-bit halves."""
    c = _SPLIT * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    return a_hi, a_lo


def two_prod(a, b):
    """Error-free a * b via Dekker's algorithm: (p, e) with p + e = a*b exactly."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def div(x: DF, y: DF) -> DF:
    """df / df via one Newton-corrected long division (accurate to ~2 ulps of df)."""
    q1 = x.hi / y.hi
    # r = x - q1 * y, computed in df
    p = mul(df(q1), y)
    r = sub(x, p)
    q2 = (r.hi + r.lo) / y.hi
    hi, lo = fast_two_sum(q1, q2)
    return DF(hi, lo)


def add_f32(x: DF, b) -> DF:
    s, e = two_sum(x.hi, jnp.asarray(b, jnp.float32))
    e = e + x.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def sub_f32(x: DF, b) -> DF:
    return add_f32(x, -jnp.asarray(b, jnp.float32))


def to_f32(x: DF) -> jnp.ndarray:
    return x.hi + x.lo


def sign(x: DF) -> jnp.ndarray:
    """-1, 0, +1 of the df value. hi dominates; hi==0 defers to lo."""
    s_hi = jnp.sign(x.hi)
    return jnp.where(s_hi != 0, s_hi, jnp.sign(x.lo)).astype(jnp.int32)


def lt(x: DF, y: DF) -> jnp.ndarray:
    d = sub(x, y)
    return sign(d) < 0


def le(x: DF, y: DF) -> jnp.ndarray:
    d = sub(x, y)
    return sign(d) <= 0
