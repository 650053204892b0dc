"""Pallas VDT round kernel vs the jnp reference round, and both vs brute force.

CI runs on the forced-CPU backend, so the kernel is exercised in Pallas
interpret mode here — that validates the kernel's index/mask/merge logic
(masked donor loads at the domain boundary, ragged j/k blocks) against the
jnp round. The payload channels (cp x/y/z + tid bits) must match
BIT-FOR-BIT — any indexing or masking bug garbles them outright; the d2
channel is allowed 2 ulp because the kernel may contract the three squared
differences with a different FMA pattern than XLA uses for the jnp round.
The compiled kernel is checked at 512^3 on the GPU by chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdfgenfast.ops import vdt as V
from sdfgenfast.ops.vdt_pallas import pallas_round_phase


def _assert_round_equal(a, b):
    """Interpret-mode equality: d2 within ulp everywhere; payload channels
    (cp x/y/z + tid bits) identical except where the ulp-perturbed d2
    flipped a strict-`<` near-tie (then both donors' distances must agree
    to ulp — a different-but-equally-close donor, not an indexing bug)."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a[4], b[4], rtol=5e-7)
    differs = (a[:4] != b[:4]).any(axis=0)
    if differs.any():
        # near-ties only, and rare
        assert differs.mean() < 1e-3, f"{differs.sum()} payload mismatches"
        np.testing.assert_allclose(a[4][differs], b[4][differs], rtol=5e-7)


def _random_state(rng, ni, nj, nk, dx, n_seed=4000):
    state = np.full((5, ni, nj, nk), V.FAR, np.float32)
    ii = rng.integers(0, ni, n_seed)
    jj = rng.integers(0, nj, n_seed)
    kk = rng.integers(0, nk, n_seed)
    cp = (rng.normal(size=(3, n_seed)).astype(np.float32) * 0.3
          + np.stack([ii, jj, kk]).astype(np.float32) * dx)
    state[0, ii, jj, kk] = cp[0]
    state[1, ii, jj, kk] = cp[1]
    state[2, ii, jj, kk] = cp[2]
    tidbits = jax.lax.bitcast_convert_type(
        jnp.asarray(rng.integers(0, 1 << 24, n_seed), jnp.int32), jnp.float32
    )
    state[3, ii, jj, kk] = np.asarray(tidbits)
    px, py, pz = V._level_pos_axes((ni, nj, nk), dx, 1)
    st = jnp.asarray(state)
    return st.at[4].set(V._dist2(px, py, pz, st[0], st[1], st[2]))


def _jnp_phase(state, dx, strides, scale=1):
    pos = V._level_pos_axes(state.shape[1:], dx, scale)
    offs = jnp.asarray(V._OFFSETS26)
    for s in strides:
        state = V._jacobi_round(state, *pos, s, offs)
    return state


@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_round_bit_equal_interpret(stride):
    rng = np.random.default_rng(stride)
    dx = np.float32(0.02)
    st = _random_state(rng, 48, 48, 128, dx)
    a = _jnp_phase(st, dx, (stride,))
    b = pallas_round_phase(st, dx, (stride,), interpret=True)
    _assert_round_equal(a, b)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_round_ragged_dims_bit_equal(stride):
    """nj/nk not multiples of the block/lane sizes: pad+crop must be exact.

    Single rounds only: across multiple rounds a near-tie donor flip from
    interpret-mode FMA noise cascades into legitimately-different (equally
    valid) d2 values, which the per-round ulp assert can't bound."""
    rng = np.random.default_rng(7)
    dx = np.float32(0.02)
    st = _random_state(rng, 40, 41, 75, dx, n_seed=2500)
    a = _jnp_phase(st, dx, (stride,))
    b = pallas_round_phase(st, dx, (stride,), interpret=True)
    _assert_round_equal(a, b)


def test_phase_scale_positions():
    """Pyramid-level scale: positions are f32(index*scale)*dx in both."""
    rng = np.random.default_rng(11)
    dx = np.float32(0.01)
    st = _random_state(rng, 32, 32, 128, dx, n_seed=1000)
    a = _jnp_phase(st, dx, (2, 1), scale=4)
    b = pallas_round_phase(st, dx, (2, 1), scale=4, interpret=True)
    _assert_round_equal(a, b)


def test_unsupported_shapes_fall_back():
    """Tiny levels (smaller than one block on every axis) run through the
    kernel too — no shape-based fallback is needed on the Triton route."""
    rng = np.random.default_rng(3)
    dx = np.float32(0.02)
    st = _random_state(rng, 16, 16, 16, dx, n_seed=200)
    a = _jnp_phase(st, dx, (1,))
    b = pallas_round_phase(st, dx, (1,), interpret=True)
    _assert_round_equal(a, b)


def _round_bruteforce(state, dx, stride):
    """One Jacobi round in NumPy: every cell keeps the first strictly closer
    of its 26 stride-s donors (the round-start state), in offset order."""
    st = np.asarray(state)
    _, ni, nj, nk = st.shape
    px, py, pz = (np.asarray(a) for a in V._level_pos_axes((ni, nj, nk), dx, 1))
    best = st.copy()
    for oi, oj, ok in V._OFFSETS26.tolist():
        src = np.full_like(st, V.FAR)
        dst = [slice(max(0, -o * stride), n - max(0, o * stride))
               for o, n in zip((oi, oj, ok), (ni, nj, nk))]
        srcs = [slice(max(0, o * stride), n - max(0, -o * stride))
                for o, n in zip((oi, oj, ok), (ni, nj, nk))]
        src[(slice(None), *dst)] = st[(slice(None), *srcs)]
        cd2 = ((px - src[0]) * (px - src[0]) + (py - src[1]) * (py - src[1])
               + (pz - src[2]) * (pz - src[2]))
        better = cd2 < best[4]
        best[:4] = np.where(better[None], src[:4], best[:4])
        best[4] = np.where(better, cd2, best[4])
    return best


@pytest.mark.parametrize("shape", [(24, 20, 36), (48, 41, 75)])
@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_plain_round_matches_bruteforce(stride, shape):
    rng = np.random.default_rng(stride)
    dx = np.float32(0.02)
    st = _random_state(rng, *shape, dx, n_seed=600)
    a = _jnp_phase(st, dx, (stride,))
    _assert_round_equal(a, _round_bruteforce(st, dx, stride))
