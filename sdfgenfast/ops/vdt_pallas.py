"""Pallas (Triton) kernel for 26-offset Jacobi VDT rounds.

The jnp reference round (``ops/vdt._jacobi_round``) pads the full (5, ni,
nj, nk) state and re-reads it once per offset: ~26 full passes over device
memory per round. This kernel reads each cell's own state once and its 26
donors through masked loads that mostly hit L1/L2 (a donor is read by its
27 neighbours' programs), evaluates all candidates in registers, and writes
the new state once.

Equality with the jnp round: candidate visit order, the `_dist2` operation
order and the strict `<` merge are identical; donors outside the valid
domain are masked to +inf here where the jnp round reads FAR-padded cells
(squared distance ~2.7e37) — both strictly lose every comparison. Only FMA
contraction of `_dist2` may differ between the two compilers (ulps of d2).

One program per (i, j-block, k-block); loads and stores are masked at the
ragged j/k edges and at the domain boundary, so any grid shape and stride
is accepted without padding. Stride and level scale are runtime scalars:
a phase of rounds is one `fori_loop` around ONE kernel, so a pyramid level
compiles one kernel, not one per stride.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .vdt import FAR, _OFFSETS26, _dist2

__all__ = ["pallas_round_phase", "block_shape"]

_BLOCK_CELLS = 512  # cells per program (j x k block)
_INF = np.float32(np.inf)


def block_shape(nk: int):
    """(j, k) block of `_BLOCK_CELLS` cells: the power-of-two k extent
    (16..128) that pads nk least (ties: the wider one), j the rest."""
    bk = min((128, 64, 32, 16), key=lambda b: (-(-nk // b) * b, -b))
    return _BLOCK_CELLS // bk, bk


def _round_kernel(dx_ref, off_ref, ss_ref, state_ref, out_ref, *, ni, nj, nk,
                  bj, bk):
    s = ss_ref[0]  # stride
    scale = ss_ref[1]
    i = pl.program_id(0)
    j = pl.program_id(1) * bj + jax.lax.broadcasted_iota(jnp.int32, (bj, 1), 0)
    k = pl.program_id(2) * bk + jax.lax.broadcasted_iota(jnp.int32, (1, bk), 1)
    dxf = dx_ref[0]
    inb = (j < nj) & (k < nk)

    # cell world positions (pyramid level `scale`): f32(index * scale) * dx.
    # off_ref shifts ARRAY-local indices to GLOBAL level indices for the
    # position math only (sharded halo-extended blocks; zeros single-device)
    # — the validity mask stays array-local, since the extended block IS the
    # donor domain there (matching vdt._halo_round).
    px = ((i + off_ref[0]) * scale).astype(jnp.float32) * dxf
    py = ((j + off_ref[1]) * scale).astype(jnp.float32) * dxf
    pz = ((k + off_ref[2]) * scale).astype(jnp.float32) * dxf

    def load(ch, ii, jj, kk, mask):
        return plgpu.load(state_ref.at[ch, ii, jj, kk], mask=mask, other=FAR)

    best = [load(ch, i, j, k, inb) for ch in range(5)]
    for oi, oj, ok in _OFFSETS26.tolist():
        gi, gj, gk = i + oi * s, j + oj * s, k + ok * s
        valid = (inb & (gi >= 0) & (gi < ni) & (gj >= 0) & (gj < nj)
                 & (gk >= 0) & (gk < nk))
        cand = [load(ch, gi, gj, gk, valid) for ch in range(4)]
        cd2 = jnp.where(valid, _dist2(px, py, pz, *cand[:3]), _INF)
        better = cd2 < best[4]
        best = [jnp.where(better, v, b) for v, b in zip(cand + [cd2], best)]

    for ch in range(5):
        plgpu.store(out_ref.at[ch, i, j, k], best[ch], mask=inb)


def _call_round(state, dx, off, stride_scale, interpret: bool):
    _, ni, nj, nk = state.shape
    bj, bk = block_shape(nk)
    return pl.pallas_call(
        partial(_round_kernel, ni=ni, nj=nj, nk=nk, bj=bj, bk=bk),
        grid=(ni, pl.cdiv(nj, bj), pl.cdiv(nk, bk)),
        out_shape=jax.ShapeDtypeStruct(state.shape, jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="sdf_vdt_round",
    )(dx, off, stride_scale, state)


def pallas_round_phase(state, dx, strides, scale: int = 1,
                       interpret: bool = False, pos_offset=None):
    """Run a sequence of Jacobi rounds through the kernel.

    `pos_offset` (3,) int32 shifts array-local indices to global LEVEL
    indices for the position math (sharded halo-extended blocks); None
    means zeros (single-device).
    """
    off = (jnp.zeros((3,), jnp.int32) if pos_offset is None
           else jnp.asarray(pos_offset, jnp.int32).reshape(3))
    dxv = jnp.asarray(dx, jnp.float32).reshape(1)
    ss = jnp.asarray([(s, scale) for s in strides], jnp.int32)
    return jax.lax.fori_loop(
        0, len(strides),
        lambda r, st: _call_round(st, dxv, off, ss[r], interpret), state)
