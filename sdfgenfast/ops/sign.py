"""Inside/outside sign via x-ray intersection parity.

The reference casts one ray per (j, k) grid line along +x: for each triangle
it rasterizes the (j, k) bbox, tests point-in-triangle in 2D with an
SOS-robust orientation predicate (float64), accumulates a count at
i = ceil(fi) (clamped), and finally flips the sign wherever the prefix sum of
counts along i is odd (``cpu_lib/makelevelset3.cpp:222-235, 295-303``; SOS
predicates ``:155-187``; CUDA variant with atomicAdd + per-column serial scan
``gpu_lib/makelevelset3_gpu.cu:440-459, 573-589``).

Design:
  - triangles are binned to 2D (j, k) tiles on the host (static shapes);
  - the predicates run on device in double-float (ops/df.py) to reproduce the
    reference's float64 decisions in float32 arithmetic;
  - the prefix-parity along i needs NO scatter and NO serial scan: cell
    (i, j, k) is inside iff an odd number of candidate intersections on the
    (j, k) ray satisfy ceil(fi) <= i, i.e.
        parity(i, j, k) = XOR_c [ inside_c & (bin_c <= i) ],
    which is a broadcast compare-and-reduce, and the reference's clamping
    (bin < 0 counted at 0; bin >= ni dropped, makelevelset3.cpp:230-233) falls
    out automatically.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import GridSpec
from . import df as dfm
from .band import _round_up, triangle_grid_coords

__all__ = ["SignBinning", "bin_triangles_2d", "parity_field"]

DEFAULT_TILE_2D = (16, 16)


@dataclasses.dataclass(frozen=True)
class SignBinning:
    """2D (j, k)-tile binning for the sign pass (host-side NumPy).

    f_hi/f_lo: (M, 3, 3) float32 double-float split of the float64 per-vertex
    grid coordinates (fi, fj, fk), so device predicates see full precision.
    """

    tile_shape: Tuple[int, int]
    tiles_dim: Tuple[int, int]
    active_ids: np.ndarray  # (A,) linear tile index (j-major: tj*ntk + tk)
    cand: np.ndarray  # (A, K)
    cand_valid: np.ndarray  # (A, K)
    f_hi: np.ndarray
    f_lo: np.ndarray


def split_f64_to_df(x: np.ndarray):
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def bin_triangles_2d(
    verts: np.ndarray,
    tris: np.ndarray,
    grid: GridSpec,
    tile_shape: Tuple[int, int] = DEFAULT_TILE_2D,
    pad_k_to: int = 8,
) -> SignBinning:
    ni, nj, nk = grid.shape
    tj, tk = tile_shape
    ntj, ntk = _round_up(nj, tj) // tj, _round_up(nk, tk) // tk

    f = triangle_grid_coords(verts, tris, grid)  # (M, 3, 3) float64
    f_hi, f_lo = split_f64_to_df(f)

    # Rasterized (j, k) window: j0 = clamp(ceil(min fj), 0, nj-1),
    # j1 = clamp(floor(max fj), 0, nj-1)   (makelevelset3.cpp:222-225).
    fj = f[:, :, 1]
    fk = f[:, :, 2]
    j0 = np.clip(np.ceil(fj.min(1)).astype(np.int64), 0, nj - 1)
    j1 = np.clip(np.floor(fj.max(1)).astype(np.int64), 0, nj - 1)
    k0 = np.clip(np.ceil(fk.min(1)).astype(np.int64), 0, nk - 1)
    k1 = np.clip(np.floor(fk.max(1)).astype(np.int64), 0, nk - 1)
    # NOTE: when the whole bbox lies left of 0 or right of n-1, clamping makes
    # the window [0, 0] / [n-1, n-1] — nonempty, exactly like the reference.
    # The in/out test then rejects those cells, so behavior matches.
    nonempty = (j1 >= j0) & (k1 >= k0)

    tlo_j = j0 // tj
    thi_j = j1 // tj
    tlo_k = k0 // tk
    thi_k = k1 // tk
    span_j = np.where(nonempty, thi_j - tlo_j + 1, 0)
    span_k = np.where(nonempty, thi_k - tlo_k + 1, 0)
    counts = span_j * span_k
    total = int(counts.sum())

    if total == 0:
        return SignBinning(
            tile_shape, (ntj, ntk),
            np.zeros((0,), np.int32),
            np.zeros((0, pad_k_to), np.int32),
            np.zeros((0, pad_k_to), bool),
            f_hi, f_lo,
        )

    tri_ids = np.repeat(np.arange(len(tris), dtype=np.int64), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
    sk = span_k[tri_ids]
    dk = rank % sk
    dj = rank // sk
    tile_j = tlo_j[tri_ids] + dj
    tile_k = tlo_k[tri_ids] + dk
    tile_lin = tile_j * ntk + tile_k

    order = np.argsort(tile_lin, kind="stable")
    tile_lin = tile_lin[order]
    tri_ids = tri_ids[order]
    uniq, starts, per_tile = np.unique(tile_lin, return_index=True, return_counts=True)
    K = _round_up(max(int(per_tile.max()), 1), pad_k_to)
    A = len(uniq)
    cand = np.zeros((A, K), np.int32)
    valid = np.zeros((A, K), bool)
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, per_tile)
    row = np.repeat(np.arange(A, dtype=np.int64), per_tile)
    cand[row, pos] = tri_ids.astype(np.int32)
    valid[row, pos] = True
    return SignBinning(tile_shape, (ntj, ntk), uniq.astype(np.int32), cand, valid, f_hi, f_lo)


# ---------------------------------------------------------------------------
# Device predicates (double-float)
# ---------------------------------------------------------------------------


def _orientation_df(x1: dfm.DF, y1: dfm.DF, x2: dfm.DF, y2: dfm.DF):
    """SOS-determined sign of twice the signed area of (0,0)-(x1,y1)-(x2,y2),
    plus the area itself — reproducing makelevelset3.cpp:155-165."""
    area = dfm.sub(dfm.mul(y1, x2), dfm.mul(x1, y2))
    s = dfm.sign(area)
    # SOS tie-break chain for exact zero: y2>y1 -> +1; y2<y1 -> -1;
    # x1>x2 -> +1; x1<x2 -> -1; else 0.
    sy = dfm.sign(dfm.sub(y2, y1))
    sx = dfm.sign(dfm.sub(x1, x2))
    tie = jnp.where(sy != 0, sy, sx)
    return jnp.where(s != 0, s, tie).astype(jnp.int32), area


def _point_in_triangle_2d_df(y0, z0, p, q, r):
    """Robust 2D point-in-triangle at integer point (y0, z0) against df vertex
    coordinates p, q, r (each a pair-of-DF (y, z)). Returns (inside, a, b, c)
    with normalized barycentric DFs — mirrors makelevelset3.cpp:169-187."""
    py, pz = p
    qy, qz = q
    ry, rz = r
    x1 = dfm.sub_f32(py, y0)
    y1 = dfm.sub_f32(pz, z0)
    x2 = dfm.sub_f32(qy, y0)
    y2 = dfm.sub_f32(qz, z0)
    x3 = dfm.sub_f32(ry, y0)
    y3 = dfm.sub_f32(rz, z0)
    signa, a = _orientation_df(x2, y2, x3, y3)
    signb, b = _orientation_df(x3, y3, x1, y1)
    signc, c = _orientation_df(x1, y1, x2, y2)
    inside = (signa != 0) & (signb == signa) & (signc == signa)
    total = dfm.add(dfm.add(a, b), c)
    # The reference asserts sum != 0 whenever inside holds (:182); guard the
    # not-inside lanes so the division stays finite.
    tz = dfm.sign(total) == 0
    safe_total = dfm.DF(
        jnp.where(tz, jnp.float32(1), total.hi),
        jnp.where(tz, jnp.float32(0), total.lo),
    )
    a_n = dfm.div(a, safe_total)
    b_n = dfm.div(b, safe_total)
    c_n = dfm.div(c, safe_total)
    return inside, a_n, b_n, c_n


def _df_ceil(x: dfm.DF) -> jnp.ndarray:
    """Exact ceil of a df value, as int32 (range limited to grid sizes)."""
    c = jnp.ceil(x.hi)
    # correct by comparing df(x) against the integer candidates c-1, c, exactly
    d_c = dfm.sub_f32(x, c)
    too_low = dfm.sign(d_c) > 0  # x > c  -> ceil is c+1
    d_cm1 = dfm.sub_f32(x, c - 1.0)
    too_high = dfm.sign(d_cm1) <= 0  # x <= c-1 -> ceil is c-1
    c = jnp.where(too_low, c + 1.0, jnp.where(too_high, c - 1.0, c))
    return c.astype(jnp.int32)


@partial(
    jax.jit,
    static_argnames=("tile_shape", "tiles_dim", "grid_shape", "chunk"),
)
def parity_field(
    f_hi: jnp.ndarray,  # (M, 3, 3) f32
    f_lo: jnp.ndarray,
    active_ids: jnp.ndarray,  # (A,)
    cand: jnp.ndarray,  # (A, K)
    cand_valid: jnp.ndarray,
    tile_shape: Tuple[int, int],
    tiles_dim: Tuple[int, int],
    grid_shape: Tuple[int, int, int],
    chunk: int = 64,
    jk_offset=None,  # (2,) int32 global (j, k) of local cell (0, 0); None = zeros
):
    """Dense (ni, nj, nk) bool parity (True = inside) for the whole grid.

    `jk_offset` shifts the integer ray coordinates to GLOBAL (j, k) for
    sharded blocks so the predicates see the same points as the reference.
    """
    ni, nj, nk = grid_shape
    tj, tk = tile_shape
    ntj, ntk = tiles_dim
    C = tj * tk
    T = ntj * ntk
    A = active_ids.shape[0]

    oj = jnp.arange(tj, dtype=jnp.int32).reshape(tj, 1)
    ok = jnp.arange(tk, dtype=jnp.int32).reshape(1, tk)
    local_j = jnp.broadcast_to(oj, (tj, tk)).reshape(-1)  # (C,)
    local_k = jnp.broadcast_to(ok, (tj, tk)).reshape(-1)

    i_iota = jnp.arange(ni, dtype=jnp.int32)  # (ni,)

    if jk_offset is None:
        jk_offset = jnp.zeros((2,), jnp.int32)

    def tile_chunk(args):
        ids, cd, vd = args  # (B,), (B,K), (B,K)
        tjj = ids // ntk
        tkk = ids % ntk
        jj = (tjj[:, None] * tj + local_j[None, :] + jk_offset[0]).astype(jnp.float32)
        kk = (tkk[:, None] * tk + local_k[None, :] + jk_offset[1]).astype(jnp.float32)

        fh = f_hi[cd]  # (B, K, 3verts, 3axes)
        fl = f_lo[cd]

        def axis_df(vert, axis):
            return dfm.DF(fh[:, None, :, vert, axis], fl[:, None, :, vert, axis])

        y0 = jj[:, :, None]  # (B, C, 1)
        z0 = kk[:, :, None]
        p = (axis_df(0, 1), axis_df(0, 2))
        q = (axis_df(1, 1), axis_df(1, 2))
        r = (axis_df(2, 1), axis_df(2, 2))
        inside, a, b, c = _point_in_triangle_2d_df(y0, z0, p, q, r)  # (B, C, K)

        # fi = a*fip + b*fiq + c*fir in df  (makelevelset3.cpp:229)
        fip = dfm.DF(fh[:, None, :, 0, 0], fl[:, None, :, 0, 0])
        fiq = dfm.DF(fh[:, None, :, 1, 0], fl[:, None, :, 1, 0])
        fir = dfm.DF(fh[:, None, :, 2, 0], fl[:, None, :, 2, 0])
        fi = dfm.add(dfm.add(dfm.mul(a, fip), dfm.mul(b, fiq)), dfm.mul(c, fir))
        bins = _df_ceil(fi)  # (B, C, K) int32; (i_interval-1, i_interval]

        hit = inside & vd[:, None, :]
        bins = jnp.where(hit, bins, jnp.int32(ni + 1))  # never counted

        # parity over i: XOR_c [ bins <= i ]
        cnt = jnp.sum(
            (bins[:, :, :, None] <= i_iota[None, None, None, :]).astype(jnp.int32),
            axis=2,
        )  # (B, C, ni)
        return (cnt & 1).astype(jnp.bool_)

    if A == 0:
        par_rows = jnp.zeros((0, C, ni), jnp.bool_)
    else:
        B = min(chunk, A)
        A_pad = _round_up(A, B)
        pad = A_pad - A
        # pad with the out-of-range drop sentinel: id-0 padding would make
        # the final scatter write a duplicate (all-false) row onto tile 0,
        # and XLA's duplicate-index set order is implementation-defined
        ids_p = jnp.pad(active_ids, (0, pad), constant_values=T)
        cand_p = jnp.pad(cand, ((0, pad), (0, 0)))
        valid_p = jnp.pad(cand_valid, ((0, pad), (0, 0)))
        par_rows = jax.lax.map(
            tile_chunk,
            (
                ids_p.reshape(-1, B),
                cand_p.reshape(-1, B, cand.shape[1]),
                valid_p.reshape(-1, B, cand.shape[1]),
            ),
        )
        par_rows = par_rows.reshape(A_pad, C, ni)[:A]

    parity_tiles = (
        jnp.zeros((T, C, ni), jnp.bool_).at[active_ids].set(par_rows, mode="drop")
    )
    x = parity_tiles.reshape(ntj, ntk, tj, tk, ni)
    x = x.transpose(4, 0, 2, 1, 3).reshape(ni, ntj * tj, ntk * tk)
    return x[:, :nj, :nk]
