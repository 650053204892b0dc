"""Per-tile candidate evaluation: batched affine forms + difference form.

Replaces the ``band_distance_field`` inner loop (a broadcast
``point_triangle_distance_sq_soa`` at ~130 ops per (cell, candidate) pair,
``ops/band.py:219-249``) for both the narrow band and the far field.
Reference semantics preserved: exact point->triangle distance with the same
case analysis and clamping as ``cpu_lib/makelevelset3.cpp:21-70``, min over
the tile's candidate list with lowest-id tie-break (first-wins,
``makelevelset3.cpp:215-218``).

Reformulation (the ``ops/dense.py`` playbook generalized to per-tile
candidate lists); this XLA form is the CPU route and the reference the GPU
band kernel (ops/band_pallas.py) is tested against:

  * Every p-affine quantity of the distance evaluation (plane distance h,
    barycentric weights w23/w31, per-edge parameters s) is precomputed per
    TRIANGLE as an affine form ``e . p + e0`` in grid-local coordinates and
    evaluated for all (cell, candidate) pairs of a tile chunk with ONE
    batched (C, 4) @ (4, 6K) matmul instead of per-pair dot products
    (Precision.HIGHEST: no reduced-precision matmul passes).
  * Edge distances keep the reference's cancellation-free difference form
    ``dd = (p - x2) - s*(x1 - x2)`` componentwise (broadcast over (C, K)),
    so accuracy matches the reference to ulps — the expanded
    ``|u|^2 - 2 s u.w + s^2 |w|^2`` form would lose ~O(|p|^2 eps) to
    cancellation near the surface.
  * Candidate gathers happen once per (tile, candidate) pair (a row gather
    of the 40-float coefficient table), NOT per cell.
  * Invalid candidate slots index a sentinel row (degenerate flag + huge
    b/c translation) so masking needs no extra lanes.
  * The winning triangle id is reduced without a trailing-axis gather:
    min-over-K of ``where(d2 == d2min, id, INT_MAX)`` — lowest id among
    ties, matching first-wins for the band's ascending-id candidate lists.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["tri_affine_table", "tile_candidate_rows", "scatter_rows",
           "scatter_untile", "tile_candidate_field", "closest_point_rows"]

_NT = 40  # rows per triangle in the affine table

_INT_BIG = np.int32(2**31 - 1)


def tri_affine_table(tri_local: jnp.ndarray) -> jnp.ndarray:
    """(M, 3, 3) GRID-LOCAL vertices -> (M+1, 40) f32 affine table.

    Column layout (p is the grid-local cell position):
      0:3    n         (unit normal; h = n.p + h0 is the signed plane dist)
      3      h0
      4:7    g23       (w23 = g23.p + g23c — barycentric weight on vertex a,
                        invdet*(m23*pa - d*pb), makelevelset3.cpp:55-57)
      7      g23c
      8:11   g31
      11     g31c
      12:15  e_ab      (s_ab = e_ab.p + e0_ab, the reference's
                        dot(x2-x0, x2-x1)/mag2, makelevelset3.cpp:24)
      15     e0_ab
      16:19  e_ac
      19     e0_ac
      20:23  e_bc
      23     e0_bc
      24:27  b         (x2 endpoint of edge ab)
      27:30  c         (x2 endpoint of edges ac, bc)
      30:33  w_ab = a-b (x1-x2 of edge ab: dd = (p-x2) - s*(x1-x2))
      33:36  w_ac = a-c
      36:39  w_bc = b-c
      39     degenerate flag (cr2 <= 1e-30 -> 1.0, see ops/dense.py)

    Row M is the SENTINEL for invalid candidate slots: degenerate (so the
    inside branch never fires) with b = c = 3e18 (edge distance ~2.7e37,
    never wins, id never emitted).
    """
    a = tri_local[:, 0, :]
    b = tri_local[:, 1, :]
    c = tri_local[:, 2, :]

    def edge(x1, x2):
        w = x1 - x2
        m2 = jnp.sum(w * w, axis=-1)
        inv = 1.0 / jnp.maximum(m2, jnp.float32(1e-30))
        e = w * inv[:, None]
        e0 = -jnp.sum(x2 * w, axis=-1) * inv
        return w, e, e0

    w_ab, e_ab, e0_ab = edge(a, b)
    w_ac, e_ac, e0_ac = edge(a, c)
    w_bc, e_bc, e0_bc = edge(b, c)

    x13 = a - c
    x23 = b - c
    m13 = jnp.sum(x13 * x13, axis=-1)
    m23 = jnp.sum(x23 * x23, axis=-1)
    d = jnp.sum(x13 * x23, axis=-1)
    invdet = 1.0 / jnp.maximum(m13 * m23 - d * d, jnp.float32(1e-30))
    g23 = invdet[:, None] * (m23[:, None] * x13 - d[:, None] * x23)
    g23c = -jnp.sum(g23 * c, axis=-1)
    g31 = invdet[:, None] * (m13[:, None] * x23 - d[:, None] * x13)
    g31c = -jnp.sum(g31 * c, axis=-1)

    cr = jnp.cross(x13, x23)
    cr2 = jnp.sum(cr * cr, axis=-1)
    n = cr / jnp.sqrt(jnp.maximum(cr2, jnp.float32(1e-37)))[:, None]
    h0 = -jnp.sum(n * c, axis=-1)
    degen = jnp.where(cr2 <= jnp.float32(1e-30), 1.0, 0.0).astype(jnp.float32)

    tbl = jnp.concatenate(
        [
            n, h0[:, None],
            g23, g23c[:, None], g31, g31c[:, None],
            e_ab, e0_ab[:, None], e_ac, e0_ac[:, None], e_bc, e0_bc[:, None],
            b, c, w_ab, w_ac, w_bc,
            degen[:, None],
        ],
        axis=1,
    )  # (M, 40)

    sentinel = jnp.zeros((1, _NT), jnp.float32)
    sentinel = sentinel.at[0, 24:30].set(3e18)  # b, c far away
    sentinel = sentinel.at[0, _NT - 1].set(1.0)  # degenerate
    return jnp.concatenate([tbl, sentinel], axis=0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_local_offsets(tile_shape):
    ti, tj, tk = tile_shape
    oi = jnp.arange(ti, dtype=jnp.int32).reshape(ti, 1, 1)
    oj = jnp.arange(tj, dtype=jnp.int32).reshape(1, tj, 1)
    ok = jnp.arange(tk, dtype=jnp.int32).reshape(1, 1, tk)
    off = jnp.stack(
        [
            jnp.broadcast_to(oi, tile_shape),
            jnp.broadcast_to(oj, tile_shape),
            jnp.broadcast_to(ok, tile_shape),
        ],
        axis=-1,
    )
    return off.reshape(-1, 3)  # (C, 3)


def tile_candidate_rows(
    tri_verts: jnp.ndarray,  # (M, 3, 3) f32 WORLD coordinates
    active_ids: jnp.ndarray,  # (A,) int32 linear tile ids (sentinel = T -> dropped)
    cand: jnp.ndarray,  # (A, K) int32 candidate triangle ids
    cand_valid: jnp.ndarray,  # (A, K) bool
    origin: jnp.ndarray,  # (3,) f32 global grid origin
    dx: jnp.ndarray,  # () f32
    tile_shape: Tuple[int, int, int],
    tiles_dim: Tuple[int, int, int],
    grid_shape: Tuple[int, int, int],
    chunk: int = 128,
    ijk_offset=None,  # (3,) int32 global index of local cell (0,0,0)
    upper_override=None,  # () f32
    precision=jax.lax.Precision.HIGHEST,
    tbl=None,  # optional (A, K, >=40) PRE-MATERIALIZED affine blocks:
    #          skips the per-pair table gather entirely
):
    """(A, C) per-active-tile (phi, tid) rows — the evaluation core.

    Cell world positions are f32(i_global)*dx in grid-local coordinates
    (the table is built from origin-subtracted vertices), the same scheme
    the dense Pallas kernel uses.
    """
    ni, nj, nk = grid_shape
    nti, ntj, ntk = tiles_dim
    ti, tj, tk = tile_shape
    C = ti * tj * tk
    A = active_ids.shape[0]
    K = cand.shape[1]
    M = tri_verts.shape[0]

    if upper_override is None:
        upper = (jnp.float32(ni + nj + nk)) * dx  # makelevelset3.cpp:197
    else:
        upper = upper_override
    if ijk_offset is None:
        ijk_offset = jnp.zeros((3,), jnp.int32)

    if tbl is None:
        table = tri_affine_table(tri_verts - origin.astype(tri_verts.dtype))
        cand_idx = jnp.where(cand_valid, cand, M)  # sentinel row for invalid
    else:
        table = None
        cand_idx = jnp.where(cand_valid, cand, _INT_BIG - 1)

    local = _tile_local_offsets(tile_shape)  # (C, 3)

    def tile_chunk(args):
        if table is None:
            ids, cd, tbl = args  # (B,), (B, K), (B, K, >=40)
        else:
            ids, cd = args
            tbl = jnp.take(table, cd, axis=0)  # (B, K, 40) — one row gather/pair

        tile_k = ids % ntk
        tile_j = (ids // ntk) % ntj
        tile_i = ids // (ntk * ntj)
        base = jnp.stack([tile_i * ti, tile_j * tj, tile_k * tk], axis=-1)  # (B,3)
        cell_idx = base[:, None, :] + local[None, :, :] + ijk_offset[None, None, :]
        p = cell_idx.astype(jnp.float32) * dx  # (B, C, 3) grid-local positions

        # all six affine forms for all candidates: one batched contraction
        ones = jnp.ones(p.shape[:2] + (1,), jnp.float32)
        l = jnp.concatenate([p, ones], axis=-1)  # (B, C, 4)
        coefs = tbl[:, :, 0:24].reshape(-1, K * 6, 4)  # (B, 6K, 4)
        forms = jax.lax.dot_general(
            l, coefs,
            (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=precision,
        ).reshape(-1, C, K, 6)  # (B, C, K, 6): h, w23, w31, s_ab, s_ac, s_bc

        h = forms[..., 0]
        w23 = forms[..., 1]
        w31 = forms[..., 2]
        w12 = 1.0 - w23 - w31
        degen = tbl[:, None, :, 39]  # (B, 1, K)
        inside = (jnp.minimum(jnp.minimum(w23, w31), w12) >= 0.0) & (degen < 0.5)
        din = h * h

        px = p[:, :, None, 0]  # (B, C, 1)
        py = p[:, :, None, 1]
        pz = p[:, :, None, 2]

        def edge_d2(s_raw, x2_0, w_0):
            s = jnp.clip(s_raw, 0.0, 1.0)
            ddx = (px - tbl[:, None, :, x2_0]) - s * tbl[:, None, :, w_0]
            ddy = (py - tbl[:, None, :, x2_0 + 1]) - s * tbl[:, None, :, w_0 + 1]
            ddz = (pz - tbl[:, None, :, x2_0 + 2]) - s * tbl[:, None, :, w_0 + 2]
            return ddx * ddx + ddy * ddy + ddz * ddz

        d_ab = edge_d2(forms[..., 3], 24, 30)
        d_ac = edge_d2(forms[..., 4], 27, 33)
        d_bc = edge_d2(forms[..., 5], 27, 36)
        # min over 3 edges == min over the region's 2 edges (ops/dense.py)
        d_edge = jnp.minimum(d_ab, jnp.minimum(d_ac, d_bc))
        d2 = jnp.where(inside, din, d_edge)  # (B, C, K)

        dmin2 = jnp.min(d2, axis=-1)
        # winning id without a trailing-axis gather: lowest id among ties
        # (== the reference's first-wins for ascending-id candidate lists)
        tid = jnp.min(
            jnp.where(d2 <= dmin2[..., None], cd[:, None, :], _INT_BIG), axis=-1
        ).astype(jnp.int32)

        has = dmin2 < upper * upper
        phi = jnp.where(has, jnp.sqrt(dmin2), upper)
        tid = jnp.where(has, tid, -1)
        return phi.astype(jnp.float32), tid

    if A == 0:
        return jnp.zeros((0, C), jnp.float32), jnp.zeros((0, C), jnp.int32)
    B = min(chunk, A)
    A_pad = _round_up(A, B)
    pad = A_pad - A
    ids_p = jnp.pad(active_ids, (0, pad))
    cand_p = jnp.pad(cand_idx, ((0, pad), (0, 0)),
                     constant_values=M if table is not None else _INT_BIG - 1)
    if tbl is not None:
        tbl_p = jnp.pad(tbl[..., :40], ((0, pad), (0, 0), (0, 0)))
        # padding rows: sentinel pattern so they never win
        if pad:
            tbl_p = tbl_p.at[A:, :, 24:30].set(3e18)
            tbl_p = tbl_p.at[A:, :, 39].set(1.0)
        args3 = (ids_p.reshape(-1, B), cand_p.reshape(-1, B, K),
                 tbl_p.reshape(-1, B, K, 40))
    else:
        args3 = (ids_p.reshape(-1, B), cand_p.reshape(-1, B, K))
    if A_pad == B:
        phi_rows, tid_rows = tile_chunk(tuple(a[0] for a in args3))
        phi_rows = phi_rows[None].reshape(A_pad, C)
        tid_rows = tid_rows[None].reshape(A_pad, C)
    else:
        phi_rows, tid_rows = jax.lax.map(tile_chunk, args3)
        phi_rows = phi_rows.reshape(A_pad, C)
        tid_rows = tid_rows.reshape(A_pad, C)
    return phi_rows[:A], tid_rows[:A]


def untile_rows(rows, tile_shape, tiles_dim, grid_shape):
    """(T, C) tile rows -> dense (ni, nj, nk) grid (pure reshape+transpose,
    no scatter — for kernels that emit rows for EVERY tile)."""
    ni, nj, nk = grid_shape
    nti, ntj, ntk = tiles_dim
    ti, tj, tk = tile_shape
    x = rows.reshape(nti, ntj, ntk, ti, tj, tk)
    x = x.transpose(0, 3, 1, 4, 2, 5).reshape(nti * ti, ntj * tj, ntk * tk)
    return x[:ni, :nj, :nk]


def scatter_rows(rows, active_ids, fill, tile_shape, tiles_dim, grid_shape):
    """(A, C) rows -> one dense (ni, nj, nk) grid via contiguous row scatter.

    mode='drop' makes sentinel rows (index >= T) disappear."""
    ni, nj, nk = grid_shape
    nti, ntj, ntk = tiles_dim
    ti, tj, tk = tile_shape
    C = ti * tj * tk
    T = nti * ntj * ntk
    tiles = (
        jnp.full((T, C), fill, rows.dtype).at[active_ids].set(rows, mode="drop")
    )
    x = tiles.reshape(nti, ntj, ntk, ti, tj, tk)
    x = x.transpose(0, 3, 1, 4, 2, 5).reshape(nti * ti, ntj * tj, ntk * tk)
    return x[:ni, :nj, :nk]


def scatter_untile(
    phi_rows, tid_rows, active_ids, upper,
    tile_shape, tiles_dim, grid_shape,
):
    """(A, C) (phi, tid) rows -> dense grids (see scatter_rows)."""
    return (
        scatter_rows(phi_rows, active_ids, upper, tile_shape, tiles_dim, grid_shape),
        scatter_rows(
            tid_rows, active_ids, jnp.int32(-1), tile_shape, tiles_dim, grid_shape
        ),
    )


@partial(
    jax.jit,
    static_argnames=("tile_shape", "tiles_dim", "grid_shape", "chunk", "precision"),
)
def tile_candidate_field(
    tri_verts,
    active_ids,
    cand,
    cand_valid,
    origin,
    dx,
    tile_shape: Tuple[int, int, int],
    tiles_dim: Tuple[int, int, int],
    grid_shape: Tuple[int, int, int],
    chunk: int = 128,
    ijk_offset=None,
    upper_override=None,
    precision=jax.lax.Precision.HIGHEST,
    tbl=None,
):
    """Dense (ni, nj, nk) (phi, closest_tri) from per-tile candidate lists.

    Drop-in equivalent of ``band.band_distance_field`` (same contract, same
    scatter/untile assembly): tile_candidate_rows + scatter_untile."""
    ni, nj, nk = grid_shape
    if upper_override is None:
        upper = (jnp.float32(ni + nj + nk)) * dx
    else:
        upper = upper_override
    phi_rows, tid_rows = tile_candidate_rows(
        tri_verts, active_ids, cand, cand_valid, origin, dx,
        tile_shape, tiles_dim, grid_shape, chunk=chunk,
        ijk_offset=ijk_offset, upper_override=upper_override,
        precision=precision, tbl=tbl,
    )
    return scatter_untile(
        phi_rows, tid_rows, active_ids, upper, tile_shape, tiles_dim, grid_shape
    )


def closest_point_rows(
    table,  # (M+1, 40) affine table (tri_affine_table of grid-local verts)
    active_ids,  # (A,) linear tile ids
    tid_rows,  # (A, C) winning ids from tile_candidate_rows (-1 = none)
    dx,
    tile_shape: Tuple[int, int, int],
    tiles_dim: Tuple[int, int, int],
    chunk: int = 128,
    ijk_offset=None,
    far=np.float32(3e18),
):
    """Exact closest points for the band winners — the VDT seed payload.

    One row gather per CELL (winner's affine block), then the closest point
    is reconstructed from the same case analysis as the distance
    (cpu_lib/makelevelset3.cpp:49-70): inside -> p - h*n; otherwise the
    clamped projection onto the winning edge, cp = x2 + s*(x1-x2).
    Returns (cpx, cpy, cpz) rows (A, C), grid-local coords; `far` where
    tid < 0.
    """
    nti, ntj, ntk = tiles_dim
    ti, tj, tk = tile_shape
    C = ti * tj * tk
    A = active_ids.shape[0]
    M = table.shape[0] - 1
    if ijk_offset is None:
        ijk_offset = jnp.zeros((3,), jnp.int32)
    local = _tile_local_offsets(tile_shape)  # (C, 3)

    def cp_chunk(args):
        ids, tids = args  # (B,), (B, C)
        tbl = jnp.take(table, jnp.where(tids >= 0, tids, M), axis=0)  # (B,C,40)
        cf = lambda i: tbl[..., i]  # noqa: E731

        tile_k = ids % ntk
        tile_j = (ids // ntk) % ntj
        tile_i = ids // (ntk * ntj)
        base = jnp.stack([tile_i * ti, tile_j * tj, tile_k * tk], axis=-1)
        cell_idx = base[:, None, :] + local[None, :, :] + ijk_offset[None, None, :]
        p = cell_idx.astype(jnp.float32) * dx  # (B, C, 3)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]

        h = cf(0) * x + cf(1) * y + cf(2) * z + cf(3)
        w23 = cf(4) * x + cf(5) * y + cf(6) * z + cf(7)
        w31 = cf(8) * x + cf(9) * y + cf(10) * z + cf(11)
        w12 = 1.0 - w23 - w31
        inside = (jnp.minimum(jnp.minimum(w23, w31), w12) >= 0.0) & (cf(39) < 0.5)

        def edge(e0, x2_0, w_0):
            s_raw = cf(e0) * x + cf(e0 + 1) * y + cf(e0 + 2) * z + cf(e0 + 3)
            s = jnp.clip(s_raw, 0.0, 1.0)
            ddx = (x - cf(x2_0)) - s * cf(w_0)
            ddy = (y - cf(x2_0 + 1)) - s * cf(w_0 + 1)
            ddz = (z - cf(x2_0 + 2)) - s * cf(w_0 + 2)
            d2 = ddx * ddx + ddy * ddy + ddz * ddz
            # cp = x2 + s*w per component
            return d2, (
                cf(x2_0) + s * cf(w_0),
                cf(x2_0 + 1) + s * cf(w_0 + 1),
                cf(x2_0 + 2) + s * cf(w_0 + 2),
            )

        d_ab, cp_ab = edge(12, 24, 30)
        d_ac, cp_ac = edge(16, 27, 33)
        d_bc, cp_bc = edge(20, 27, 36)
        ab_best = (d_ab <= d_ac) & (d_ab <= d_bc)
        ac_best = (~ab_best) & (d_ac <= d_bc)

        def pick(i):
            cp_edge = jnp.where(
                ab_best, cp_ab[i], jnp.where(ac_best, cp_ac[i], cp_bc[i])
            )
            cp_in = p[..., i] - h * cf(i)  # n = channels 0:3
            return jnp.where(inside, cp_in, cp_edge)

        valid = tids >= 0
        return tuple(jnp.where(valid, pick(i), far) for i in range(3))

    if A == 0:
        e = jnp.zeros((0, C), jnp.float32)
        return e, e, e
    B = min(chunk, A)
    A_pad = _round_up(A, B)
    pad = A_pad - A
    ids_p = jnp.pad(active_ids, (0, pad))
    tid_p = jnp.pad(tid_rows, ((0, pad), (0, 0)), constant_values=-1)
    if A_pad == B:
        out = cp_chunk((ids_p, tid_p))
    else:
        out = jax.lax.map(
            cp_chunk, (ids_p.reshape(-1, B), tid_p.reshape(-1, B, C))
        )
        out = tuple(o.reshape(A_pad, C) for o in out)
    return tuple(o[:A] for o in out)
