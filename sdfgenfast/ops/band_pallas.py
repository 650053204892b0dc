"""Pallas (Triton) kernel for the narrow-band tile evaluation.

Replaces the XLA path (``ops/tiled.tile_candidate_rows`` +
``closest_point_rows`` + ``scatter_untile``) on the GPU route. The XLA path
materializes (B, C, K, 6) form tensors, gathers the winners' coefficient
rows a second time for the closest points, and scatters rows. This kernel
fuses all three:

  * CSR candidate layout: each active tile's candidate list is one
    contiguous segment of a flat (P,) id array — no per-tile K padding to
    the global maximum (the torus' K_max=416 vs median 163 would waste 2.5x
    the work in the padded (A, K) layout).
  * One program per active tile, its 512 cells (an 8^3 tile) as the vector.
    The program loads its own segment start and length and walks the
    segment with a running min, winner id and winner difference vector.
  * Per-candidate coefficients are rows of the same (M+1, 40) affine table
    the XLA path uses (``tiled.tri_affine_table``); row M is the sentinel
    the CSR pads point at (degenerate, vertices at 3e18: never wins).
  * Distances use the same evaluation as the XLA path (and the reference,
    cpu_lib/makelevelset3.cpp:21-70): plane distance via the unit normal for
    barycentric-inside cells, cancellation-free difference-form clamped-edge
    distances otherwise; min over the 3 edges equals the region minimum.
  * Ties keep the LOWEST candidate id (segments are ascending and the merge
    is a strict '<', the reference's first-wins).
  * The winner's closest point rides along as p - dd (dd is the winning
    difference vector, already computed for the distance), so no second
    gather pass is needed.

Output: five (T+1, 512) row arrays (phi, tid, cpx, cpy, cpz) in tile-row
layout. Rows of inactive tiles are never written; callers select them
against an active-row mask (see pipeline._exact_core). Row T is the junk
target of padded steps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .tiled import tri_affine_table

__all__ = ["band_csr_from_binning", "band_rows_pallas"]

_CELLS = 512  # cells of one 8^3 tile
_FAR = np.float32(3e18)


def band_csr_from_binning(cand, cand_valid, num_tris):
    """(A, K) padded candidate lists -> CSR arrays for the kernel.

    Returns (pair_cand (P,) int32, off (A,) int32, cnt (A,) int32). An empty
    tile gets one slot holding sentinel id `num_tris` (the affine table's
    sentinel row: it never wins and its id is never emitted).
    """
    counts = cand_valid.sum(axis=1).astype(np.int64)
    padded = np.maximum(counts, 1)
    off = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    # binning emits PREFIX-dense rows (valid[i, :counts[i]] all True), so a
    # segment is just the row prefix + sentinel pad — one boolean mask over
    # the (A, Kp) grid builds the whole CSR array
    A, K = cand.shape
    Kp = max(K, int(padded.max()) if A else 1)
    cols = np.arange(Kp)
    vals = np.where(cols[None, :] < counts[:, None],
                    np.pad(cand, ((0, 0), (0, Kp - K))), num_tris)
    pair = vals[cols[None, :] < padded[:, None]].astype(np.int32)
    return pair, off.astype(np.int32), padded.astype(np.int32)


def _band_kernel(ids_ref, cid_ref, off_ref, cnt_ref, dx_ref, pair_ref,
                 tbl_ref, phi_ref, tid_ref, cpx_ref, cpy_ref, cpz_ref, *,
                 ntj, ntk, dims_sum):
    # ids_ref: OUTPUT row ids (local tile index). cid_ref: COORDINATE tile
    # ids decomposed with the (ntj, ntk) statics — identical to ids_ref
    # single-device; under shard_map they carry GLOBAL tile ids so cell
    # positions are global while rows stay shard-local (sharded results
    # must match single-device bit-for-bit).
    a = pl.program_id(0)
    row = ids_ref[a]
    dxf = dx_ref[0]
    upper = jnp.float32(dims_sum) * dxf  # makelevelset3.cpp:197

    # tile cell positions, grid-local: cells c = (li*8 + lj)*8 + lk
    t = cid_ref[a]
    tk = t % ntk
    tj = (t // ntk) % ntj
    ti = t // (ntk * ntj)
    c = jnp.arange(_CELLS, dtype=jnp.int32)
    x = (ti * 8 + c // 64).astype(jnp.float32) * dxf
    y = (tj * 8 + (c // 8) % 8).astype(jnp.float32) * dxf
    z = (tk * 8 + c % 8).astype(jnp.float32) * dxf
    seg = off_ref[a]

    def step(i, carry):
        best_d2, best_t, bdx, bdy, bdz = carry
        tri = pair_ref[seg + i]
        cf = lambda j: tbl_ref[tri, j]  # noqa: E731 — scalar load

        h = cf(0) * x + cf(1) * y + cf(2) * z + cf(3)
        w23 = cf(4) * x + cf(5) * y + cf(6) * z + cf(7)
        w31 = cf(8) * x + cf(9) * y + cf(10) * z + cf(11)
        w12 = 1.0 - w23 - w31
        inside = (jnp.minimum(jnp.minimum(w23, w31), w12) >= 0.0) & (
            cf(39) < 0.5)

        def edge(e0, x2_0, w_0):
            s = jnp.clip(cf(e0) * x + cf(e0 + 1) * y + cf(e0 + 2) * z
                         + cf(e0 + 3), 0.0, 1.0)
            ddx = (x - cf(x2_0)) - s * cf(w_0)
            ddy = (y - cf(x2_0 + 1)) - s * cf(w_0 + 1)
            ddz = (z - cf(x2_0 + 2)) - s * cf(w_0 + 2)
            return ddx * ddx + ddy * ddy + ddz * ddz, (ddx, ddy, ddz)

        dab, dd_ab = edge(12, 24, 30)
        dac, dd_ac = edge(16, 27, 33)
        dbc, dd_bc = edge(20, 27, 36)
        d2 = jnp.where(inside, h * h, jnp.minimum(dab, jnp.minimum(dac, dbc)))

        # winner dd (p - cp): inside -> h*n; else the winning edge's dd
        ab_best = (dab <= dac) & (dab <= dbc)
        ac_best = (~ab_best) & (dac <= dbc)

        def pick(i3):
            e = jnp.where(ab_best, dd_ab[i3],
                          jnp.where(ac_best, dd_ac[i3], dd_bc[i3]))
            return jnp.where(inside, h * cf(i3), e)

        better = d2 < best_d2
        return (jnp.where(better, d2, best_d2),
                jnp.where(better, tri, best_t),
                jnp.where(better, pick(0), bdx),
                jnp.where(better, pick(1), bdy),
                jnp.where(better, pick(2), bdz))

    zero = jnp.zeros((_CELLS,), jnp.float32)
    init = (jnp.full((_CELLS,), jnp.inf, jnp.float32),
            jnp.full((_CELLS,), -1, jnp.int32), zero, zero, zero)
    best_d2, best_t, bdx, bdy, bdz = jax.lax.fori_loop(
        0, cnt_ref[a], step, init)

    # adopt only below the reference's init upper bound (ni+nj+nk)*dx
    has = best_d2 < upper * upper
    phi_ref[row, :] = jnp.where(has, jnp.sqrt(best_d2), upper)
    tid_ref[row, :] = jnp.where(has, best_t, -1)
    cpx_ref[row, :] = jnp.where(has, x - bdx, _FAR)
    cpy_ref[row, :] = jnp.where(has, y - bdy, _FAR)
    cpz_ref[row, :] = jnp.where(has, z - bdz, _FAR)


def band_rows_pallas(
    tri_local,   # (M, 3, 3) f32 GRID-LOCAL vertices (origin subtracted)
    pair_cand,   # (P,) int32 CSR candidate ids (sentinel M for pads)
    active_ids,  # (A_pad,) int32 linear tile ids (sentinel T for pads)
    tile_off,    # (A_pad,) int32 segment starts
    tile_cnt,    # (A_pad,) int32 segment lengths (0 for pads)
    dx,
    *,
    tiles_dim,
    grid_shape,
    interpret: bool = False,
    coord_ids=None,      # (A_pad,) int32 tile ids used for CELL POSITIONS,
    coord_tiles_dim=None,  # decomposed with these tile dims. Defaults to
    coord_grid_shape=None,  # active_ids/tiles_dim/grid_shape; sharded
    #   callers pass GLOBAL ids/dims here (rows stay shard-local via
    #   active_ids) so per-shard results match single-device bit-for-bit.
):
    """(T+1, 512) rows of (phi, tid, cpx, cpy, cpz) for all active tiles.

    Rows not written by any program (inactive tiles) are undefined — callers
    select them against an active-row mask (see pipeline._exact_core).
    """
    nti, ntj, ntk = tiles_dim
    T = nti * ntj * ntk
    if coord_ids is None:
        coord_ids = active_ids
    if coord_tiles_dim is None:
        coord_tiles_dim = tiles_dim
    if coord_grid_shape is None:
        coord_grid_shape = grid_shape
    _, cntj, cntk = coord_tiles_dim
    ni, nj, nk = coord_grid_shape
    A = int(active_ids.shape[0])

    table = tri_affine_table(tri_local)  # (M+1, 40), row M = sentinel
    f32 = jax.ShapeDtypeStruct((T + 1, _CELLS), jnp.float32)
    i32 = jax.ShapeDtypeStruct((T + 1, _CELLS), jnp.int32)
    return pl.pallas_call(
        partial(_band_kernel, ntj=cntj, ntk=cntk, dims_sum=ni + nj + nk),
        grid=(A,),
        out_shape=(f32, i32, f32, f32, f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="sdf_band",
    )(active_ids, coord_ids, tile_off, tile_cnt,
      jnp.asarray(dx, jnp.float32).reshape(1), pair_cand, table)
