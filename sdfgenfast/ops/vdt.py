"""Cell-level vector distance transform (closest-point jump flooding).

The far-field completion that finally matches the reference's accuracy
profile everywhere. The reference propagates closest-triangle IDS cell to
cell and re-evaluates distances exactly at each adoption
(``cpu_lib/makelevelset3.cpp:243-292``); here, re-evaluating a neighbor's
id would mean a gather of that triangle's vertices per cell and candidate.

Propagating the closest POINT instead (Danielsson's vector distance
transform, with jump-flooding strides) keeps the exactness where it
matters and needs NO gathers at all:

  - every propagated cp is an exact point ON some triangle of the mesh, so
    |p - cp| is always >= the true distance (never an underestimate);
  - a cell one hop from its donor sees the donor's cp misaligned from its
    own ideal foot point by O(dx), giving |p - cp| - true = O(dx^2 / d) —
    the error SHRINKS with depth, exactly where tile-granular methods
    degrade (measured: the 82k-tri sphere at depth 40-70dx had 0.35dx
    tile-JFA error vs <=0.1dx for the VDT);
  - a candidate evaluation is 8 elementwise ops on shifted fields.

State layout is CHANNEL-FIRST (5, ni, nj, nk): each channel is a contiguous
grid, so shifted reads along k stay contiguous.

Rounds:
  - ladder strides (max_dim/2 .. 1) are JACOBI: one pad of the round-start
    state, then 26 dynamic-slice candidate reads with a running min;
  - stride-1 polish rounds are GAUSS-SEIDEL (candidates from the running
    state; adopted values re-donate within the round), which converges
    measurably tighter — 0.09/0.07/0.13 dx residuals vs the goldens.
    Both round forms use fori_loop bodies (a python-unrolled chain of
    static shifts once miscompiled under jit on the backend this was first
    written for; regression: tests/test_vdt.py TestJitConsistency). On the
    GPU the pyramid's rounds run through ops/vdt_pallas.py instead.

For sharded runs the ladder is CAPPED at `max_hop` <= the shard block, so
every round needs only a max_hop-deep, corner-complete halo slab on the
sharded axes — Jacobi semantics with round-start halos make shard blocks
bit-identical to a single-device run of the same capped ladder (sharded
mode also uses Jacobi for the polish rounds).

Shifts fill with FAR (never wrap), so donor reachability is identical in
both settings. The winning triangle id rides along for the differentiable
recompute (d(p, tri(tid)) <= |p - cp| since cp lies on that triangle, so
the recompute only tightens the field).

Seeds come from the narrow band's exact closest points (``ops/tiled``
emits them from the same affine forms as the distances, matching
``cpu_lib/makelevelset3.cpp:49-70``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "FAR",
    "stride_ladder",
    "vdt_far_field",
    "vdt_pyramid_far_field",
    "chamfer_relax",
    "pack_state",
    "unpack_tid",
]

_OFFSETS26 = np.array(
    [
        (a, b, c)
        for a in (-1, 0, 1)
        for b in (-1, 0, 1)
        for c in (-1, 0, 1)
        if (a, b, c) != (0, 0, 0)
    ],
    np.int32,
)

# plain float: a module-level jnp constant would initialise the XLA
# backend at import time and break jax.distributed workers
FAR = np.float32(3e18)


def pack_state(cpx, cpy, cpz, tid, d2):
    """(5, ...) VDT state. The int32 triangle id is BITCAST into the f32
    channel (not value-cast): ids above 2^24 are not exactly representable
    as f32, so a value cast would silently round them to a different
    triangle on >16.7M-triangle meshes. The channel is only ever copied by
    selects, never used arithmetically, so raw bits ride along safely."""
    tbits = jax.lax.bitcast_convert_type(tid.astype(jnp.int32), jnp.float32)
    return jnp.stack([cpx, cpy, cpz, tbits, d2], axis=0)


def unpack_tid(channel):
    """Recover int32 triangle ids from the bitcast f32 state channel."""
    return jax.lax.bitcast_convert_type(channel, jnp.int32)


def _dist2(px, py, pz, cx, cy, cz):
    dxp = px - cx
    dyp = py - cy
    dzp = pz - cz
    return dxp * dxp + dyp * dyp + dzp * dzp


def _pos_axes(shape, dx, offsets=None):
    """Grid-local world coords per axis; `offsets` shifts to global indices."""
    if offsets is None:
        offsets = (0, 0, 0)
    ni, nj, nk = shape
    px = ((jnp.arange(ni, dtype=jnp.int32) + offsets[0]).astype(jnp.float32) * dx)
    py = ((jnp.arange(nj, dtype=jnp.int32) + offsets[1]).astype(jnp.float32) * dx)
    pz = ((jnp.arange(nk, dtype=jnp.int32) + offsets[2]).astype(jnp.float32) * dx)
    return px[:, None, None], py[None, :, None], pz[None, None, :]


def _merge(best, cand, cd2):
    """Adopt candidates with strictly smaller distance (all 5 channels).

    Single fused select: candidate channels 0:4 + the recomputed cd2 as
    channel 4 — one pass over the state instead of a where + a scatter."""
    upd = jnp.concatenate([cand[:4], cd2[None]], axis=0)
    better = cd2 < best[4]
    return jnp.where(better[None], upd, best)


def _jacobi_round(state, px, py, pz, stride, offs):
    """Jacobi round: ONE pad of the round-start state + 26 dynamic-slice
    candidate reads with a running min. state: (5, ni, nj, nk)."""
    _, ni, nj, nk = state.shape
    s = stride
    ext = jnp.pad(
        state, ((0, 0), (s, s), (s, s), (s, s)), constant_values=FAR
    )

    def body(m, best):
        o = offs[m] * stride
        cand = jax.lax.dynamic_slice(
            ext, (0, s + o[0], s + o[1], s + o[2]), (5, ni, nj, nk)
        )
        cd2 = _dist2(px, py, pz, cand[0], cand[1], cand[2])
        return _merge(best, cand, cd2)

    return jax.lax.fori_loop(0, offs.shape[0], body, state)


def _gs_round(state, px, py, pz, stride, offs):
    """Gauss-Seidel round: candidates come from the RUNNING state (adopted
    values re-donate within the round) — converges noticeably tighter than
    Jacobi at the same round count. The body pads the carry per offset
    (fori form, see the module docstring)."""
    _, ni, nj, nk = state.shape
    s = stride

    def body(m, best):
        o = offs[m] * stride
        ext = jnp.pad(
            best, ((0, 0), (s, s), (s, s), (s, s)), constant_values=FAR
        )
        cand = jax.lax.dynamic_slice(
            ext, (0, s + o[0], s + o[1], s + o[2]), (5, ni, nj, nk)
        )
        cd2 = _dist2(px, py, pz, cand[0], cand[1], cand[2])
        return _merge(best, cand, cd2)

    return jax.lax.fori_loop(0, offs.shape[0], body, state)


_OFFSETS6 = np.array(
    [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)],
    np.int32,
)


def _gs_axes_round(state, px, py, pz, stride):
    """Axis-separated Gauss-Seidel round: only the 6 face offsets, but
    SEQUENCED, so content composes i->j->k within the round and reaches the
    diagonals a 26-offset Jacobi round covers — at ~1/4 the traffic. Used
    for the large ladder strides, where per-round cost dominates the far
    field; the final small strides and polish stay 26-offset.

    One fori loop per axis, each padding ONLY its own axis: at stride s the
    transient is 1 + 2s/n of the state instead of (1 + 2s/n)^3, which keeps
    the FULL ladder within HBM even at 512-class grids."""
    _, ni, nj, nk = state.shape
    s = stride
    dims = (ni, nj, nk)

    for ax in range(3):
        pads = [(0, 0)] * 4
        pads[ax + 1] = (s, s)
        sizes = (5, ni, nj, nk)

        def body(m, best, ax=ax, pads=tuple(pads)):
            sign = m * 2 - 1  # m in {0, 1} -> offset -s, +s
            ext = jnp.pad(best, pads, constant_values=FAR)
            start = [0, 0, 0, 0]
            start[ax + 1] = s + sign * s
            start = [jnp.int32(v) if not hasattr(v, "dtype") else v
                     for v in start]
            start[ax + 1] = jnp.int32(s) + sign * s
            cand = jax.lax.dynamic_slice(ext, tuple(start), sizes)
            cd2 = _dist2(px, py, pz, cand[0], cand[1], cand[2])
            return _merge(best, cand, cd2)

        state = jax.lax.fori_loop(0, 2, body, state)
    return state


def _halo_round(state, px, py, pz, stride, offs, halo_extend):
    """Jacobi round for sharded blocks: j/k candidates come from the
    (stride-deep, corner-complete) extended round-start state; the
    (unsharded) i axis is padded locally."""
    _, ni, nj, nk = state.shape
    s = stride
    ext = halo_extend(state, s)  # (5, ni, nj + 2s, nk + 2s)
    ext = jnp.pad(ext, ((0, 0), (s, s), (0, 0), (0, 0)), constant_values=FAR)

    def body(m, best):
        o = offs[m] * stride
        cand = jax.lax.dynamic_slice(
            ext, (0, s + o[0], s + o[1], s + o[2]), (5, ni, nj, nk)
        )
        cd2 = _dist2(px, py, pz, cand[0], cand[1], cand[2])
        return _merge(best, cand, cd2)

    return jax.lax.fori_loop(0, offs.shape[0], body, state)


def stride_ladder(max_dim: int, max_hop=None, extra_rounds: int = 2):
    """The jump-flood stride schedule.

    Full ladder: max_dim/2, /4, .., 1 (+ extra stride-1 polish). With a
    `max_hop` cap (sharded: cap <= shard block so one halo slab suffices),
    the capped stride repeats until the same total reach is covered."""
    s = 1
    while s * 2 < max_dim:
        s *= 2
    strides = []
    while s >= 1:
        strides.append(s)
        s //= 2
    if max_hop is not None and strides and strides[0] > max_hop:
        capped = [x for x in strides if x <= max_hop]
        reach_missing = sum(x for x in strides if x > max_hop)
        repeats = -(-reach_missing // max_hop)
        strides = [max_hop] * repeats + capped
    return tuple(strides + [1] * extra_rounds)


def vdt_far_field(
    cpx, cpy, cpz,  # (ni, nj, nk) f32 seed closest points (grid-local), FAR empty
    tid,  # (ni, nj, nk) int32 seed ids, -1 empty
    phi_seed,  # (ni, nj, nk) f32 band evaluator distances (upper if unseeded)
    dx,
    strides,
    freeze_mask=None,  # bool: cells whose phi_seed is provably EXACT
    ijk_offset=None,  # (3,) python ints: global index of local cell (0,0,0)
    halo_extend=None,  # sharded: halo_extend(state, s) -> j/k s-extended state
    jacobi=False,  # True: pure Jacobi rounds (sharded bit-equality); False:
    #              Gauss-Seidel stride-1 polish rounds (faster convergence)
):
    """Closest-point jump flooding over the cell grid.

    Returns (phi, tid). Cells in `freeze_mask` are FROZEN to their exact
    evaluator distances and ids — the binning guarantees exactness for
    cells whose band value is <= seed_band*dx, and a reconstructed cp can
    sit ~1e-5 off the surface (affine rounding at region boundaries), so a
    donated |p - cp_donor| could undercut the exact value at ulp scale.
    Cells OUTSIDE the mask may hold non-minimal band upper bounds (an
    active tile evaluates all of its cells against its candidate list,
    exact only within the true band) and must stay refinable.
    Elsewhere phi = |p - cp| of the converged closest points, an
    O(dx^2/d) overestimate.
    """
    ni, nj, nk = cpx.shape
    px, py, pz = _pos_axes((ni, nj, nk), dx, ijk_offset)
    d2 = _dist2(px, py, pz, cpx, cpy, cpz)
    state = pack_state(cpx, cpy, cpz, tid, d2)

    offs = jnp.asarray(_OFFSETS26)
    for stride in strides:
        if halo_extend is not None:
            state = _halo_round(state, px, py, pz, stride, offs, halo_extend)
        elif not jacobi and stride >= 8:
            state = _gs_axes_round(state, px, py, pz, stride)
        elif not jacobi and stride == 1:
            state = _gs_round(state, px, py, pz, stride, offs)
        else:
            state = _jacobi_round(state, px, py, pz, stride, offs)

    phi = jnp.sqrt(jnp.maximum(state[4], 0.0))
    out_tid = unpack_tid(state[3])
    if freeze_mask is None:
        freeze_mask = tid >= 0
    return (
        jnp.where(freeze_mask, phi_seed, jnp.minimum(phi, phi_seed)),
        jnp.where(freeze_mask, tid, out_tid),
    )


# ---------------------------------------------------------------------------
# Pyramid (coarse-to-fine) VDT — the fast single-device schedule
# ---------------------------------------------------------------------------
#
# The flat jump-flood ladder runs every stride at FULL resolution: ~10 rounds
# x (pad + 26 shifted reads + merge) over the whole (5, ni, nj, nk) state.
# The pyramid form runs the long-range strides on 8x/64x/... smaller grids:
#
#   1. min-downsample the seeded state by 2 per level until <= ~48 cells;
#   2. full jump-flood ladder at the coarsest level (negligible cost);
#   3. walk back down: upsample (parent closest points re-scored against the
#      fine cell positions, merged with the level's own seeds), then
#      stride-2 + stride-1 Jacobi rounds to repair coarse-granularity
#      donor misassignments (reach 3 cells > the <=2-cell parent error);
#   4. extra stride-1 polish rounds at full resolution.
#
# On the GPU route every round runs through the Pallas kernel
# (ops/vdt_pallas.py); the jnp rounds here are its reference implementation
# (and the CPU path). All
# propagated closest points remain exact points on mesh triangles, so the
# field stays an overestimate everywhere and the chamfer/freeze invariants
# of `vdt_far_field` carry over unchanged.

_COARSE_MAX = 48  # coarsest-level cap: 48^3 state = 2.2 MB, ladder ~free
_MAX_LEVELS = 3   # at most two downsamples (decimation error ~ F^2/depth)

# The full-resolution / intermediate-level repair schedules. Shared
# constants so the sharded pyramid (parallel/sharded.py) runs the EXACT
# single-device schedule — any drift would break the sharded-equals-
# single-device contract.
PYRAMID_LEVEL_ROUNDS = (8, 4, 2, 2, 1)
PYRAMID_COARSE_ROUNDS = (8, 4, 2, 1, 1)


def pyramid_level_shapes(grid_shape):
    """The pyramid level shapes the schedule builds for a global grid —
    level 0 is the grid itself; each level halves (ceil) until
    <= _COARSE_MAX or _MAX_LEVELS levels exist. Shared by the single-device
    and sharded pyramids so their level counts always agree."""
    shapes = [tuple(grid_shape)]
    while (max(shapes[-1]) > _COARSE_MAX and len(shapes) < _MAX_LEVELS):
        shapes.append(tuple(-(-d // 2) for d in shapes[-1]))
    return shapes


def _level_pos_axes(shape, dx, scale: int, offsets=None):
    """World coords of a pyramid level: level cell I sits at fine index
    I * scale (corner subsampling), so positions stay EXACT fine-grid
    positions: f32(I * scale) * dx. `offsets` (3 ints/scalars, may be
    traced) shifts array-local level indices to GLOBAL level indices —
    sharded blocks pass their shard offset so positions match a
    single-device run bit-for-bit."""
    ni, nj, nk = shape
    if offsets is None:
        offsets = (0, 0, 0)
    s = jnp.int32(scale)
    px = (((jnp.arange(ni, dtype=jnp.int32) + offsets[0]) * s)
          .astype(jnp.float32) * dx)
    py = (((jnp.arange(nj, dtype=jnp.int32) + offsets[1]) * s)
          .astype(jnp.float32) * dx)
    pz = (((jnp.arange(nk, dtype=jnp.int32) + offsets[2]) * s)
          .astype(jnp.float32) * dx)
    return px[:, None, None], py[None, :, None], pz[None, None, :]


def _downsample2(state, dx, fine_scale, offsets=None):
    """Factor-2 min-downsample: each coarse cell adopts a nearby child
    closest point, re-scored against the coarse cell's position (the corner
    child's fine position).

    Three axis-wise pairwise tournaments instead of eight strided 3-D
    slices: the 8-slice form made XLA re-walk the full state once per
    child; the halving passes read each element
    once per axis (~1/6 the traffic). Each pass re-scores both children
    against the position that is coarse in the axes merged so far and fine
    in the rest — after the k pass that is exactly the coarse corner
    position. NOTE this is a GREEDY approximation of the 8-child argmin:
    early passes judge winners at mixed coarse/fine positions, so the
    globally closest child can be eliminated before the final re-score.
    The overestimate invariant still holds exactly (every surviving cp is a
    real surface point), and far-field accuracy is enforced by the golden
    bars, not by equivalence with the 8-slice form. The k (lane) pass pairs
    neighbors via a reshape split, not a lane-strided slice.

    `offsets` (3 ints/scalars, may be traced): the state's array-local
    index offsets at the FINE level (sharded blocks). They must be EVEN on
    any axis where the block is a strict shard (sharded blocks are tile-8
    multiples, so this holds), making the local pairing identical to the
    global one and results bit-equal to downsampling the full grid."""
    if offsets is None:
        offsets = (0, 0, 0)
    _, ni, nj, nk = state.shape
    pad = ((0, 0), (0, ni % 2), (0, nj % 2), (0, nk % 2))
    if any(p[1] for p in pad):
        state = jnp.pad(state, pad, constant_values=FAR)

    def axis_pos(n, scale, which, off=0):
        v = (((jnp.arange(n, dtype=jnp.int32) + off) * jnp.int32(scale))
             .astype(jnp.float32) * dx)
        shape = [1, 1, 1]
        shape[which] = n
        return v.reshape(shape)

    def pair_merge(a, b, pos):
        # keep the child whose cp is closer to the even-child position
        da = _dist2(*pos, a[0], a[1], a[2])
        best = jnp.concatenate([a[:4], da[None]], axis=0)
        db = _dist2(*pos, b[0], b[1], b[2])
        return _merge(best, b, db)

    f, c = fine_scale, 2 * fine_scale
    oi, oj, ok = offsets
    oi2, oj2, ok2 = oi // 2, oj // 2, ok // 2  # coarse-level offsets (even)
    ni2, nj2, nk2 = state.shape[1] // 2, state.shape[2] // 2, state.shape[3] // 2
    state = pair_merge(
        state[:, 0::2], state[:, 1::2],
        (axis_pos(ni2, c, 0, oi2), axis_pos(state.shape[2], f, 1, oj),
         axis_pos(state.shape[3], f, 2, ok)),
    )
    state = pair_merge(
        state[:, :, 0::2], state[:, :, 1::2],
        (axis_pos(ni2, c, 0, oi2), axis_pos(nj2, c, 1, oj2),
         axis_pos(state.shape[3], f, 2, ok)),
    )
    pairs = state.reshape(5, ni2, nj2, nk2, 2)
    state = pair_merge(
        pairs[..., 0], pairs[..., 1],
        (axis_pos(ni2, c, 0, oi2), axis_pos(nj2, c, 1, oj2),
         axis_pos(nk2, c, 2, ok2)),
    )
    return state


def _upsample_merge(coarse, fine, px, py, pz):
    """Adopt the coarse parent's closest point wherever it beats the fine
    state (re-scored against the fine cell positions)."""
    _, ni, nj, nk = fine.shape
    parent = jnp.repeat(jnp.repeat(jnp.repeat(
        coarse, 2, axis=1), 2, axis=2), 2, axis=3)[:, :ni, :nj, :nk]
    cd2 = _dist2(px, py, pz, parent[0], parent[1], parent[2])
    return _merge(fine, parent, cd2)


def vdt_pyramid_far_field(
    cpx, cpy, cpz,  # (ni, nj, nk) f32 seed closest points (grid-local), FAR empty
    tid,  # (ni, nj, nk) int32 seed ids, -1 empty
    phi_seed,  # (ni, nj, nk) f32 band evaluator distances (upper if unseeded)
    dx,
    freeze_mask=None,
    extra_polish: int = 1,  # extra stride-1 rounds at full resolution
    use_pallas: bool = False,  # run rounds through the Pallas kernel
    #   (ops/vdt_pallas.py, GPU route) — equal to the jnp rounds up to FMA
    #   contraction of the squared distance
    round_fn=None,  # custom (state, px, py, pz, stride) -> state override
    level_rounds=PYRAMID_LEVEL_ROUNDS,  # full-res repair strides after the last
    #   upsample. Reach = sum(strides)+polish: cells within ~18 cells of the
    #   band get full-seed-set donor quality; deeper cells rely on coarser
    #   levels, whose cp-decimation overestimate shrinks as F^2/depth.
    #   Tuned on the 128/256 goldens: (8,4,2,2,1)+1 polish = 0.14-0.16 dx
    #   worst-case vs the reference binary (bar: 0.2 dx).
    coarse_rounds=PYRAMID_COARSE_ROUNDS,  # repair strides at intermediate levels
    #   (each level is 8x smaller than the one below, so generous repair
    #   there is nearly free)
):
    """Coarse-to-fine closest-point transform. Same contract and freeze
    semantics as `vdt_far_field`; different (much cheaper) schedule. The
    produced field is an O(dx^2/d) overestimate exactly like the flat
    ladder (every cp is a point on a real triangle); accuracy vs the
    reference binary is enforced by the golden tests' 0.2*dx far-field bar.
    """
    ni, nj, nk = cpx.shape
    offs = jnp.asarray(_OFFSETS26)

    def jnp_phase(state, strides, scale):
        pos = _level_pos_axes(state.shape[1:], dx, scale)
        for stride in strides:
            state = _jacobi_round(state, *pos, stride, offs)
        return state

    if round_fn is not None:
        def phase(state, strides, scale):
            pos = _level_pos_axes(state.shape[1:], dx, scale)
            for stride in strides:
                state = round_fn(state, *pos, stride)
            return state
    elif use_pallas:
        from .vdt_pallas import pallas_round_phase

        def phase(state, strides, scale):
            return pallas_round_phase(state, dx, strides, scale)
    else:
        phase = jnp_phase

    px, py, pz = _level_pos_axes((ni, nj, nk), dx, 1)
    d2 = _dist2(px, py, pz, cpx, cpy, cpz)
    state = pack_state(cpx, cpy, cpz, tid, d2)

    # seed pyramid (corner subsampling; positions exact at every level).
    # AT MOST two downsamples: the decimation overestimate scales as
    # F^2/depth, and F=8 put 512-class deep cells at ~0.23dx vs the
    # golden's 0.2dx bar — F<=4 keeps every depth under ~0.1dx because the
    # coarsest level runs the FULL jump-flood ladder (its reach covers the
    # whole grid, unlike the fixed-reach repair tails of finer levels).
    levels = [(state, (px, py, pz), 1)]
    for _ in range(len(pyramid_level_shapes((ni, nj, nk))) - 1):
        prev, _, scale = levels[-1]
        shape2 = tuple(-(-d // 2) for d in prev.shape[1:])
        pos2 = _level_pos_axes(shape2, dx, scale * 2)
        levels.append((_downsample2(prev, dx, scale), pos2, scale * 2))

    # coarsest level: full jump-flood ladder (the state is tiny)
    s, pos, scale_c = levels[-1]
    s = phase(s, stride_ladder(max(s.shape[1:]), extra_rounds=1), scale_c)

    # descend: upsample + short-stride repair rounds
    for lvl in range(len(levels) - 2, -1, -1):
        fine, pos, scale_l = levels[lvl]
        s = _upsample_merge(s, fine, *pos)
        rounds = coarse_rounds if lvl > 0 else (
            tuple(level_rounds) + (1,) * extra_polish)
        s = phase(s, rounds, scale_l)

    phi = jnp.sqrt(jnp.maximum(s[4], 0.0))
    out_tid = unpack_tid(s[3])
    if freeze_mask is None:
        freeze_mask = tid >= 0
    return (
        jnp.where(freeze_mask, phi_seed, jnp.minimum(phi, phi_seed)),
        jnp.where(freeze_mask, tid, out_tid),
    )


def chamfer_relax(phi, dx, passes: int = 2):
    """Lipschitz relaxation of an everywhere->=true unsigned distance field.

    phi_new(p) = min(phi(p), min_o phi(p+o) + |o|*dx) over the 26-offset
    stencil. Every value in `phi` is the distance to some ACTUAL surface
    point, hence >= the true distance; the triangle inequality gives
    phi(q) + |p-q| >= true(q) + |p-q| >= true(p), so the relaxation is
    monotone non-increasing AND never drops below the true distance —
    exact cells stay exact. It tightens the rare residual overestimates of
    the VDT at negligible cost.

    Each pass is an unrolled chain of 26 static shifted slices of one padded
    copy, which XLA fuses into a single loop over the grid.
    """
    ni, nj, nk = phi.shape
    steps = np.sqrt((_OFFSETS26.astype(np.float64) ** 2).sum(-1)).astype(
        np.float32)
    big = jnp.float32(3e38)
    for _ in range(passes):
        ext = jnp.pad(phi, 1, constant_values=big)
        acc = phi
        for (oi, oj, ok), st in zip(_OFFSETS26.tolist(), steps):
            nb = ext[1 + oi:1 + oi + ni, 1 + oj:1 + oj + nj, 1 + ok:1 + ok + nk]
            acc = jnp.minimum(acc, nb + st * dx)
        phi = acc
    return phi
