"""Far-field completion: closest-triangle propagation and Eikonal relaxation.

The reference CPU backend runs 2 passes x 8 directional Gauss-Seidel sweeps
that propagate *closest-triangle ids* and re-evaluate exact point-to-triangle
distances (``cpu_lib/makelevelset3.cpp:90-151, 243-292``). The CUDA backend
instead relaxes the Eikonal equation |grad phi| = 1 with double-buffered
Jacobi iterations (``gpu_lib/makelevelset3_gpu.cu:487-551``), accepting
far-field divergence from the CPU result.

Design ("exact" mode): a Gauss-Seidel sweep is a 3D wavefront
recurrence — hostile to SIMD. But its *fixed point* (no cell can improve by
adopting any of its 26 neighbors' triangles) is order-independent, so we reach
the same fixed point with directional **plane scans**: a `lax.scan` along one
axis whose carry is the previous (already-updated) plane; every cell considers
the 9 neighbors in that plane (3x3 shifts). All (nB x nC) lanes of a plane
update in parallel; scanning both directions of all 3 axes covers
all 26 neighbor offsets. Passes repeat until no cell changes — the same
convergence-by-iteration the reference uses (2 passes there; we iterate to an
actual fixed point, which the reference's tests treat as ground truth).

"eikonal" mode mirrors the CUDA kernel: axiswise min-neighbor sort and
closed-form 1D/2D/3D quadratic updates, run as Jacobi iterations.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .geometry import point_triangle_distance_sq

__all__ = ["propagate_closest_triangles", "eikonal_far_field"]


def _shift_plane(x, dj, dk, fill):
    """Shift a (nB, nC) plane by (dj, dk) with edge fill."""
    if dj > 0:
        x = jnp.concatenate([jnp.full((dj, x.shape[1]), fill, x.dtype), x[:-dj]], 0)
    elif dj < 0:
        x = jnp.concatenate([x[-dj:], jnp.full((-dj, x.shape[1]), fill, x.dtype)], 0)
    if dk > 0:
        x = jnp.concatenate([jnp.full((x.shape[0], dk), fill, x.dtype), x[:, :-dk]], 1)
    elif dk < 0:
        x = jnp.concatenate([x[:, -dk:], jnp.full((x.shape[0], -dk), fill, x.dtype)], 1)
    return x


_SHIFTS = [(dj, dk) for dj in (-1, 0, 1) for dk in (-1, 0, 1)]


def plane_update(cand_tid, cur_phi, cur_tid, tri_verts, gx):
    """One plane relaxation given the 9 candidate-tid planes (stacked in
    _SHIFTS order): re-evaluate exact point-triangle distances at the plane
    positions `gx` ((..., 3), broadcastable over the leading 9-axis) and
    adopt strict improvements (check_neighbour, makelevelset3.cpp:90-97).

    Shared by the single-device scan and the sharded scan
    (parallel/sharded._sharded_propagate) so their arithmetic — including
    the argmin tie order — is identical."""
    valid = cand_tid >= 0
    tv = tri_verts[jnp.maximum(cand_tid, 0)]  # (9, ..., 3verts, 3)
    d2 = point_triangle_distance_sq(gx, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :])
    d2 = jnp.where(valid, d2, jnp.float32(jnp.inf))
    amin = jnp.argmin(d2, axis=0)
    dmin2 = jnp.take_along_axis(d2, amin[None], axis=0)[0]
    best_tid = jnp.take_along_axis(cand_tid, amin[None], axis=0)[0]
    d = jnp.sqrt(dmin2)
    better = d < cur_phi  # strict, like check_neighbour (:97)
    new_phi = jnp.where(better, d, cur_phi)
    new_tid = jnp.where(better, best_tid, cur_tid)
    return new_phi, new_tid


def _sweep_axis(phi, tid, tri_verts, pos_axes, axis, reverse):
    """One directional plane-scan along `axis`. phi/tid are (ni, nj, nk)."""
    phi_t = jnp.moveaxis(phi, axis, 0)
    tid_t = jnp.moveaxis(tid, axis, 0)

    other = [a for a in range(3) if a != axis]
    pos_b = pos_axes[other[0]]  # (nB,) f32 world coords
    pos_c = pos_axes[other[1]]
    pos_a = pos_axes[axis]  # (nA,)

    # in-plane world positions, axis order (b, c) + placeholder for axis coord
    B, Cn = phi_t.shape[1], phi_t.shape[2]
    pb = jnp.broadcast_to(pos_b[:, None], (B, Cn))
    pc = jnp.broadcast_to(pos_c[None, :], (B, Cn))

    def step(carry, xs):
        prev_phi, prev_tid = carry
        cur_phi, cur_tid, a_coord = xs

        cand_tid = jnp.stack(
            [_shift_plane(prev_tid, dj, dk, jnp.int32(-1)) for dj, dk in _SHIFTS]
        )  # (9, B, C)

        coords = [None, None, None]
        coords[axis] = jnp.broadcast_to(a_coord, (B, Cn))
        coords[other[0]] = pb
        coords[other[1]] = pc
        gx = jnp.stack(coords, axis=-1)[None]  # (1, B, C, 3)

        new_phi, new_tid = plane_update(cand_tid, cur_phi, cur_tid,
                                        tri_verts, gx)
        return (new_phi, new_tid), (new_phi, new_tid)

    if reverse:
        phi_seq = phi_t[::-1]
        tid_seq = tid_t[::-1]
        pos_seq = pos_a[::-1]
    else:
        phi_seq = phi_t
        tid_seq = tid_t
        pos_seq = pos_a

    init = (phi_seq[0], tid_seq[0])
    (_, _), (out_phi, out_tid) = jax.lax.scan(
        step, init, (phi_seq[1:], tid_seq[1:], pos_seq[1:])
    )
    out_phi = jnp.concatenate([phi_seq[:1], out_phi], axis=0)
    out_tid = jnp.concatenate([tid_seq[:1], out_tid], axis=0)
    if reverse:
        out_phi = out_phi[::-1]
        out_tid = out_tid[::-1]
    return jnp.moveaxis(out_phi, 0, axis), jnp.moveaxis(out_tid, 0, axis)


@partial(jax.jit, static_argnames=("max_passes",))
def propagate_closest_triangles(
    phi: jnp.ndarray,  # (ni, nj, nk) f32, narrow-band seeded
    tid: jnp.ndarray,  # (ni, nj, nk) int32, -1 where unseeded
    tri_verts: jnp.ndarray,  # (M, 3, 3) f32
    origin: jnp.ndarray,  # (3,) f32
    dx: jnp.ndarray,  # () f32
    max_passes: int = 8,
):
    """Iterate directional plane scans until the closest-triangle field stops
    changing (or max_passes). Returns (phi, tid)."""
    ni, nj, nk = phi.shape
    pos_axes = tuple(
        jnp.arange(n, dtype=jnp.float32) * dx + origin[a]
        for a, n in enumerate((ni, nj, nk))
    )

    def one_pass(state):
        phi, tid, it, _ = state
        phi0 = phi
        for axis in (0, 1, 2):
            for reverse in (False, True):
                phi, tid = _sweep_axis(phi, tid, tri_verts, pos_axes, axis, reverse)
        changed = jnp.any(phi != phi0)
        return phi, tid, it + 1, changed

    def cond(state):
        _, _, it, changed = state
        return changed & (it < max_passes)

    state = (phi, tid, jnp.int32(0), jnp.bool_(True))
    phi, tid, _, _ = jax.lax.while_loop(cond, one_pass, state)
    return phi, tid


# ---------------------------------------------------------------------------
# Eikonal mode (CUDA-backend semantics)
# ---------------------------------------------------------------------------


def _axis_min_neighbors(phi):
    """Per-axis min of the two face neighbors, edge-padded with +inf."""
    inf = jnp.float32(jnp.inf)
    mins = []
    for axis in range(3):
        lo = jnp.concatenate(
            [
                jnp.full_like(jnp.take(phi, jnp.array([0]), axis), inf),
                jnp.moveaxis(jnp.moveaxis(phi, axis, 0)[:-1], 0, axis),
            ],
            axis=axis,
        )
        hi = jnp.concatenate(
            [
                jnp.moveaxis(jnp.moveaxis(phi, axis, 0)[1:], 0, axis),
                jnp.full_like(jnp.take(phi, jnp.array([0]), axis), inf),
            ],
            axis=axis,
        )
        mins.append(jnp.minimum(lo, hi))
    return mins


def eikonal_far_field_impl(phi, frozen, dx, num_iters: int,
                           extend_fn=None):
    """Jacobi relaxation of |grad phi| = 1 outside the frozen narrow band.

    Mirrors fast_sweep_eikonal_kernel (gpu_lib/makelevelset3_gpu.cu:487-551):
    sort the axiswise min neighbors a<=b<=c and apply the closed-form 1D/2D/3D
    updates; `num_iters` plays the role of the 2*max(n) iteration loop
    (makelevelset3_gpu.cu:690).

    `extend_fn(p, axis)` (sharded blocks): returns `p` extended by ONE cell
    on each side of `axis` (1=j, 2=k) with true neighbor-shard values (+inf
    at global edges). The Jacobi update then reads exactly what the
    single-device stencil reads, so shard runs match bit-for-bit; the
    (unsharded) i axis keeps the local inf-padded stencil.
    """
    dx = jnp.float32(dx)

    def body(_, p):
        if extend_fn is not None:
            # unused axes of _axis_min_neighbors are dead-code-eliminated
            mi = _axis_min_neighbors(p)[0]
            ej = extend_fn(p, 1)
            ek = extend_fn(p, 2)
            mj = jnp.minimum(ej[:, :-2, :], ej[:, 2:, :])
            mk = jnp.minimum(ek[:, :, :-2], ek[:, :, 2:])
            m = (mi, mj, mk)
        else:
            m = _axis_min_neighbors(p)
        abc = jnp.sort(jnp.stack(m, axis=-1), axis=-1)
        a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]
        # 1D update
        x1 = a + dx
        # 2D update (valid when x1 > b)
        s2 = 2.0 * dx * dx - (a - b) ** 2
        x2 = 0.5 * (a + b + jnp.sqrt(jnp.maximum(s2, 0.0)))
        # 3D update (valid when x2 > c)
        ss = a + b + c
        s3 = ss * ss - 3.0 * (a * a + b * b + c * c - dx * dx)
        x3 = (ss + jnp.sqrt(jnp.maximum(s3, 0.0))) / 3.0
        upd = jnp.where(x1 <= b, x1, jnp.where(x2 <= c, x2, x3))
        upd = jnp.where(jnp.isfinite(a), upd, p)  # isolated cell: keep
        new = jnp.minimum(p, upd)
        return jnp.where(frozen, p, new)

    return jax.lax.fori_loop(0, num_iters, body, phi)


@partial(jax.jit, static_argnames=("num_iters",))
def eikonal_far_field(phi, frozen, dx, num_iters: int):
    """Jitted single-device wrapper over `eikonal_far_field_impl`."""
    return eikonal_far_field_impl(phi, frozen, dx, num_iters)
