"""Dense all-triangles distance field: a Pallas (Triton) kernel and its
plain-XLA twin.

For meshes with few triangles (the reference's own headline benchmark mesh
has 36, ``tests/benchmark_performance.cpp:151``) the tile-JFA machinery is
pure overhead: evaluating EVERY cell against EVERY triangle is cheaper than
one JFA round, produces the mathematically exact unsigned distance field
everywhere (strictly stronger than the reference's propagated far field,
``cpu_lib/makelevelset3.cpp:243-292``), and compiles in seconds instead of
minutes because the program is one small kernel instead of an unrolled
26-offset x strides JFA cascade.

Separable evaluation. The grid is laid out as (ni*nj, nk) — row r is the
(i, j) = (r // nj, r % nj) cell column, k runs along the other axis. Every
affine-in-p quantity of the point-triangle distance (plane distance h,
barycentric weights w23/w31/w12, per-edge segment parameters s) therefore
SPLITS into a row part (a function of x(i), y(j) only) and a k part (a
function of z(k) only), each costing ONE broadcast add on the full block
instead of a 3-D dot product per (cell, triangle). Edge distances keep the
reference's cancellation-free difference form dd = (p - x2) - s*(x1 - x2)
(``cpu_lib/makelevelset3.cpp:21-34``), so outputs match the reference
operation order to a few ulps — NOT an approximate/ranking-only evaluation.
Per-triangle constants come from a precomputed (40, M) coefficient table.

Two implementations share that math (`_sep_d2`):

* ``_dense_kernel`` (GPU route): one program per (rows x k) block, a loop
  over all triangles with min + argmin in registers, and a per-block
  plane-bound cull that skips a triangle's remaining ~30 ops when its plane
  distance already loses at every cell of the block — XLA cannot express
  that data-dependent skip.
* ``_dense_xla`` (CPU route, and the plain contender on the GPU): the same
  expression broadcast over (M, rows, nk) and reduced over triangles.

Both: ties keep the lowest triangle id (strict ``<`` / first argmin),
matching the reference's first-wins tie-break
(``cpu_lib/makelevelset3.cpp:215-218``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["dense_distance_field", "DENSE_MAX_TRIS"]

# Above DENSE_MAX_TRIS the tiled band+JFA path wins (dense cost scales as
# cells x tris).
DENSE_MAX_TRIS = 1024

_NC = 40  # rows in the coefficient table
_BLOCK_CELLS = 1024  # cells per kernel program (rows x k block)

def _sep_coefs(tri_verts):
    """(M, 3, 3) f32 -> (40, M) f32 per-triangle coefficient table.

    Row layout (all affine forms are in GLOBAL world coordinates p):
      0:3   b            (vertex 2 — the x2 endpoint of edge ab)
      3:6   c            (vertex 3 — the x2 endpoint of edges ac, bc)
      6:9   w_ab = a-b   (x1-x2 of edge ab; dd = (p-x2) - s*(x1-x2))
      9:12  w_ac = a-c
      12:15 w_bc = b-c
      15:19 s_ab affine [ex, ey, ez, e0]: s_raw = e . p + e0, the reference's
            dot(x2-x0, x2-x1)/mag2 (cpu_lib/makelevelset3.cpp:24) expanded
      19:23 s_ac affine
      23:27 s_bc affine
      27:31 h affine [nx, ny, nz, h0]: signed plane distance via unit normal
      31:35 w23 affine [gx, gy, gz, g0]: barycentric weight on vertex a,
            invdet*(m23*pa - d*pb) (makelevelset3.cpp:55-57) expanded in p
      35:39 w31 affine
      39    degenerate flag: 1.0 for (near-)zero-area triangles (cr2 <=
            1e-30, the same threshold at which the barycentric invdet
            clamps — det == cr2 by the Lagrange identity), else 0.0. The
            kernel forces inside=False for flagged triangles so they fall
            through to the (correct) edge/point distance, exactly like the
            reference's outside branch (cpu_lib/makelevelset3.cpp:62-70).
    """
    a = tri_verts[:, 0, :]
    b = tri_verts[:, 1, :]
    c = tri_verts[:, 2, :]

    def edge(x1, x2):
        w = x1 - x2  # dd = (p - x2) - s*w
        m2 = jnp.sum(w * w, axis=-1)
        inv = 1.0 / jnp.maximum(m2, jnp.float32(1e-30))
        e = w * inv[:, None]  # s_raw = dot(x2-x0, x2-x1)/m2 = e.p + e0
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

    return jnp.concatenate(
        [
            b.T, c.T,                                   # 0:6
            w_ab.T, w_ac.T, w_bc.T,                     # 6:15
            e_ab.T, e0_ab[None], e_ac.T, e0_ac[None], e_bc.T, e0_bc[None],  # 15:27
            n.T, h0[None],                              # 27:31
            g23.T, g23c[None], g31.T, g31c[None],       # 31:39
            degen[None],                                # 39
        ],
        axis=0,
    )


def _sep_d2(cf, x, y, z):
    """Squared point-triangle distance from the separable coefficients.

    `cf(i)` returns coefficient row i (a scalar in the kernel, an (M, 1, 1)
    column on the XLA route); x, y vary along rows only, z along k only.
    Returns (d2, din): the distance and the plane-distance lower bound."""
    # row / k halves of the plane distance
    hu = cf(27) * x + (cf(28) * y + cf(30))
    hv = cf(29) * z
    h = hu + hv
    din = h * h

    w23u = cf(31) * x + (cf(32) * y + cf(34))
    w23v = cf(33) * z
    w31u = cf(35) * x + (cf(36) * y + cf(38))
    w31v = cf(37) * z
    w12u = 1.0 - w23u - w31u
    w12v = -(w23v + w31v)

    # u = p - x2 per edge endpoint (b for edge ab; c for ac, bc)
    ubx = x - cf(0)
    uby = y - cf(1)
    ubz = z - cf(2)
    ucx = x - cf(3)
    ucy = y - cf(4)
    ucz = z - cf(5)

    w23 = w23u + w23v
    w31 = w31u + w31v
    w12 = w12u + w12v
    # degenerate triangles (cf(39) == 1) have meaningless normals and
    # clamped barycentric weights: force the outside branch so they get
    # their exact edge/point distance (makelevelset3.cpp:62-70)
    inside = (jnp.minimum(jnp.minimum(w23, w31), w12) >= 0.0) & (
        cf(39) < 0.5)

    def edge_d2(su, sv, wx, wy, wz, ux, uy, uz):
        s = jnp.clip(su + sv, 0.0, 1.0)
        ddx = ux - s * wx
        ddy = uy - s * wy
        ddz = uz - s * wz
        return ddx * ddx + ddy * ddy + ddz * ddz

    d_ab = edge_d2(cf(15) * x + (cf(16) * y + cf(18)), cf(17) * z,
                   cf(6), cf(7), cf(8), ubx, uby, ubz)
    d_ac = edge_d2(cf(19) * x + (cf(20) * y + cf(22)), cf(21) * z,
                   cf(9), cf(10), cf(11), ucx, ucy, ucz)
    d_bc = edge_d2(cf(23) * x + (cf(24) * y + cf(26)), cf(25) * z,
                   cf(12), cf(13), cf(14), ucx, ucy, ucz)
    # min over all 3 edges == min over the region's 2 edges: the boundary
    # distance is what both compute (makelevelset3.cpp:62-69 picks 2 as an
    # optimization; the third edge can never undercut the boundary).
    d_edge = jnp.minimum(d_ab, jnp.minimum(d_ac, d_bc))
    return jnp.where(inside, din, d_edge), din


def _cell_coords(r, k, nj, off, dx):
    """Grid-local world positions of rows r = i*nj + j and k indices."""
    ci = r // nj + off[0]
    cj = r - (r // nj) * nj + off[1]
    ck = k + off[2]
    # exactly as the reference: f32(i) * f32(dx) (makelevelset3.cpp:214),
    # in grid-local coordinates (the origin is folded into the table)
    return (ci.astype(jnp.float32) * dx, cj.astype(jnp.float32) * dx,
            ck.astype(jnp.float32) * dx)


def _dense_kernel(dx_ref, off_ref, coef_ref, d_ref, tid_ref, *,
                  nj, rows, nk, m, br, bk):
    r = pl.program_id(0) * br + jax.lax.broadcasted_iota(
        jnp.int32, (br, 1), 0)
    k = pl.program_id(1) * bk + jax.lax.broadcasted_iota(
        jnp.int32, (1, bk), 1)
    off = (off_ref[0], off_ref[1], off_ref[2])
    x, y, z = _cell_coords(r, k, nj, off, dx_ref[0])

    def tri_step(t, carry):
        cf = lambda i: coef_ref[i, t]  # noqa: E731 — scalar load
        hu = cf(27) * x + (cf(28) * y + cf(30))
        h = hu + cf(29) * z
        # PLANE-BOUND CULL: |h| lower-bounds the triangle distance, so when
        # even the block's smallest h^2 exceeds its largest best-so-far the
        # triangle loses at every cell — skip the remaining ops. Degenerate
        # triangles have meaningless normals: never skip them.
        skippable = (cf(39) < 0.5) & (jnp.min(h * h) > jnp.max(carry[0]))

        def full_eval(carry):
            best_d2, best_t = carry
            d2, _ = _sep_d2(cf, x, y, z)
            better = d2 < best_d2
            return (jnp.where(better, d2, best_d2),
                    jnp.where(better, t, best_t))

        return jax.lax.cond(skippable, lambda c: c, full_eval, carry)

    init = (jnp.full((br, bk), jnp.inf, jnp.float32),
            jnp.full((br, bk), -1, jnp.int32))
    best_d2, best_t = jax.lax.fori_loop(0, m, tri_step, init)
    mask = (r < rows) & (k < nk)
    plgpu.store(d_ref.at[r, k], jnp.sqrt(best_d2), mask=mask)
    plgpu.store(tid_ref.at[r, k], best_t, mask=mask)


def block_shape(nk: int):
    """(rows, k) block of `_BLOCK_CELLS` cells: the power-of-two k extent
    (16..128) that pads nk least (ties: the wider one), rows the rest."""
    bk = min((128, 64, 32, 16), key=lambda b: (-(-nk // b) * b, -b))
    return _BLOCK_CELLS // bk, bk


def _dense_pallas(table, dxs, offs, *, nj, rows, nk, interpret):
    m = int(table.shape[1])
    br, bk = block_shape(nk)
    return pl.pallas_call(
        partial(_dense_kernel, nj=nj, rows=rows, nk=nk, m=m, br=br, bk=bk),
        grid=(pl.cdiv(rows, br), pl.cdiv(nk, bk)),
        out_shape=(jax.ShapeDtypeStruct((rows, nk), jnp.float32),
                   jax.ShapeDtypeStruct((rows, nk), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="sdf_dense",
    )(dxs.reshape(1), offs, table)


# cap on (triangles x cells) per reduction chunk on the XLA route: bounds
# the intermediate if the compiler materializes the broadcast
_XLA_CHUNK = 1 << 26


def _dense_xla(table, dxs, offs, *, nj, rows, nk):
    m = int(table.shape[1])
    cols = table[:, :, None, None]  # (40, M, 1, 1)
    cf = lambda i: cols[i]  # noqa: E731
    rc = max(1, min(rows, _XLA_CHUNK // max(1, m * nk)))
    n_chunks = -(-rows // rc)
    k = jnp.arange(nk, dtype=jnp.int32)[None, :]

    def chunk(r0):
        r = r0 + jnp.arange(rc, dtype=jnp.int32)[:, None]
        x, y, z = _cell_coords(r, k, nj, offs, dxs)
        d2, _ = _sep_d2(cf, x, y, z)  # (M, rc, nk)
        return jnp.sqrt(jnp.min(d2, axis=0)), jnp.argmin(d2, axis=0).astype(
            jnp.int32)

    starts = jnp.arange(n_chunks, dtype=jnp.int32) * rc
    if n_chunks == 1:
        d, tid = chunk(starts[0])
        return d, tid
    d, tid = jax.lax.map(chunk, starts)
    return (d.reshape(-1, nk)[:rows], tid.reshape(-1, nk)[:rows])


def dense_distance_field(tri_verts, origin, dx, *, grid_shape, ijk_offset=None,
                         route=None, interpret=False):
    """Exact min distance + argmin triangle id for every grid cell.

    tri_verts: (M, 3, 3) f32; origin: (3,) f32; dx: f32 scalar. `ijk_offset`
    ((3,) int32) shifts local block indices to global ones for sharded
    evaluation (cell coords use GLOBAL indices, so per-shard results are
    bit-identical to a single-device run). `route` is platform.KERNEL or
    platform.XLA (None: resolved from the default device); `interpret`
    runs the kernel in Pallas interpret mode (tests only).
    Returns (phi, tid): (ni, nj, nk) f32 unsigned distances and int32 ids.
    """
    from ..platform import KERNEL, kernel_route

    if route is None:
        route = kernel_route()
    if ijk_offset is None:
        ijk_offset = jnp.zeros((3,), jnp.int32)
    return _dense_impl(tri_verts, origin, dx, ijk_offset,
                       grid_shape=grid_shape,
                       kernel=interpret or route == KERNEL,
                       interpret=interpret)


@partial(jax.jit, static_argnames=("grid_shape", "kernel", "interpret"))
def _dense_impl(tri_verts, origin, dx, ijk_offset, *, grid_shape, kernel,
                interpret):
    ni, nj, nk = grid_shape
    m = int(tri_verts.shape[0])
    if m > DENSE_MAX_TRIS:
        raise ValueError(f"dense path capped at {DENSE_MAX_TRIS} triangles, got {m}")

    # Grid-local coordinates: subtracting the grid origin from the triangle
    # table once keeps every affine coefficient O(mesh extent) instead of
    # O(|origin|), so meshes modeled far from the world origin keep the
    # reference's difference-form accuracy (cells evaluate at x = i*dx).
    tri_local = tri_verts - origin.astype(tri_verts.dtype)
    table = _sep_coefs(tri_local)
    dxs = jnp.asarray(dx, jnp.float32).reshape(())  # accept (1,) blob dx
    offs = ijk_offset.astype(jnp.int32).reshape(3)
    rows = ni * nj
    if kernel:
        d, tid = _dense_pallas(table, dxs, offs, nj=nj, rows=rows, nk=nk,
                               interpret=interpret)
    else:
        d, tid = _dense_xla(table, dxs, offs, nj=nj, rows=rows, nk=nk)
    return d.reshape(grid_shape), tid.reshape(grid_shape)
