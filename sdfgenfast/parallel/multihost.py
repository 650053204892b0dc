"""Multi-host (multi-process) execution: the DCN scale-out layer.

The reference is strictly single-process (SURVEY §5: no MPI/NCCL/Gloo —
`cudaMemcpy` is its only device communication). Here the SAME `shard_map`
pipeline from ``parallel/sharded.py`` runs unchanged over a device mesh
that spans multiple hosts — XLA routes the halo ``ppermute``/``psum``
collectives over NVLink within a host and the network across hosts.

Design:
- ``initialize`` wraps ``jax.distributed.initialize`` (idempotent guard).
- Binning stays REPLICATED: every process runs the same host-side NumPy
  binning on the same mesh (deterministic), so no host-side communication is
  needed; each process then materializes the global, mesh-sharded device
  arrays from its local copy via ``make_global_array``.
- ``sharded_sdf_multihost`` drives the identical ``_sharded_core`` program;
  the returned phi is a global array — use ``fetch_global`` (an allgather)
  to get the assembled NumPy grid on every process.

Tested by ``tests/test_multihost.py``, which spawns 2 real processes with 4
virtual CPU devices each (8 global devices) and asserts exact equality with
the single-process 8-device result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharded import ShardedBinned, _sharded_core, bin_mesh_sharded, sharded_sdf
from ..platform import KERNEL, kernel_route

__all__ = [
    "initialize",
    "global_device_mesh",
    "make_global_array",
    "fetch_global",
    "sharded_sdf_multihost",
]

_initialized = False


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_ids=None) -> None:
    """Join the multi-process JAX runtime (DCN coordination layer).

    The explicit form serves GPU clusters (nothing tells JAX of the
    cluster otherwise) and the 2-process CPU simulation the tests use."""
    global _initialized
    if _initialized:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True


def global_device_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A (j, k) mesh over ALL processes' devices (jax.devices() is global)."""
    devices = jax.devices()
    n = len(devices)
    if shape is None:
        dj = int(np.sqrt(n))
        while n % dj:
            dj -= 1
        shape = (dj, n // dj)
    return Mesh(np.asarray(devices).reshape(shape), axis_names=("j", "k"))


def make_global_array(host_array: np.ndarray, mesh: Mesh, spec: P):
    """Build a global jax.Array from an identical replicated host copy.

    Every process holds the full `host_array` (replicated binning); each
    device extracts its own shard locally — no cross-host transfer."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )


def fetch_global(global_array) -> np.ndarray:
    """Assemble a (possibly cross-host) global array on every process."""
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return np.asarray(global_array)
    return np.asarray(multihost_utils.process_allgather(global_array, tiled=True))


def sharded_sdf_multihost(binned: ShardedBinned, mesh: Mesh, verts: np.ndarray):
    """Run the sharded pipeline over a (possibly multi-host) mesh.

    Identical compute to ``sharded_sdf``; inputs are materialized as global
    mesh-sharded arrays first (required in multi-controller mode, where a
    plain numpy argument to a sharded jit is rejected). Returns the raw
    (Dj, Dk, ni, nj_l, nk_l) block array, still device-sharded; pass through
    ``fetch_global`` + ``assemble_blocks`` for the dense grid."""
    from ..pipeline import use_dense
    from ..ops import vdt as vdt_ops
    from .sharded import _validate_pyramid_blocks

    cfg = binned.config
    if cfg.far_field not in ("exact", "eikonal"):
        raise NotImplementedError(
            "sharded pipeline supports far_field='exact' and 'eikonal'")
    v = jnp.asarray(verts)
    tri_verts = v[jnp.asarray(binned.tris)]

    blk2 = P("j", "k", None)
    blk3 = P("j", "k", None, None)
    blk4 = P("j", "k", None, None, None)
    rep = P()

    dense = use_dense(cfg, len(binned.tris))
    ni, nj_l, nk_l = binned.block
    Dj, Dk = binned.dims
    gdims = (ni, nj_l * Dj, nk_l * Dk)
    eikonal = cfg.far_field == "eikonal"
    propagate = cfg.far_field == "propagate" and not dense
    prop_passes = cfg.max_passes if propagate else 0
    eik_iters = 0
    if eikonal:
        eik_iters = (cfg.eikonal_iters if cfg.eikonal_iters is not None
                     else 2 * max(gdims))
    pyramid = (not dense and not eikonal and not propagate
               and cfg.vdt_max_hop is None
               and cfg.vdt_extra_rounds is None)
    strides = ()
    if pyramid:
        _validate_pyramid_blocks(gdims, binned.block, binned.dims)
    elif not dense and not eikonal and not propagate:
        cap = cfg.vdt_max_hop
        if cap is None or cap > min(nj_l, nk_l):
            raise ValueError(
                "the capped-ladder sharded mode needs config.vdt_max_hop "
                f"<= the shard block (min(nj_l, nk_l) = {min(nj_l, nk_l)})"
            )
        extra = cfg.vdt_extra_rounds
        if extra is None:
            extra = 2 if max(gdims) <= 256 else 4
        strides = vdt_ops.stride_ladder(
            max(gdims), max_hop=cap, extra_rounds=extra,
        )
    use_pallas = (pyramid and binned.csr_pair is not None
                  and kernel_route() == KERNEL)
    b_ids = make_global_array(binned.band_ids, mesh, blk2)
    dummy2 = np.zeros((Dj, Dk, 0), np.int32)
    if use_pallas:
        b_cand = make_global_array(
            np.zeros((Dj, Dk, 0, 1), np.int32), mesh, blk3)
        b_valid = make_global_array(
            np.zeros((Dj, Dk, 0, 1), bool), mesh, blk3)
        c_pair = make_global_array(binned.csr_pair, mesh, blk2)
        c_off = make_global_array(binned.csr_off, mesh, blk2)
        c_cnt = make_global_array(binned.csr_cnt, mesh, blk2)
        c_gids = make_global_array(binned.band_gids, mesh, blk2)
    else:
        b_cand = make_global_array(binned.band_cand, mesh, blk3)
        b_valid = make_global_array(binned.band_valid, mesh, blk3)
        c_pair = make_global_array(dummy2, mesh, blk2)
        c_off = make_global_array(dummy2, mesh, blk2)
        c_cnt = make_global_array(dummy2, mesh, blk2)
        c_gids = make_global_array(dummy2, mesh, blk2)
    packed = make_global_array(binned.parity_packed, mesh, blk4)
    tv = make_global_array(np.asarray(tri_verts), mesh, rep)
    origin = make_global_array(
        np.asarray(binned.grid.origin, np.float32), mesh, rep
    )
    sign_device = binned.sign_ids is not None
    Dj, Dk = binned.dims
    if sign_device:
        s_ids = make_global_array(binned.sign_ids, mesh, blk2)
        s_cand = make_global_array(binned.sign_cand, mesh, blk3)
        s_valid = make_global_array(binned.sign_valid, mesh, blk3)
        fh = make_global_array(binned.f_hi, mesh, rep)
        fl = make_global_array(binned.f_lo, mesh, rep)
    else:
        s_ids = make_global_array(dummy2, mesh, blk2)
        s_cand = make_global_array(
            np.zeros((Dj, Dk, 0, 1), np.int32), mesh, blk3)
        s_valid = make_global_array(
            np.zeros((Dj, Dk, 0, 1), bool), mesh, blk3)
        fh = make_global_array(np.zeros((0, 3, 3), np.float32), mesh, rep)
        fl = make_global_array(np.zeros((0, 3, 3), np.float32), mesh, rep)

    return _sharded_core(
        tv, b_ids, b_cand, b_valid, packed,
        origin, jnp.float32(binned.grid.dx),
        c_pair, c_off, c_cnt, c_gids,
        s_ids, s_cand, s_valid, fh, fl,
        sign_device=sign_device, tile2d_shape=cfg.tile2d_shape,
        sign_tiles_local=binned.sign_tiles_local, sign_chunk=cfg.sign_chunk,
        propagate_passes=prop_passes,
        mesh_obj=mesh, block=binned.block,
        band_tiles_local=binned.band_tiles_local, tile_shape=cfg.tile_shape,
        band_chunk=cfg.band_chunk, strides=strides,
        chamfer_passes=cfg.chamfer_passes,
        seed_band=max(cfg.exact_band, 3),
        dense=dense,
        skip_recompute=True,
        pyramid=pyramid,
        use_pallas=use_pallas,
        route=kernel_route(),
        gdims=gdims,
        band_tiles_global=binned.band_tiles_global,
        eikonal_iters=eik_iters,
    )


def assemble_blocks(blocks: np.ndarray) -> np.ndarray:
    """(Dj, Dk, ni, nj_l, nk_l) -> (ni, nj, nk)."""
    Dj, Dk, ni, nj_l, nk_l = blocks.shape
    return np.transpose(blocks, (2, 0, 3, 1, 4)).reshape(ni, Dj * nj_l, Dk * nk_l)
