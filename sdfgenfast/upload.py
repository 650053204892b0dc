"""Single-blob host->device upload of the binning products.

The pipeline's inputs (verts, tris, CSR candidate segments, tile
offsets/counts/ids, parity, origin, dx) would otherwise be ~8 separate
host->device transfers per call, each with its fixed cost. Packing them
into ONE uint8 blob pays that cost once. The layout was chosen for a
remote device link with a large fixed cost per transfer; whether it still
pays on a local GPU is not measured yet (ROADMAP C).

Two unpack modes:

- ``pack_device_blob(arrays)``: device_put the blob AND dispatch one
  jitted unpack now; returns the typed device arrays. Used by paths that
  feed arrays into several separate programs (the differentiable stages).
- ``pack_device_blob(arrays, unpack_now=False)``: device_put only;
  returns ``{"__blob__": dev_blob, "__meta__": metas}``. The consuming
  core jit calls ``unpack_blob(blob, metas)`` INSIDE its own trace —
  zero extra dispatches, and XLA fuses the slices/bitcasts into
  the consumers. This is the hot path (``pipeline._exact_blob_core`` /
  ``_dense_sign_blob_core``).

`bin_mesh` calls this once per binning and stores the result in
`Binned.device`; repeated evaluations with a cached binning skip the
upload entirely.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_device_blob", "pack_blob_host", "unpack_blob"]

_ALIGN = 128


def pack_blob_host(arrays: dict):
    """Concatenate a dict of NumPy arrays into (blob uint8, metas tuple).

    bool is transported as uint8 (bitcast targets need fixed widths) and
    converted back by `unpack_blob`.
    """
    metas = []
    parts = []
    off = 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        was_bool = a.dtype == np.bool_
        if was_bool:
            a = a.astype(np.uint8)
        flat = a.view(np.uint8).ravel()
        metas.append((k, a.dtype.str, a.shape, off, len(flat), was_bool))
        parts.append(flat)
        pad = (-len(flat)) % _ALIGN
        if pad:
            parts.append(np.zeros(pad, np.uint8))
        off += len(flat) + pad
    if not parts:
        return np.zeros((0,), np.uint8), tuple(metas)
    return np.concatenate(parts), tuple(metas)


def unpack_blob(blob, meta):
    """Slice+bitcast the typed arrays back out of a blob — TRACEABLE: call
    inside a jit (the hot cores) or through the jitted wrapper below."""
    import jax
    import jax.numpy as jnp

    out = {}
    for k, dstr, shape, o, ln, was_bool in meta:
        dt = np.dtype(dstr)
        piece = jax.lax.slice(blob, (o,), (o + ln,))
        if dt.itemsize > 1:
            piece = jax.lax.bitcast_convert_type(
                piece.reshape(-1, dt.itemsize), jnp.dtype(dt))
        else:
            piece = piece.view(jnp.dtype(dt))
        arr = piece.reshape(shape)
        if was_bool:
            arr = arr.astype(jnp.bool_)
        out[k] = arr
    return out


_unpack_jit = None


def unpack_device_dict(dev: dict) -> dict:
    """Materialize the typed arrays of a {"__blob__", "__meta__"} dict
    IN PLACE (one jitted dispatch, cached across calls); idempotent."""
    if "__blob__" not in dev:
        return dev
    if len(dev) > 2:  # already materialized
        return dev
    global _unpack_jit
    if _unpack_jit is None:
        import jax
        from functools import partial

        @partial(jax.jit, static_argnames=("meta",))
        def _unp(b, *, meta):
            vals = unpack_blob(b, meta)
            return tuple(vals[m[0]] for m in meta)

        _unpack_jit = _unp
    meta = dev["__meta__"]
    vals = _unpack_jit(dev["__blob__"], meta=meta)
    dev.update({m[0]: v for m, v in zip(meta, vals)})
    return dev


def pack_device_blob(arrays: dict, unpack_now: bool = True):
    """Upload a dict of NumPy arrays as one blob.

    unpack_now=True: dispatch one jitted unpack; returns typed jnp arrays.
    unpack_now=False: returns {"__blob__", "__meta__"} for in-jit unpack.
    """
    import jax
    import jax.numpy as jnp
    from functools import partial

    blob_np, metas = pack_blob_host(arrays)
    if not metas:
        return {}
    blob = jnp.asarray(blob_np)
    if not unpack_now:
        return {"__blob__": blob, "__meta__": metas}

    @partial(jax.jit, static_argnames=("meta",))
    def unpack(b, *, meta):
        vals = unpack_blob(b, meta)
        return tuple(vals[m[0]] for m in meta)

    vals = unpack(blob, meta=metas)
    return {m[0]: v for m, v in zip(metas, vals)}
