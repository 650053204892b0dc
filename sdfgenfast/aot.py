"""AOT warm-start artifacts: skip Python re-tracing on repeat runs.

The fused blob-core programs (`pipeline._exact_blob_core`,
`pipeline._dense_sign_blob_core`) are re-traced and re-lowered to StableHLO
in every fresh process — Pallas kernel bodies included — even when the XLA
executable itself is a persistent-compile-cache hit (the reference pays
0 s to first result, `app/main.cpp` runs immediately; this layer is how a
compiled-runtime framework approaches that).

`jax.export` captures the traced StableHLO once into a small artifact. A
fresh process deserializes it in milliseconds and goes straight to XLA
compilation, which is itself a persistent-cache hit. The kernels lower to
custom calls that export does not vouch for; the targets found in the
lowered module are exempted from its safety check.

Layout: `<jax_compilation_cache_dir>/aot/<sha256 key>.bin`. The key
covers the jax version, backend platform + device kind, the function
name, every static argument, and the input avals — anything that would
change the traced program. Artifacts from other jax versions fail
deserialization and are transparently re-exported.

Every path falls back to the direct jit call on any failure: no artifact
dir configured, export-unsupported features, version skew, or a corrupt
file (deleted and rebuilt). The cache is OFF unless
`jax.config.jax_compilation_cache_dir` is set (`setup_compile_cache`, which
the CLI, bench.py and chip_smoke.py call, sets it; library users opt in the
same way they opt into jax's own cache). SDFGENFAST_NO_AOT=1 turns it off.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import re
import tempfile
import threading
import warnings

import jax

__all__ = ["call_aot", "clear_memo", "setup_compile_cache"]

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def setup_compile_cache() -> str | None:
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR when the
    environment sets it (JAX reads it itself; set empty to disable), else
    `<repo>/.jax_cache`. Returns the directory in use (None: disabled)."""
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return os.environ["JAX_COMPILATION_CACHE_DIR"] or None
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return REPO_CACHE

_memo: dict = {}  # key -> jitted Exported.call, or None after a failure
_lock = threading.Lock()
_code_salt_cache = None


def _code_salt() -> str:
    """Hash of every .py source in this package: an edit anywhere in the
    package invalidates all artifacts (conservative — the traced program
    depends on a subset of the sources, but a stale artifact silently
    serving an OLD program is the one failure mode this layer must never
    have). Computed once per process (~ms)."""
    global _code_salt_cache
    if _code_salt_cache is None:
        h = hashlib.sha256()
        pkg = os.path.dirname(os.path.abspath(__file__))
        for root, _dirs, files in sorted(os.walk(pkg)):
            for f in sorted(files):
                if f.endswith(".py"):
                    with open(os.path.join(root, f), "rb") as fh:
                        h.update(fh.read())
        _code_salt_cache = h.hexdigest()
    return _code_salt_cache


def _aot_dir():
    base = jax.config.jax_compilation_cache_dir
    if not base:
        return None
    d = os.path.join(base, "aot")
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    return d


def _key(name: str, static_kwargs: dict, args) -> str:
    dev = jax.devices()[0]
    parts = [
        jax.__version__,
        _code_salt(),
        dev.platform,
        getattr(dev, "device_kind", ""),
        name,
        repr(sorted(static_kwargs.items())),
        repr([(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(args)]),
    ]
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()


def clear_memo():
    """Drop the in-process Exported memo (tests)."""
    with _lock:
        _memo.clear()


def enabled() -> bool:
    if os.environ.get("SDFGENFAST_NO_AOT"):
        return False
    # jax.export serializes through flatbuffers, which not every
    # installation carries
    if importlib.util.find_spec("flatbuffers") is None:
        return False
    return _aot_dir() is not None


def call_aot(jit_fn, name: str, static_kwargs: dict, *args):
    """Run ``jit_fn(*args, **static_kwargs)`` through the artifact cache.

    On the first-ever call for a (function, statics, avals) signature the
    function is traced once, exported to disk, and executed via the
    exported module (so the XLA persistent-cache entry matches what every
    later process will compile). Repeat processes deserialize the
    artifact instead of re-tracing. Any failure falls back to the plain
    jit call."""
    if not enabled():
        return jit_fn(*args, **static_kwargs)
    try:
        key = _key(name, static_kwargs, args)
    except Exception:
        return jit_fn(*args, **static_kwargs)

    with _lock:
        fn = _memo.get(key, False)
    if fn is None:  # failed before in this process: don't re-trace
        return jit_fn(*args, **static_kwargs)
    if fn is not False:
        return fn(*args)

    path = os.path.join(_aot_dir(), key + ".bin")
    exp = None
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                exp = jax.export.deserialize(f.read())
        except Exception:
            # version skew or a torn write: rebuild below
            try:
                os.unlink(path)
            except OSError:
                pass
            exp = None
    if exp is None:
        try:
            from functools import partial

            fn = jax.jit(partial(jit_fn, **static_kwargs))
            targets = set(re.findall(r"custom_call @([\w$.]+)",
                                     fn.lower(*args).as_text()))
            exp = jax.export.export(
                fn,
                disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(t)
                                 for t in sorted(targets)],
            )(*args)
            data = exp.serialize()
            fd, tmp = tempfile.mkstemp(dir=_aot_dir(), suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic vs concurrent writers
        except Exception as e:
            warnings.warn(f"AOT export of {name} failed ({e!r}); "
                          "calling it directly")
            with _lock:
                _memo[key] = None
            return jit_fn(*args, **static_kwargs)

    try:
        fn = jax.jit(exp.call)
        out = fn(*args)
    except Exception as e:
        warnings.warn(f"AOT artifact of {name} failed to run ({e!r}); "
                      "calling it directly")
        with _lock:
            _memo[key] = None
        return jit_fn(*args, **static_kwargs)
    with _lock:
        _memo[key] = fn
    return out
