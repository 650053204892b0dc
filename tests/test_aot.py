"""Unit tests for the AOT warm-start artifact layer (sdfgenfast/aot.py).

The layer is exercised generically with a small jitted function (the
real consumers — the blob-core programs — engage it only on the GPU kernel
route; see pipeline.make_level_set3).
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfgenfast import aot


@partial(jax.jit, static_argnames=("scale",))
def _toy(x, *, scale):
    return (x * scale).sum(axis=1), x + scale


@pytest.fixture
def aot_cache(tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    aot.clear_memo()
    yield tmp_path
    jax.config.update("jax_compilation_cache_dir", prev)
    aot.clear_memo()


class TestCallAot:
    def test_matches_direct_call_and_writes_artifact(self, aot_cache):
        x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 8)),
                        jnp.float32)
        out = aot.call_aot(_toy, "toy", {"scale": 3}, x)
        ref = _toy(x, scale=3)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        files = os.listdir(aot_cache / "aot")
        assert len(files) == 1 and files[0].endswith(".bin")

    def test_second_process_path_deserializes(self, aot_cache):
        x = jnp.ones((4, 8), jnp.float32)
        aot.call_aot(_toy, "toy", {"scale": 2}, x)
        (artifact,) = (aot_cache / "aot").iterdir()
        stamp = artifact.stat().st_mtime_ns
        # simulate a fresh process: drop the in-memory memo; the artifact
        # must be REUSED (not re-exported)
        aot.clear_memo()
        out = aot.call_aot(_toy, "toy", {"scale": 2}, x)
        np.testing.assert_array_equal(np.asarray(out[1]), np.full((4, 8), 3.0))
        assert artifact.stat().st_mtime_ns == stamp

    def test_distinct_statics_get_distinct_artifacts(self, aot_cache):
        x = jnp.ones((4, 8), jnp.float32)
        aot.call_aot(_toy, "toy", {"scale": 2}, x)
        aot.call_aot(_toy, "toy", {"scale": 5}, x)
        assert len(list((aot_cache / "aot").iterdir())) == 2

    def test_corrupt_artifact_is_rebuilt(self, aot_cache):
        x = jnp.ones((2, 8), jnp.float32)
        aot.call_aot(_toy, "toy", {"scale": 2}, x)
        (artifact,) = (aot_cache / "aot").iterdir()
        artifact.write_bytes(b"not an artifact")
        aot.clear_memo()
        out = aot.call_aot(_toy, "toy", {"scale": 2}, x)
        np.testing.assert_array_equal(np.asarray(out[1]), np.full((2, 8), 3.0))
        # rebuilt on disk with real contents
        (artifact2,) = (aot_cache / "aot").iterdir()
        assert artifact2.read_bytes() != b"not an artifact"

    def test_disabled_without_cache_dir(self):
        prev = jax.config.jax_compilation_cache_dir
        jax.config.update("jax_compilation_cache_dir", None)
        try:
            assert not aot.enabled()
            x = jnp.ones((2, 8), jnp.float32)
            out = aot.call_aot(_toy, "toy", {"scale": 4}, x)
            np.testing.assert_array_equal(
                np.asarray(out[1]), np.full((2, 8), 5.0))
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)

    def test_kill_switch(self, aot_cache, monkeypatch):
        monkeypatch.setenv("SDFGENFAST_NO_AOT", "1")
        x = jnp.ones((2, 8), jnp.float32)
        aot.call_aot(_toy, "toy", {"scale": 2}, x)
        assert not (aot_cache / "aot").exists() \
            or not list((aot_cache / "aot").iterdir())

    def test_failed_export_is_not_retried(self, aot_cache, monkeypatch):
        # a failed export falls back to the direct call once per process:
        # later calls must not pay the re-trace again
        calls = []

        def broken_export(*a, **k):
            calls.append(1)
            raise ImportError("no serializer")

        monkeypatch.setattr(jax.export, "export", broken_export)
        x = jnp.ones((2, 8), jnp.float32)
        with pytest.warns(UserWarning):
            out = aot.call_aot(_toy, "toy", {"scale": 7}, x)
        out = aot.call_aot(_toy, "toy", {"scale": 7}, x)
        np.testing.assert_array_equal(np.asarray(out[1]), np.full((2, 8), 8.0))
        assert len(calls) == 1

    def test_disabled_without_serializer(self, aot_cache, monkeypatch):
        import importlib.util

        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda n, *a: None if n == "flatbuffers"
                            else real(n, *a))
        assert not aot.enabled()
