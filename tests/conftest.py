"""Test harness config: force the JAX CPU platform with 8 virtual devices so
multi-device sharding logic is exercised without accelerator hardware — the
strategy SURVEY.md §4 prescribes (the reference analogously skips GPU
asserts at runtime, python/tests/test_sdfgen.py:244-246).

The config is also flipped after import, in case a site hook imported jax
before pytest started. Tests marked `gpu` need a CUDA device; the `gpu`
fixture skips them elsewhere (run them with `python -m pytest -m gpu` on a
GPU host, without JAX_PLATFORMS=cpu)."""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


RESOURCES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources")

# Deterministically regenerable large meshes (STL stores 3 verts/triangle,
# ~4-5 MB each — regenerated on demand instead of committed)
_REGEN = {
    "icosphere6.stl": lambda m: m.icosphere(
        6, radius=1.0, center=(0.04, -0.03, 0.02)),
    "icosphere6_origin.stl": lambda m: m.icosphere(6, radius=1.0),
    "icosphere.stl": lambda m: m.icosphere(
        3, radius=1.0, center=(0.05, -0.02, 0.03)),
}


def ensure_resource(name: str) -> str:
    """Path to a test resource, regenerating the known large meshes."""
    path = os.path.join(RESOURCES, name)
    if not os.path.exists(path) and name in _REGEN:
        from sdfgenfast import mesh as mesh_mod
        from sdfgenfast.io import mesh_io as mio

        mio.save_stl(path, _REGEN[name](mesh_mod))
    return path


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none. Tests that
    use it carry the `gpu` marker."""
    try:
        devs = jax.local_devices(backend="gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu)")
    return devs[0]
