"""Device and kernel-route resolution (sdfgenfast/platform.py)."""

import jax
import pytest

from sdfgenfast import platform


@pytest.mark.parametrize("name, route", [
    ("cpu", platform.XLA), ("gpu", platform.KERNEL), ("cuda", platform.KERNEL),
])
def test_route_per_platform(name, route):
    assert platform.kernel_route(name) == route


@pytest.mark.parametrize("name", ["rocm", "metal", "METAL"])
def test_other_platforms_raise(name):
    with pytest.raises(RuntimeError):
        platform.kernel_route(name)


def test_default_device_wins_over_backend():
    # api.generate_sdf(backend="cpu") pins the CPU device this way while the
    # global backend may be a GPU
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        assert platform.default_platform() == "cpu"
        assert platform.kernel_route() == platform.XLA
    with jax.default_device("cpu"):
        assert platform.kernel_route() == platform.XLA
