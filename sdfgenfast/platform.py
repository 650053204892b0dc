"""Device and kernel-route resolution shared by every kernel switch.

One question, one answer: on which platform will the next computation run,
and which implementation of the hot kernels does that platform get?

  * ``"gpu"`` -> ``KERNEL``: the hand-written Pallas kernels, compiled
    through Triton (ops/dense.py, ops/band_pallas.py, ops/vdt_pallas.py);
  * ``"cpu"`` -> ``XLA``: the plain jnp forms of the same stages.

Any other platform raises. Interpret mode is never chosen here: only tests
ask for it, explicitly, through the kernels' ``interpret`` arguments.

`api.generate_sdf(backend="cpu")` pins the CPU device via
`jax.default_device` while the global backend stays the GPU, so the
*configured default device* wins over the global backend. Resolved OUTSIDE
jit so the jit cache keys reflect the actual route.
"""

from __future__ import annotations

import jax

__all__ = ["KERNEL", "XLA", "default_platform", "kernel_route"]

KERNEL = "kernel"
XLA = "xla"

_ROUTES = {"gpu": KERNEL, "cuda": KERNEL, "cpu": XLA}


def default_platform() -> str:
    """Platform computations run on by default, honoring jax.default_device.

    jax.default_device accepts a Device or a platform string (e.g.
    jax.default_device('cpu')); handle both forms.
    """
    dev = getattr(jax.config, "jax_default_device", None)
    if dev is None:
        return jax.default_backend()
    if isinstance(dev, str):
        return dev
    return getattr(dev, "platform", str(dev))


def kernel_route(platform: str | None = None) -> str:
    """``KERNEL`` on a GPU, ``XLA`` on the CPU; any other platform raises."""
    platform = default_platform() if platform is None else platform
    try:
        return _ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"unsupported platform {platform!r}: sdfgenfast runs on 'gpu' "
            "(Pallas kernels) or 'cpu' (plain XLA)") from None
