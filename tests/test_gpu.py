"""Compiled GPU kernels vs their plain XLA forms, on a CUDA device.

Marked `gpu`: skipped where there is no CUDA device. Run on a GPU host with
`python -m pytest -m gpu tests/` (without JAX_PLATFORMS=cpu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfgenfast import SDFConfig, make_level_set3
from sdfgenfast.grid import sizing_mode2a_proportional
from sdfgenfast.mesh import icosphere
from sdfgenfast.ops import vdt as V
from sdfgenfast.ops.dense import dense_distance_field
from sdfgenfast.ops.vdt_pallas import pallas_round_phase
from sdfgenfast.pipeline import band_seeds, bin_mesh
from sdfgenfast.platform import KERNEL, XLA

pytestmark = pytest.mark.gpu


def _grid(mesh, nx):
    mn, mx = mesh.bounds()
    return sizing_mode2a_proportional(mn, mx, nx, 1)


def test_dense_kernel_matches_xla(gpu):
    m = icosphere(2, radius=1.0, center=(0.02, -0.01, 0.03))
    g = _grid(m, 40)
    with jax.default_device(gpu):
        tv = jnp.asarray(m.verts)[jnp.asarray(m.tris.astype(np.int32))]
        o = jnp.asarray(g.origin, jnp.float32)
        a, b = (dense_distance_field(tv, o, jnp.float32(g.dx),
                                     grid_shape=g.shape, route=r)
                for r in (KERNEL, XLA))
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                                   rtol=1e-6, atol=1e-6)


def test_band_kernel_matches_xla(gpu):
    m = icosphere(4, radius=1.0)
    g = _grid(m, 64)
    with jax.default_device(gpu):
        b = bin_mesh(m, g, SDFConfig())
        bb, csr = b.band, b.band_csr
        args = (jnp.asarray(m.verts)[jnp.asarray(b.tris)],
                jnp.asarray(g.origin, jnp.float32), jnp.float32(g.dx),
                jnp.asarray(csr["ids"]), jnp.asarray(bb.cand),
                jnp.asarray(bb.cand_valid), jnp.asarray(csr["pair"]),
                jnp.asarray(csr["off"]), jnp.asarray(csr["cnt"]))
        st = dict(grid_shape=g.shape, tile_shape=bb.tile_shape,
                  tiles_dim=bb.tiles_dim)
        k, x = (band_seeds(*args, kernel=kern, **st) for kern in (True, False))
        np.testing.assert_allclose(np.asarray(k[0]), np.asarray(x[0]),
                                   rtol=1e-6, atol=1e-6)
        assert (np.asarray(k[1]) != np.asarray(x[1])).mean() < 0.02


@pytest.mark.parametrize("stride", [1, 8])
def test_round_kernel_matches_jnp(gpu, stride):
    rng = np.random.default_rng(stride)
    ni, nj, nk = 40, 33, 70
    dx = np.float32(0.02)
    st = np.full((5, ni, nj, nk), V.FAR, np.float32)
    idx = tuple(rng.integers(0, n, 3000) for n in (ni, nj, nk))
    for c in range(3):
        st[(c,) + idx] = idx[c] * dx + rng.normal(size=3000) * 0.1
    st[(3,) + idx] = rng.integers(0, 1 << 20, 3000).astype(np.int32).view(
        np.float32)
    with jax.default_device(gpu):
        pos = V._level_pos_axes((ni, nj, nk), dx, 1)
        s = jnp.asarray(st)
        s = s.at[4].set(V._dist2(*pos, s[0], s[1], s[2]))
        a = np.asarray(pallas_round_phase(s, dx, (stride,)))
        b = np.asarray(V._jacobi_round(s, *pos, stride,
                                       jnp.asarray(V._OFFSETS26)))
    np.testing.assert_allclose(a[4], b[4], rtol=5e-7)
    diff = (a[:4].view(np.int32) != b[:4].view(np.int32)).any(0)
    assert diff.mean() < 1e-3


def test_pipeline_on_gpu_matches_cpu(gpu):
    m = icosphere(3, radius=1.0, center=(0.03, -0.02, 0.01))
    g = _grid(m, 48)
    with jax.default_device(gpu):
        a = np.asarray(make_level_set3(m, g, SDFConfig()))
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        b = np.asarray(make_level_set3(m, g, SDFConfig()))
    surf = np.minimum(np.abs(a), np.abs(b)) < 1e-5
    assert (((a < 0) == (b < 0)) | surf).all()
    np.testing.assert_allclose(a, b, atol=0.05 * g.dx)
