"""Closest-point jump flooding (ops/vdt.py): nearest-site quality, the
upper-bound invariant, seed freezing, stride capping, chamfer properties."""

import numpy as np
import jax.numpy as jnp

from sdfgenfast.ops.vdt import (
    FAR,
    chamfer_relax,
    stride_ladder,
    vdt_far_field,
)


def _point_site_case(shape, n_sites, seed=0):
    """Seeds whose cp is their own cell position: VDT == nearest-site EDT."""
    rng = np.random.default_rng(seed)
    dx = 0.25
    cells = np.stack(
        np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1
    ).astype(np.float32) * dx
    sites = rng.integers(0, min(shape), (n_sites, 3))
    cpx = np.full(shape, float(FAR), np.float32)
    cpy = np.full(shape, float(FAR), np.float32)
    cpz = np.full(shape, float(FAR), np.float32)
    tid = np.full(shape, -1, np.int32)
    for s, (i, j, k) in enumerate(sites):
        cpx[i, j, k] = i * dx
        cpy[i, j, k] = j * dx
        cpz[i, j, k] = k * dx
        tid[i, j, k] = s
    phi_seed = np.where(tid >= 0, 0.0, 3e18).astype(np.float32)

    site_pos = sites.astype(np.float32) * dx
    d_true = np.linalg.norm(
        cells[..., None, :] - site_pos[None, None, None], axis=-1
    ).min(axis=-1)
    return (cpx, cpy, cpz, tid, phi_seed, dx), d_true


class TestVdtFarField:
    def test_point_sites_nearly_exact(self):
        args, d_true = _point_site_case((16, 14, 12), 9, seed=3)
        cpx, cpy, cpz, tid, phi_seed, dx = args
        phi, otid = vdt_far_field(
            jnp.asarray(cpx), jnp.asarray(cpy), jnp.asarray(cpz),
            jnp.asarray(tid), jnp.asarray(phi_seed), jnp.float32(dx),
            stride_ladder(16),
        )
        phi = np.asarray(phi)
        # never below the true distance (every cp is a real site)...
        assert (phi >= d_true - 1e-5).all()
        # ...and jump flooding finds the nearest site almost everywhere
        assert np.abs(phi - d_true).max() < 0.25 * dx
        assert ((np.abs(phi - d_true) < 1e-5).mean()) > 0.99
        # winner ids are valid sites
        assert (np.asarray(otid) >= 0).all()

    def test_seeded_cells_frozen(self):
        args, _ = _point_site_case((10, 10, 10), 5, seed=1)
        cpx, cpy, cpz, tid, phi_seed, dx = args
        # plant a nonzero exact band value at the seeds
        phi_seed = np.where(tid >= 0, 0.123, 3e18).astype(np.float32)
        phi, otid = vdt_far_field(
            jnp.asarray(cpx), jnp.asarray(cpy), jnp.asarray(cpz),
            jnp.asarray(tid), jnp.asarray(phi_seed), jnp.float32(dx),
            stride_ladder(10),
        )
        seeded = tid >= 0
        np.testing.assert_array_equal(np.asarray(phi)[seeded], np.float32(0.123))
        np.testing.assert_array_equal(np.asarray(otid)[seeded], tid[seeded])

    def test_capped_ladder_matches_full(self):
        args, _ = _point_site_case((16, 16, 16), 7, seed=5)
        cpx, cpy, cpz, tid, phi_seed, dx = args
        a, _ = vdt_far_field(
            jnp.asarray(cpx), jnp.asarray(cpy), jnp.asarray(cpz),
            jnp.asarray(tid), jnp.asarray(phi_seed), jnp.float32(dx),
            stride_ladder(16),
        )
        b, _ = vdt_far_field(
            jnp.asarray(cpx), jnp.asarray(cpy), jnp.asarray(cpz),
            jnp.asarray(tid), jnp.asarray(phi_seed), jnp.float32(dx),
            stride_ladder(16, max_hop=4),
        )
        # the capped ladder covers the same reach (more, shorter hops)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


class TestStrideLadder:
    def test_full(self):
        assert stride_ladder(64) == (32, 16, 8, 4, 2, 1, 1, 1)
        assert stride_ladder(64, extra_rounds=0) == (32, 16, 8, 4, 2, 1)

    def test_capped_reach(self):
        s = stride_ladder(64, max_hop=8, extra_rounds=0)
        assert max(s) == 8
        # total reach must cover what the uncapped ladder covered
        assert sum(s) >= sum(stride_ladder(64, extra_rounds=0))

    def test_cap_noop_when_large(self):
        assert stride_ladder(64, max_hop=64) == stride_ladder(64)


class TestChamferRelax:
    def test_monotone_and_fixes_overestimates(self):
        # distance field to a point, with a planted overestimate blob
        dx = 0.5
        shape = (12, 12, 12)
        cells = np.stack(
            np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1
        ).astype(np.float32) * dx
        center = np.array([5, 5, 5], np.float32) * dx
        true = np.linalg.norm(cells - center, axis=-1)
        bad = true.copy()
        bad[8, 8, 8] += 0.9 * dx  # overestimate island
        out = np.asarray(chamfer_relax(jnp.asarray(bad), jnp.float32(dx), 2))
        assert (out <= bad + 1e-6).all()  # monotone non-increasing
        assert (out >= true - 1e-5).all()  # never below true
        assert abs(out[8, 8, 8] - true[8, 8, 8]) < 0.1 * dx  # repaired

    def test_exact_field_unchanged(self):
        dx = 0.5
        shape = (10, 10, 10)
        cells = np.stack(
            np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1
        ).astype(np.float32) * dx
        true = np.linalg.norm(cells - np.array([4.5, 4.5, 4.5]) * dx, axis=-1)
        out = np.asarray(chamfer_relax(jnp.asarray(true), jnp.float32(dx), 3))
        np.testing.assert_allclose(out, true, atol=2e-6)


class TestJitConsistency:
    def test_jit_matches_eager(self):
        # Regression: a python-unrolled 26-shift Gauss-Seidel chain once
        # MISCOMPILED under jit (jit and eager disagreed by 8dx on identical
        # inputs); the fori_loop + pad + dynamic-slice
        # form compiles correctly on all backends. Pin jit == eager.
        import jax
        from functools import partial
        from sdfgenfast.ops.vdt import vdt_far_field, stride_ladder

        args, _ = _point_site_case((16, 16, 16), 8, seed=9)
        cpx, cpy, cpz, tid, phi_seed, dx = args
        strides = stride_ladder(16)
        inputs = (
            jnp.asarray(cpx), jnp.asarray(cpy), jnp.asarray(cpz),
            jnp.asarray(tid), jnp.asarray(phi_seed), jnp.float32(dx),
        )
        pe, te = vdt_far_field(*inputs, strides)
        f = jax.jit(partial(vdt_far_field, strides=strides))
        pj, tj = f(*inputs)
        np.testing.assert_array_equal(np.asarray(pe), np.asarray(pj))
        np.testing.assert_array_equal(np.asarray(te), np.asarray(tj))
