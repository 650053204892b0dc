"""Parity vs the reference C++ binary (CPU backend, single thread).

Goldens in tests/goldens/ were produced by tools/make_goldens.py running the
actual reference build on meshes written by our own writers; manifest.json
records the CLI invocations. Each test replicates the CLI's grid sizing
(app/main.cpp modes 1/2a/2b) and compares grids cell by cell.

Tolerances: the narrow band must agree to float32 roundoff. In the far field
both implementations propagate closest-triangle ids to a fixed point; at
medial-axis cells different propagation orders can settle on marginally
different (always >= true) distances, so we allow a small fraction of dx
there — far tighter than the reference's own CPU/GPU acceptance threshold of
25*dx (tests/test_correctness.cpp:195, test_utils.h:52-55)."""

import json
import os

import numpy as np
import pytest

from conftest import ensure_resource

from sdfgenfast import GridSpec, SDFConfig, make_level_set3
from sdfgenfast.grid import (
    sizing_mode1_legacy,
    sizing_mode2a_proportional,
    sizing_mode2b_manual,
)
from sdfgenfast.io import mesh_io, sdf_io

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "goldens")
RESOURCES = os.path.join(HERE, "resources")

with open(os.path.join(GOLDENS, "manifest.json")) as f:
    MANIFEST = json.load(f)


def _grid_for(config_name):
    entry = MANIFEST[config_name]
    mesh, mn, mx = mesh_io.load_mesh(os.path.join(RESOURCES, entry["mesh"]))
    cli = entry["cli_args"]
    if entry["mesh"].endswith(".stl"):
        if len(cli) >= 5:  # Nx Ny Nz padding threads -> mode 2b
            grid = sizing_mode2b_manual(
                mn, mx, int(cli[0]), int(cli[1]), int(cli[2]), int(cli[3])
            )
        else:  # Nx padding threads -> mode 2a
            grid = sizing_mode2a_proportional(mn, mx, int(cli[0]), int(cli[1]))
    else:  # OBJ mode 1: dx padding threads
        grid = sizing_mode1_legacy(mn, mx, float(cli[0]), int(cli[1]))
    return mesh, grid, entry


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_parity(name):
    mesh, grid, entry = _grid_for(name)
    golden, gmin, gmax = sdf_io.read_sdf(os.path.join(GOLDENS, entry["golden"]))
    assert golden.shape == grid.shape, (
        f"grid sizing mismatch: ours {grid.shape} vs reference {golden.shape}"
    )
    np.testing.assert_allclose(grid.bounds_min, gmin, atol=2e-6 * max(abs(gmin).max(), 1))

    phi = np.asarray(make_level_set3(mesh, grid, SDFConfig()))

    # sign agreement everywhere off the surface
    surf = np.minimum(np.abs(phi), np.abs(golden)) < 1e-5
    sign_mismatch = ((phi < 0) != (golden < 0)) & ~surf
    assert sign_mismatch.sum() == 0, (
        f"{sign_mismatch.sum()} sign mismatches, e.g. {np.argwhere(sign_mismatch)[:5]}"
    )

    # magnitude agreement
    near = np.abs(golden) < 2 * grid.dx
    # atol covers cells essentially on the surface (|phi| ~ 1e-7) where the
    # two implementations' float32 rounding noise dominates the relative error
    np.testing.assert_allclose(
        np.abs(phi)[near], np.abs(golden)[near], rtol=5e-5, atol=2e-6
    )
    err = np.abs(phi) - np.abs(golden)
    assert np.abs(err).max() < 0.2 * grid.dx, (
        f"far-field divergence {np.abs(err).max():.3e} exceeds 0.2*dx"
    )


def test_sparse_golden_256_sphere6():
    """256-class parity vs the reference binary, from the SPARSE golden
    (tools/make_goldens.py --sparse-256): sign of EVERY cell, exact values
    on the full near-band, 0.2dx far-field bound on a stride-4 subsample.
    Proves the headline-size grid, where the far-field ladder gets deep."""
    path = os.path.join(GOLDENS, "sphere6_stl_256_mode2a.sparse.npz")
    if not os.path.exists(path):
        pytest.skip("sparse 256 golden not generated (tools/make_goldens.py --sparse-256)")
    g = np.load(path)
    dims = tuple(int(v) for v in g["dims"])
    bmin = g["bmin"]
    dx = float(g["dx"])

    mesh, mn, mx = mesh_io.load_mesh(ensure_resource("icosphere6.stl"))
    grid = sizing_mode2a_proportional(mn, mx, 256, 1)
    assert grid.shape == dims, (grid.shape, dims)
    np.testing.assert_allclose(grid.bounds_min, bmin, atol=2e-6)

    phi = np.asarray(make_level_set3(mesh, grid, SDFConfig())).reshape(-1)

    # sign of every cell
    ref_neg = np.unpackbits(g["packed_signs"])[: phi.size].astype(bool)
    surf = np.abs(phi) < 1e-5
    mism = (ref_neg != (phi < 0)) & ~surf
    assert mism.sum() == 0, f"{mism.sum()} sign mismatches"

    # exact near band
    band_idx = g["band_idx"]
    np.testing.assert_allclose(
        np.abs(phi[band_idx]), np.abs(g["band_val"]), rtol=5e-5, atol=2e-6
    )

    # far field on the stride-4 subsample
    sample = g["far_sample_stride4"]
    ours = phi.reshape(dims)[::4, ::4, ::4]
    err = np.abs(np.abs(ours) - np.abs(sample))
    assert err.max() < 0.2 * dx, f"far-field divergence {err.max():.3e}"


@pytest.mark.slow
def test_sparse_golden_512_sphere6():
    """512-class parity vs the reference binary, from the SPARSE golden
    (tools/make_goldens.py --sparse-512): sign of EVERY cell, exact values
    on every 4th near-band cell, 0.2dx far-field bound on a stride-8
    subsample. Proves the deepest single-device grid the pyramid far field
    serves (VERDICT r3 item 4)."""
    path = os.path.join(GOLDENS, "sphere6_stl_512_mode2a.sparse.npz")
    if not os.path.exists(path):
        pytest.skip("sparse 512 golden not generated "
                    "(tools/make_goldens.py --sparse-512)")
    g = np.load(path)
    dims = tuple(int(v) for v in g["dims"])
    bmin = g["bmin"]
    dx = float(g["dx"])

    # the 512 golden was harvested from the re-baselining run's reference
    # output, which used the ORIGIN-centered icosphere (see
    # tools/rebaseline_reference.py); the mesh is regenerated on demand
    mesh, mn, mx = mesh_io.load_mesh(ensure_resource("icosphere6_origin.stl"))
    grid = sizing_mode2a_proportional(mn, mx, 512, 1)
    assert grid.shape == dims, (grid.shape, dims)
    np.testing.assert_allclose(grid.bounds_min, bmin, atol=2e-6)

    phi = np.asarray(make_level_set3(mesh, grid, SDFConfig())).reshape(-1)

    ref_neg = np.unpackbits(g["packed_signs"])[: phi.size].astype(bool)
    surf = np.abs(phi) < 1e-5
    mism = (ref_neg != (phi < 0)) & ~surf
    assert mism.sum() == 0, f"{mism.sum()} sign mismatches"

    band_idx = g["band_idx"]
    np.testing.assert_allclose(
        np.abs(phi[band_idx]), np.abs(g["band_val"]), rtol=5e-5, atol=2e-6
    )

    sample = g["far_sample_stride8"]
    ours = phi.reshape(dims)[::8, ::8, ::8]
    err = np.abs(np.abs(ours) - np.abs(sample))
    assert err.max() < 0.2 * dx, f"far-field divergence {err.max():.3e}"
