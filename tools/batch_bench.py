#!/usr/bin/env python
"""Batch-generation throughput.

Measures `api.generate_sdf_batch` on the GPU: N distinct
100k-class meshes on one shared 256-class grid, one compiled program
reused across the batch (bucketed shapes), each mesh's host binning
overlapped with the previous mesh's device compute. Reports aggregate
voxels/s, per-mesh wall, and the overlap gain vs the same meshes run
strictly sequentially (bin k -> compute k -> fetch k). Prints one JSON
row.

Usage: python tools/batch_bench.py [N]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def main():
    n_meshes = int(sys.argv[1]) if len(sys.argv) > 1 else 6

    import jax

    from sdfgenfast.aot import setup_compile_cache
    from sdfgenfast import generate_sdf_batch
    from sdfgenfast.mesh import icosphere

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"batch_bench needs a GPU (JAX found {dev.platform})")

    # N distinct meshes: jittered icosphere(6) (81,920 tris each) — realistic
    # "same family, different geometry" batch; identical array SHAPES so one
    # compiled program serves the whole batch
    rng = np.random.default_rng(0)
    meshes = []
    for _ in range(n_meshes):
        m = icosphere(6, radius=1.0)
        v = m.verts + rng.normal(0, 0.003, m.verts.shape).astype(np.float32)
        meshes.append((v, m.tris))

    n = 256
    origin, dx = (-1.3, -1.3, -1.3), 2.6 / n
    cells = n ** 3

    # warm: compile + seed the jit/persistent caches (first mesh's shapes)
    t0 = time.perf_counter()
    generate_sdf_batch(meshes[:1], origin, dx, n, n, n)
    warm_s = time.perf_counter() - t0
    print(f"warm/compile: {warm_s:.1f}s", file=sys.stderr)

    # batched (overlapped) run
    t0 = time.perf_counter()
    out = generate_sdf_batch(meshes, origin, dx, n, n, n)
    t_batch = time.perf_counter() - t0
    assert len(out) == n_meshes and out[0].shape == (n, n, n)

    # strictly sequential: same calls, but fetch each result before binning
    # the next (defeats the one-deep overlap)
    t0 = time.perf_counter()
    for pair in meshes:
        generate_sdf_batch([pair], origin, dx, n, n, n)
    t_seq = time.perf_counter() - t0

    row = {
        "workload": f"{n_meshes} x icosphere(6) (81,920 tris) @ {n}^3",
        "batch_s": round(t_batch, 3),
        "sequential_s": round(t_seq, 3),
        "per_mesh_ms": round(t_batch / n_meshes * 1e3, 1),
        "mvoxels_per_sec": round(cells * n_meshes / t_batch / 1e6, 1),
        "overlap_gain": round(t_seq / t_batch, 3),
        "device": dev.device_kind,
        "inside_frac": round(float((out[0] < 0).mean()), 3),
    }
    print(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()
