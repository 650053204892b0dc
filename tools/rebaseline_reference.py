#!/usr/bin/env python
"""Re-baseline the reference binary on the LARGE-mesh configs.

BASELINE.md's RTX-4090 anchor (28.6M voxels/s) was measured on the
36-triangle box; near-band cost scales with triangle count, so the
100k-triangle flagship rows need their own reference numbers. This runs the
actual reference CPU build (/tmp/refbuild/bin/SDFGen, or $SDFGEN_REF) on the
flagship meshes at the 256/512-class mode-2a grids, with 1 thread and all
host cores, and prints the wall-clock times + derived voxels/s as JSON.

The reference's own GPU/1-thread-CPU speedup at 256-class is 37.6x
(README.md:279-284); an RTX-4090 ESTIMATE for each config is derived as
cpu_1thread_time / 37.6 and marked as estimated.

Host caveat recorded in the output: this machine exposes N cores (the
reference README numbers used a 24-core i9-13900K).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

REF_BIN = os.environ.get("SDFGEN_REF", "/tmp/refbuild/bin/SDFGen")
GPU_SPEEDUP_256 = 37.6  # reference README.md:279-284, 256-class


def write_stl(path, mesh):
    from sdfgenfast.io.mesh_io import save_stl

    save_stl(path, mesh)


def run_ref(mesh_path, nx, threads, timeout=7200):
    t0 = time.time()
    out = subprocess.run(
        [REF_BIN, mesh_path, str(nx), "1", str(threads)],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(mesh_path),
    )
    wall = time.time() - t0
    if out.returncode != 0:
        raise RuntimeError(f"SDFGen failed: {out.stdout}\n{out.stderr}")
    m = re.search(r"dimensions:?\s*(\d+)\s*x\s*(\d+)\s*x\s*(\d+)",
                  out.stdout, re.I)
    dims = tuple(int(v) for v in m.groups()) if m else None
    return wall, dims, out.stdout


def main():
    from sdfgenfast.mesh import icosphere, torus_mesh

    ncores = os.cpu_count() or 1
    tmp = tempfile.mkdtemp(prefix="rebaseline_")
    sphere = icosphere(6, radius=1.0)
    torus = torus_mesh()
    sph_path = os.path.join(tmp, "icosphere6.stl")
    tor_path = os.path.join(tmp, "torus100k.stl")
    write_stl(sph_path, sphere)
    write_stl(tor_path, torus)

    configs = [
        ("sphere82k_256", sph_path, 256),
        ("torus100k_256", tor_path, 256),
        ("sphere82k_512", sph_path, 512),
        ("torus100k_512", tor_path, 512),
    ]
    only = set(sys.argv[1:])
    if only:
        configs = [c for c in configs if c[0] in only]

    results = {}
    for name, path, nx in configs:
        row = {}
        for threads, label in [(1, "cpu_1t"), (ncores, f"cpu_{ncores}t")]:
            wall, dims, _ = run_ref(path, nx, threads)
            cells = int(np.prod(dims)) if dims else None
            row[label] = {"wall_s": round(wall, 2), "dims": dims,
                          "voxels_per_sec": round(cells / wall, 1)
                          if cells else None}
            print(f"{name} {label}: {wall:.1f}s dims={dims} "
                  f"-> {cells/wall/1e6:.2f}M voxels/s" if cells else
                  f"{name} {label}: {wall:.1f}s", flush=True)
        t1 = row["cpu_1t"]["wall_s"]
        row["rtx4090_est"] = {
            "wall_s": round(t1 / GPU_SPEEDUP_256, 3),
            "voxels_per_sec": round(
                row["cpu_1t"]["voxels_per_sec"] * GPU_SPEEDUP_256, 1),
            "method": f"cpu_1t / {GPU_SPEEDUP_256} "
                      "(reference README.md:279-284 256-class GPU speedup)",
        }
        results[name] = row

    print(json.dumps({
        "binary": REF_BIN,
        "host_cores": ncores,
        "host_caveat": (
            f"this host exposes {ncores} cores; the reference README "
            "numbers used a 24-core i9-13900K — cpu_1t is the "
            "machine-independent-ish anchor, rtx4090_est scales it by the "
            "reference's own measured GPU speedup"),
        "rows": results,
    }, indent=2))

if __name__ == "__main__":
    main()
