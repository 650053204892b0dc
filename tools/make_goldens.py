#!/usr/bin/env python
"""Generate parity goldens: run the REFERENCE C++ binary (built from
/root/reference, CPU backend, single thread for determinism) on meshes
produced by our own writers, and store the resulting .sdf files under
tests/goldens/ together with a manifest describing each config.

Usage: python tools/make_goldens.py [--ref-binary PATH]
The goldens are committed; regeneration requires the reference build.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# host-only tool: never claim an accelerator
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sdfgenfast.io import mesh_io  # noqa: E402
from sdfgenfast.mesh import box_mesh, icosphere  # noqa: E402

RESOURCES = os.path.join(REPO, "tests", "resources")
GOLDENS = os.path.join(REPO, "tests", "goldens")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-binary", default="/tmp/refbuild/bin/SDFGen")
    ap.add_argument("--sparse-256", action="store_true",
                    help="only (re)generate the sparse 256-class golden")
    ap.add_argument("--sparse-512", action="store_true",
                    help="only (re)generate the sparse 512-class golden")
    ap.add_argument("--from", dest="from_sdf", default=None,
                    help="harvest an existing reference .sdf (sparse-512)")
    args = ap.parse_args()

    if args.sparse_256:
        make_sparse_golden_256(args.ref_binary)
        return
    if args.sparse_512:
        sparse_512(args.ref_binary, from_sdf=args.from_sdf)
        return

    os.makedirs(RESOURCES, exist_ok=True)
    os.makedirs(GOLDENS, exist_ok=True)

    box = box_mesh((3, 4, 5), (-1, -1, -1))
    sphere = icosphere(3, radius=1.0, center=(0.05, -0.02, 0.03))
    # ~82k-triangle mesh (BASELINE.md large-mesh requirement). STL stores 3
    # verts/triangle (~4 MB); regenerated on demand, not committed.
    sphere6 = icosphere(6, radius=1.0, center=(0.04, -0.03, 0.02))

    mesh_io.save_stl(os.path.join(RESOURCES, "box345.stl"), box)
    mesh_io.save_stl(os.path.join(RESOURCES, "box345_ascii.stl"), box, ascii_format=True)
    mesh_io.save_obj(os.path.join(RESOURCES, "box345.obj"), box)
    mesh_io.save_obj(os.path.join(RESOURCES, "icosphere.obj"), sphere)
    mesh_io.save_stl(os.path.join(RESOURCES, "icosphere.stl"), sphere)
    mesh_io.save_stl(os.path.join(RESOURCES, "icosphere6.stl"), sphere6)

    # (name, mesh file, CLI args after file, produced .sdf name)
    configs = [
        # PR1 parity reference: 64-cell mode 2a, padding 1, single thread
        ("box_stl_64_mode2a", "box345.stl", ["64", "1", "1"], "box345_sdf_64x85x105.sdf"),
        # mode 2b manual dims
        ("box_stl_mode2b", "box345.stl", ["32", "40", "48", "2", "1"], "box345_sdf_32x40x48.sdf"),
        # mode 1 legacy OBJ with dx spacing
        ("box_obj_mode1", "box345.obj", ["0.1", "2", "1"], "box345.sdf"),
        # curved mesh, mode 2a
        ("sphere_stl_64_mode2a", "icosphere.stl", ["64", "1", "1"], None),
        # curved mesh, mode 1
        ("sphere_obj_mode1", "icosphere.obj", ["0.05", "2", "1"], "icosphere.sdf"),
        # 81,920-triangle mesh at a 128-class grid: the BASELINE.md large-mesh
        # requirement (binning K growth + memory at ~100k tris)
        ("sphere6_stl_128_mode2a", "icosphere6.stl", ["128", "1", "1"], None),
    ]

    manifest = {}
    workdir = os.path.join("/tmp", "golden_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)

    for name, meshfile, cli, outname in configs:
        src = os.path.join(RESOURCES, meshfile)
        dst_mesh = os.path.join(workdir, meshfile)
        shutil.copy(src, dst_mesh)
        cmd = [args.ref_binary, meshfile] + cli
        print("::", " ".join(cmd))
        out = subprocess.run(
            cmd, cwd=workdir, capture_output=True, text=True, timeout=600
        )
        if out.returncode != 0:
            print(out.stdout)
            print(out.stderr)
            raise SystemExit(f"reference binary failed for {name}")
        produced = [f for f in os.listdir(workdir) if f.endswith(".sdf")]
        assert len(produced) == 1, produced
        golden_name = f"{name}.sdf"
        shutil.move(os.path.join(workdir, produced[0]), os.path.join(GOLDENS, golden_name))
        os.remove(dst_mesh)
        manifest[name] = {
            "mesh": meshfile,
            "cli_args": cli,
            "golden": golden_name,
            "reference_output_name": produced[0],
        }
        # capture the banner lines that document grid sizing
        for line in out.stdout.splitlines():
            if "Grid dimensions:" in line or "dx =" in line or "Using dx" in line:
                manifest[name].setdefault("stdout", []).append(line.strip())

    with open(os.path.join(GOLDENS, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print("goldens written:", list(manifest))




def make_sparse_golden_256(ref_binary="/tmp/refbuild/bin/SDFGen"):
    """256-class golden for the 81,920-triangle sphere, stored SPARSE.

    A full 256-cubed .sdf is 67 MB — too large to commit. The sparse form
    keeps everything the parity test needs: the sign of EVERY cell (bit-
    packed, 2 MB), the exact value of every near-band cell (|phi| < 2dx),
    and a stride-4 subsample of the far field for the 0.2dx bound.
    Usage: python tools/make_goldens.py --sparse-256
    """
    import numpy as np
    from sdfgenfast.io import sdf_io

    workdir = os.path.join("/tmp", "golden_work256")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    shutil.copy(os.path.join(RESOURCES, "icosphere6.stl"),
                os.path.join(workdir, "icosphere6.stl"))
    cmd = [ref_binary, "icosphere6.stl", "256", "1", "1"]
    print("::", " ".join(cmd))
    out = subprocess.run(cmd, cwd=workdir, capture_output=True, text=True,
                         timeout=3600)
    if out.returncode != 0:
        print(out.stdout)
        print(out.stderr)
        raise SystemExit("reference binary failed for sphere6_256")
    produced = [f for f in os.listdir(workdir) if f.endswith(".sdf")]
    assert len(produced) == 1, produced
    phi, bmin, bmax = sdf_io.read_sdf(os.path.join(workdir, produced[0]))
    ni = phi.shape[0]
    dx = float((bmax[0] - bmin[0]) / ni)

    signs = np.packbits((phi < 0).reshape(-1))
    band = np.flatnonzero(np.abs(phi).reshape(-1) < 2 * dx).astype(np.int64)
    band_val = phi.reshape(-1)[band]
    sample = phi[::4, ::4, ::4].copy()
    np.savez_compressed(
        os.path.join(GOLDENS, "sphere6_stl_256_mode2a.sparse.npz"),
        dims=np.asarray(phi.shape, np.int32),
        bmin=bmin, bmax=bmax, dx=np.float64(dx),
        packed_signs=signs, band_idx=band, band_val=band_val,
        far_sample_stride4=sample,
        reference_output_name=np.bytes_(produced[0]),
    )
    print("sparse 256 golden written:",
          os.path.join(GOLDENS, "sphere6_stl_256_mode2a.sparse.npz"))


def sparse_512(ref_binary, from_sdf=None):
    """512-class sparse parity golden for the icosphere6 mode-2a config.

    A full 512-cubed .sdf is 512 MB; the sparse form keeps the sign of
    EVERY cell (bit-packed), every 4th near-band cell's exact value, and a
    stride-8 far-field subsample — the same bars as the 256 sparse test at
    the 512 scale. `--from <path>` harvests an .sdf already produced by the
    reference binary (e.g. a rebaseline run) instead of re-running the
    ~11-minute single-thread computation.
    Usage: python tools/make_goldens.py --sparse-512 [--from path.sdf]
    """
    import numpy as np
    from sdfgenfast.io import sdf_io

    if from_sdf is None:
        workdir = os.path.join("/tmp", "golden_work512")
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        shutil.copy(os.path.join(RESOURCES, "icosphere6.stl"),
                    os.path.join(workdir, "icosphere6.stl"))
        cmd = [ref_binary, "icosphere6.stl", "512", "1", "1"]
        print("::", " ".join(cmd))
        out = subprocess.run(cmd, cwd=workdir, capture_output=True,
                             text=True, timeout=4 * 3600)
        if out.returncode != 0:
            print(out.stdout)
            print(out.stderr)
            raise SystemExit("reference binary failed for sphere6_512")
        produced = [f for f in os.listdir(workdir) if f.endswith(".sdf")]
        assert len(produced) == 1, produced
        from_sdf = os.path.join(workdir, produced[0])
    phi, bmin, bmax = sdf_io.read_sdf(from_sdf)
    assert phi.shape == (512, 512, 512), phi.shape
    ni = phi.shape[0]
    dx = float((bmax[0] - bmin[0]) / ni)

    signs = np.packbits((phi < 0).reshape(-1))
    band = np.flatnonzero(np.abs(phi).reshape(-1) < 2 * dx).astype(np.int64)
    band = band[::4]  # every 4th band cell: full-resolution values
    band_val = phi.reshape(-1)[band]
    sample = phi[::8, ::8, ::8].copy()
    np.savez_compressed(
        os.path.join(GOLDENS, "sphere6_stl_512_mode2a.sparse.npz"),
        dims=np.asarray(phi.shape, np.int32),
        bmin=bmin, bmax=bmax, dx=np.float64(dx),
        packed_signs=signs, band_idx=band, band_val=band_val,
        far_sample_stride8=sample,
        reference_output_name=np.bytes_(os.path.basename(from_sdf)),
    )
    print("sparse 512 golden written:",
          os.path.join(GOLDENS, "sphere6_stl_512_mode2a.sparse.npz"))


if __name__ == "__main__":
    main()
