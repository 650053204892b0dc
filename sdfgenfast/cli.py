"""SDFGen-compatible command-line interface.

Reproduces the reference CLI's three positional-argument modes, mode
detection, grid sizing, output naming, and console reporting
(``app/main.cpp:27-368``):

  Mode 1  : SDFGen <file.obj> <dx> <padding> [threads]
  Mode 2a : SDFGen <file.stl> <Nx> [padding] [threads]
  Mode 2b : SDFGen <file.stl> <Nx> <Ny> <Nz> [padding] [threads]

Including the reference's argc==5 ambiguity heuristic (argv[3] < 20 => mode 2a,
app/main.cpp:114) and the ``_sdf_{nx}x{ny}x{nz}.sdf`` output suffix in mode 2
(app/main.cpp:321-328). `threads` is accepted for CLI compatibility and
ignored (device parallelism replaces host threads).

Run as: python -m sdfgenfast.cli <args>   (or the `sdfgen` wrapper).
"""

from __future__ import annotations

import os
import sys

import numpy as np


USAGE = """\
SDFGen - A utility for converting closed oriented triangle meshes into grid-based signed distance fields.

=== Mode 1: Legacy OBJ with dx spacing ===
Usage: SDFGen <file.obj> <dx> <padding> [threads]

Where:
  <file.obj>  Wavefront OBJ file (text format, triangles only)
  <dx>        Grid cell size (determines resolution automatically)
  <padding>   Number of padding cells around mesh (minimum 1)
  [threads]   Optional: ignored (device parallelism is used)

=== Mode 2a: STL with proportional dimensions (recommended) ===
Usage: SDFGen <file.stl> <Nx> [padding] [threads]

Where:
  <file.stl>  Binary or ASCII STL file
  <Nx>        Grid size in X dimension (Ny, Nz calculated proportionally)
  [padding]   Optional padding cells (default: 1)

=== Mode 2b: STL with manual dimensions ===
Usage: SDFGen <file.stl> <Nx> <Ny> <Nz> [padding] [threads]

Output: Binary SDF file with 36-byte header + float32 grid data
Header: 3 ints (Nx,Ny,Nz) + 6 floats (bounds_min, bounds_max)

=== Hardware Acceleration ===
GPU acceleration (JAX/XLA) is used automatically if available.
The program will detect and report which backend is being used.
"""


def _atoi(s: str) -> int:
    """C `atoi` semantics: parse the longest leading integer prefix after
    optional whitespace/sign; 0 if none. The reference parses every numeric
    CLI arg this way (app/main.cpp:114-162), so `not_a_number` becomes 0 and
    is then rejected by the positive-dimension checks — never a crash."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


def _atof(s: str) -> float:
    """C `atof` semantics: longest leading float prefix, 0.0 if none
    (mode 1 parses dx via istringstream, app/main.cpp:204-206; same
    degrade-to-error behavior)."""
    s = s.lstrip()
    import re

    m = re.match(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group(0)) if m else 0.0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    argc = len(argv)
    # persistent compile cache (and with it the aot.py warm-start
    # artifacts): repeat CLI runs skip XLA compilation and re-tracing
    from .aot import setup_compile_cache

    setup_compile_cache()

    mode_precise = False
    filename = argv[1] if argc >= 2 else ""
    is_stl = filename.lower().endswith(".stl") and len(filename) >= 4
    if is_stl and argc >= 3:
        mode_precise = True

    if (not mode_precise and argc < 4) or (mode_precise and argc < 3):
        print(USAGE)
        return -1 & 0xFF  # the reference exits -1 (app/main.cpp:82)

    from .grid import (
        sizing_mode1_legacy,
        sizing_mode2a_proportional,
        sizing_mode2b_manual,
    )
    from .io import mesh_io, sdf_io
    from . import api
    from .mesh import Mesh
    from .pipeline import SDFConfig, make_level_set3

    print("========================================")
    print("SDFGen - SDF Generation Tool (JAX)")
    print("========================================\n")

    padding = 1
    num_threads = 0

    if mode_precise:
        print("Mode: Precise grid dimensions (STL)")
        print(f"Input: {filename}\n")
        try:
            mesh, min_box, max_box = mesh_io.load_stl(filename)
        except mesh_io.MeshLoadError as e:
            print(f"Failed to load STL file. {e}", file=sys.stderr)
            return 255
        mesh_size = max_box - min_box

        # argc==5 ambiguity heuristic: argv[3] < 20 => mode 2a (app/main.cpp:114)
        is_mode2a = argc == 3 or argc == 4 or (argc == 5 and _atoi(argv[3]) < 20)
        if is_mode2a:
            target_nx = _atoi(argv[2])
            if argc >= 4:
                padding = _atoi(argv[3])
            if argc == 5:
                num_threads = _atoi(argv[4])
            if target_nx <= 0:
                print("Error: Grid dimension must be a positive integer.", file=sys.stderr)
                return 255
            if padding < 1:
                padding = 1
            grid = sizing_mode2a_proportional(min_box, max_box, target_nx, padding)
            print("Mode: Proportional dimensions (single parameter)")
            print(f"Input Nx: {target_nx}")
            print(f"Calculated grid: {grid.ni} x {grid.nj} x {grid.nk}")
            print(f"Padding: {padding} cells\n")
            print("Grid spacing calculation:")
            print(f"  Mesh size: {mesh_size[0]} x {mesh_size[1]} x {mesh_size[2]} m")
            print(f"  dx = {grid.dx:g} m (based on X dimension)")
            target = (target_nx, grid.nj, grid.nk)
        else:
            target_nx, target_ny, target_nz = _atoi(argv[2]), _atoi(argv[3]), _atoi(argv[4])
            if argc >= 6:
                padding = _atoi(argv[5])
            if argc == 7:
                num_threads = _atoi(argv[6])
            if target_nx <= 0 or target_ny <= 0 or target_nz <= 0:
                print("Error: Grid dimensions must be positive integers.", file=sys.stderr)
                return 255
            if padding < 1:
                padding = 1
            grid = sizing_mode2b_manual(
                min_box, max_box, target_nx, target_ny, target_nz, padding
            )
            print("Mode: Manual dimensions (three parameters)")
            print(f"Target grid: {target_nx} x {target_ny} x {target_nz}")
            print(f"Padding: {padding} cells\n")
            print("Grid spacing calculation:")
            print(f"  Mesh size: {mesh_size[0]} x {mesh_size[1]} x {mesh_size[2]} m")
            print(f"  Using dx = {grid.dx:g} m (maximum to fit all dimensions)")
            target = (target_nx, target_ny, target_nz)
    else:
        print("Mode: Legacy dx spacing (OBJ)")
        print(f"Input: {filename}\n")
        if len(filename) < 5 or not filename.lower().endswith(".obj"):
            print("Error: Mode 1 requires OBJ file (.obj extension).", file=sys.stderr)
            return 255
        dx_in = _atof(argv[2])
        padding = _atoi(argv[3])
        if dx_in <= 0.0:
            print("Error: Grid spacing dx must be a positive number.", file=sys.stderr)
            return 255
        if padding < 1:
            padding = 1
        if argc >= 5:
            num_threads = _atoi(argv[4])
        print(f"Grid spacing (dx): {dx_in:g}")
        print(f"Padding: {padding} cells\n")
        try:
            mesh, min_box, max_box = mesh_io.load_obj(filename)
        except mesh_io.MeshLoadError as e:
            print(f"Failed to load OBJ file. Terminating. {e}", file=sys.stderr)
            return 255
        grid = sizing_mode1_legacy(min_box, max_box, dx_in, padding)
        target = None

    del num_threads  # accepted for compatibility only

    print("Computing signed distance field...")
    print(f"  Padded bounds: ({tuple(float(v) for v in grid.bounds_min)}) to "
          f"({tuple(float(v) for v in grid.bounds_max)})")
    print(f"  Grid dimensions: {grid.ni} x {grid.nj} x {grid.nk}")
    print(f"  Total cells: {grid.num_cells}")

    import jax

    dev = api._resolve_backend("auto")
    print(f"  Hardware: {dev.platform} ({dev.device_kind})")
    print(f"  Implementation: {'GPU' if dev.platform == 'gpu' else 'CPU'}"
          " (JAX/XLA)\n")

    try:
        with jax.default_device(dev):
            phi = np.asarray(make_level_set3(mesh, grid, SDFConfig()))
    except (ValueError, RuntimeError) as e:
        print(f"Error: SDF computation failed: {e}", file=sys.stderr)
        return 255
    print("SDF computation complete.\n")

    base = filename[: filename.rfind(".")]
    suffix = f"_sdf_{grid.ni}x{grid.nj}x{grid.nk}" if mode_precise else ""
    # VTK output hook: the reference writes .vti instead of .sdf when built
    # with VTK (compile-time HAVE_VTK, app/main.cpp:281-317). The runtime
    # analog of that build flag is the SDFGEN_VTI env var.
    if os.environ.get("SDFGEN_VTI", "") not in ("", "0"):
        from .io.vti import write_vti

        outname = f"{base}{suffix}.vti"
        print(f"Writing VTK output to: {outname}")
        write_vti(outname, phi, grid.origin, grid.dx)
        inside_count = int((phi < 0.0).sum())
    else:
        outname = f"{base}{suffix}.sdf"
        print(f"Writing binary SDF to: {outname}")
        inside_count = sdf_io.write_sdf(outname, phi, grid.origin, grid.dx)
    total_count = grid.num_cells

    print("\n========================================")
    print("Output Summary")
    print("========================================")
    print(f"File: {outname}")
    print(f"Dimensions: {grid.ni} x {grid.nj} x {grid.nk}")
    if mode_precise and target is not None:
        match = (grid.ni, grid.nj, grid.nk) == target
        print(f"Target dimensions: {target[0]} x {target[1]} x {target[2]}")
        print(f"Match: {'OK' if match else 'FAIL'}")
    print(f"Grid spacing (dx): {grid.dx:g}")
    print(f"Inside cells: {inside_count} / {total_count} "
          f"({100.0 * inside_count / total_count:g}%)")
    size_mb = (36 + 4 * total_count) / (1024.0 * 1024.0)
    print(f"File size: {size_mb:g} MB")
    print("========================================")
    print("Processing complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
