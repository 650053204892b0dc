"""CLI format and output-file coverage, mirroring the reference's
test_cli_formats.cpp (binary/ASCII STL, quad/triangulated OBJ, STL
auto-detection) and test_cli_output.cpp (mode-1 naming without a dimensions
suffix, the `_sdf_{n}x{n}x{n}` suffix in mode 2, overwrite behavior,
relative output paths). All cases run the real CLI as a subprocess, like the
reference's popen harness (tests/cli_test_utils.cpp:55)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RESOURCES = os.path.join(HERE, "resources")


def run_cli(args, cwd, timeout=420):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "sdfgenfast.cli"] + list(args),
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )


def read_sdf(path):
    raw = open(path, "rb").read()
    dims = np.frombuffer(raw[:12], "<i4")
    data = np.frombuffer(raw[36:], "<f4")
    return tuple(int(d) for d in dims), data


@pytest.fixture()
def workdir(tmp_path):
    for name in ("box345.stl", "box345_ascii.stl", "box345.obj"):
        shutil.copy(os.path.join(RESOURCES, name), tmp_path)
    return tmp_path


class TestCLIFormats:
    """test_cli_formats.cpp analogs: every input encoding produces the same
    grid through the real CLI."""

    def test_binary_vs_ascii_stl_identical(self, workdir):
        r1 = run_cli(["box345.stl", "16", "1"], workdir)
        r2 = run_cli(["box345_ascii.stl", "16", "1"], workdir)
        assert r1.returncode == 0, r1.stdout + r1.stderr
        assert r2.returncode == 0, r2.stdout + r2.stderr
        d1, a1 = read_sdf(next(workdir.glob("box345_sdf_*.sdf")))
        d2, a2 = read_sdf(next(workdir.glob("box345_ascii_sdf_*.sdf")))
        assert d1 == d2
        np.testing.assert_array_equal(a1, a2)

    def test_obj_mode1_runs(self, workdir):
        # mode 1: dx + padding; quad OBJ fan-triangulates like the reference
        r = run_cli(["box345.obj", "0.4", "2"], workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        out = workdir / "box345.sdf"
        assert out.exists(), "mode 1 writes <base>.sdf without a dims suffix"
        dims, data = read_sdf(out)
        # mode-1 sizing is golden-verified against the reference binary
        # (tests/test_parity_golden.py box_obj_mode1); pin the values here
        assert dims == (11, 14, 16), dims

    def test_stl_auto_detection(self, workdir):
        """ASCII payload behind a .stl name must be sniffed, not assumed
        (mesh_io_stl.cpp:42-92's 80+4+50n size rule)."""
        renamed = workdir / "sniffme.stl"
        shutil.copy(workdir / "box345_ascii.stl", renamed)
        r = run_cli(["sniffme.stl", "12", "1"], workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        assert next(workdir.glob("sniffme_sdf_*.sdf"), None) is not None


class TestCLIOutput:
    """test_cli_output.cpp analogs: naming, overwrite, relative paths."""

    def test_filename_with_dimensions(self, workdir):
        r = run_cli(["box345.stl", "16", "1"], workdir)
        assert r.returncode == 0
        # exact suffix: mode 2a proportional sizing of the 3x4x5 box
        assert (workdir / "box345_sdf_16x21x25.sdf").exists(), list(
            workdir.iterdir())

    def test_file_overwrite(self, workdir):
        out = workdir / "box345_sdf_16x21x25.sdf"
        r = run_cli(["box345.stl", "16", "1"], workdir)
        assert r.returncode == 0 and out.exists()
        first = out.read_bytes()
        out.write_bytes(b"garbage")
        r = run_cli(["box345.stl", "16", "1"], workdir)
        assert r.returncode == 0
        assert out.read_bytes() == first, "rerun must overwrite cleanly"

    def test_relative_subdir_input(self, workdir):
        sub = workdir / "meshes"
        sub.mkdir()
        shutil.copy(workdir / "box345.stl", sub)
        r = run_cli([os.path.join("meshes", "box345.stl"), "12", "1"],
                    workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        assert next(sub.glob("box345_sdf_*.sdf"), None) is not None, (
            "output lands next to the input file, like the reference")

    def test_sdf_header_matches_stdout_dims(self, workdir):
        r = run_cli(["box345.stl", "16", "1"], workdir)
        assert r.returncode == 0
        dims, _ = read_sdf(workdir / "box345_sdf_16x21x25.sdf")
        assert f"Dimensions: {dims[0]} x {dims[1]} x {dims[2]}" in r.stdout
