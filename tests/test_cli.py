"""CLI integration tests: spawn the real CLI as a subprocess (the reference's
tier-2 strategy, tests/cli_test_utils.cpp:55) and assert exit codes, stdout
content, output files, and .sdf headers.

Subprocesses run with PYTHONPATH pointing at the repo only and
JAX_PLATFORMS=cpu, so they are hermetic and never claim an accelerator."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESOURCES = os.path.join(REPO, "tests", "resources")


def run_cli(args, cwd, timeout=420):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "sdfgenfast.cli"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )


def read_header(path):
    raw = open(path, "rb").read(36)
    dims = np.frombuffer(raw[:12], "<i4")
    bmin = np.frombuffer(raw[12:24], "<f4")
    bmax = np.frombuffer(raw[24:36], "<f4")
    return dims, bmin, bmax


@pytest.fixture()
def workdir(tmp_path):
    import shutil

    for f in ["box345.stl", "box345.obj", "box345_ascii.stl"]:
        shutil.copy(os.path.join(RESOURCES, f), tmp_path / f)
    return tmp_path


class TestCLIModes:
    def test_no_args_prints_usage(self, tmp_path):
        r = run_cli([], tmp_path)
        assert r.returncode != 0
        assert "Mode 1: Legacy OBJ" in r.stdout
        assert "Mode 2a" in r.stdout

    def test_mode2a_proportional(self, workdir):
        r = run_cli(["box345.stl", "16", "1"], workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        # dx = 3/14; ny = trunc(4/dx+0.5)+2 = 21, nz = trunc(5/dx+0.5)+2 = 25
        assert "Calculated grid: 16 x 21 x 25" in r.stdout
        out = workdir / "box345_sdf_16x21x25.sdf"
        assert out.exists()
        dims, bmin, bmax = read_header(str(out))
        np.testing.assert_array_equal(dims, [16, 21, 25])
        assert "Hardware:" in r.stdout
        assert "Match: OK" in r.stdout
        assert "Inside cells:" in r.stdout

    def test_mode2b_manual(self, workdir):
        r = run_cli(["box345.stl", "12", "14", "16", "2", "1"], workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        out = workdir / "box345_sdf_12x14x16.sdf"
        assert out.exists()
        dims, _, _ = read_header(str(out))
        np.testing.assert_array_equal(dims, [12, 14, 16])

    def test_mode1_legacy_obj(self, workdir):
        r = run_cli(["box345.obj", "0.5", "2"], workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        out = workdir / "box345.sdf"  # mode 1: no dims suffix (app/main.cpp:327)
        assert out.exists()
        dims, bmin, _ = read_header(str(out))
        # extent+2*pad*dx over dx: (3+2)/0.5=10, (4+2)/0.5=12, (5+2)/0.5=14
        np.testing.assert_array_equal(dims, [10, 12, 14])
        np.testing.assert_allclose(bmin, [-2, -2, -2], atol=1e-6)

    def test_ascii_stl(self, workdir):
        r = run_cli(["box345_ascii.stl", "12"], workdir)
        assert r.returncode == 0, r.stdout + r.stderr
        assert (workdir / "box345_ascii_sdf_12x16x19.sdf").exists() or any(
            f.name.startswith("box345_ascii_sdf_") for f in workdir.iterdir()
        )


class TestCLIErrors:
    """The 10 error cases of the reference's tests/test_cli_errors.cpp, plus
    the rule that the CLI must NEVER die with a Python traceback."""

    def test_no_arguments(self, tmp_path):
        r = run_cli([], tmp_path)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_too_few_arguments(self, workdir):
        # OBJ alone (mode 1 needs dx + padding), test_cli_errors.cpp:51-77
        r = run_cli(["box345.obj"], workdir)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_missing_file(self, tmp_path):
        r = run_cli(["nope.stl", "16", "1"], tmp_path)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_invalid_file_extension(self, tmp_path):
        bad = tmp_path / "test_invalid.txt"
        bad.write_text("This is not a mesh file\n")
        r = run_cli([bad.name, "32", "1"], tmp_path)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_negative_dimensions(self, workdir):
        r = run_cli(["box345.stl", "-5"], workdir)
        assert r.returncode != 0
        assert "positive" in (r.stdout + r.stderr)

    def test_zero_dimensions(self, workdir):
        r = run_cli(["box345.stl", "0", "1"], workdir)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_negative_padding_handled_gracefully(self, workdir):
        # reference: "should fail or auto-correct to minimum; at minimum must
        # not crash" (test_cli_errors.cpp:211-233). Mode 1 clamps padding<1 to
        # 1 (app/main.cpp semantics) — so this must SUCCEED without crashing.
        r = run_cli(["box345.obj", "0.5", "-2"], workdir)
        assert "Traceback" not in r.stderr
        assert r.returncode == 0

    def test_invalid_argument_type(self, workdir):
        # string where a number is expected: atoi-degrades to 0 -> rejected
        r = run_cli(["box345.stl", "not_a_number", "1"], workdir)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_malformed_stl(self, tmp_path):
        bad = tmp_path / "malformed.stl"
        bad.write_bytes(b"INVALID STL DATA")
        r = run_cli([bad.name, "32", "1"], tmp_path)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_malformed_obj(self, tmp_path):
        bad = tmp_path / "malformed.obj"
        bad.write_text("# This OBJ has no geometry\n# No vertices, no faces\n")
        r = run_cli([bad.name, "0.1", "2"], tmp_path)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr

    def test_mode1_requires_obj(self, workdir):
        r = run_cli(["box345.txt", "0.5", "2"], workdir)
        assert r.returncode != 0

    def test_mode1_nonnumeric_dx(self, workdir):
        # atof degrades "abc" to 0.0 -> rejected as non-positive dx
        r = run_cli(["box345.obj", "abc", "1"], workdir)
        assert r.returncode != 0
        assert "Traceback" not in r.stderr
