"""VTK XML ImageData (.vti) writer tests.

Mirrors the reference's test_vtk_output.cpp (/root/reference/tests/
test_vtk_output.cpp:1-168): output file exists, is well-formed XML with the
expected ImageData structure, and the payload round-trips. The reference
validates through the VTK library; our writer is dependency-free, so the
payload check decodes the base64 appended data directly. Also exercises the
CLI's SDFGEN_VTI hook (the runtime analog of the reference's HAVE_VTK
build flag, app/main.cpp:281-317)."""

import base64
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from sdfgenfast.io.vti import write_vti

HERE = os.path.dirname(os.path.abspath(__file__))
RESOURCES = os.path.join(HERE, "resources")


def _read_vti(path):
    tree = ET.parse(path)  # raises on malformed XML
    root = tree.getroot()
    assert root.tag == "VTKFile"
    assert root.get("type") == "ImageData"
    image = root.find("ImageData")
    piece = image.find("Piece")
    arr = piece.find("PointData").find("DataArray")
    assert arr.get("type") == "Float32"
    assert arr.get("format") == "binary"
    raw = base64.b64decode(arr.text.strip())
    (nbytes,) = np.frombuffer(raw[:4], "<u4")
    payload = np.frombuffer(raw[4:4 + nbytes], "<f4")
    extent = [int(v) for v in image.get("WholeExtent").split()]
    dims = (extent[1] + 1, extent[3] + 1, extent[5] + 1)
    origin = [float(v) for v in image.get("Origin").split()]
    spacing = [float(v) for v in image.get("Spacing").split()]
    return dims, origin, spacing, payload


class TestVtiWriter:
    def test_roundtrip_payload(self, tmp_path):
        rng = np.random.default_rng(0)
        phi = rng.normal(size=(5, 7, 9)).astype(np.float32)
        path = str(tmp_path / "out.vti")
        write_vti(path, phi, origin=(0.5, -1.0, 2.0), dx=0.25)
        dims, origin, spacing, payload = _read_vti(path)
        assert dims == (5, 7, 9)
        np.testing.assert_allclose(origin, [0.5, -1.0, 2.0])
        np.testing.assert_allclose(spacing, [0.25] * 3)
        # VTI point order is x-fastest: payload[i + ni*(j + nj*k)]
        back = payload.reshape(9, 7, 5).transpose(2, 1, 0)
        np.testing.assert_array_equal(back, phi)

    def test_rejects_bad_shapes(self, tmp_path):
        path = str(tmp_path / "bad.vti")
        with pytest.raises(ValueError):
            write_vti(path, np.zeros((4, 4), np.float32), (0, 0, 0), 0.1)
        with pytest.raises(ValueError):
            write_vti(path, np.zeros((4, 0, 4), np.float32), (0, 0, 0), 0.1)

    def test_xml_wellformed_large_names(self, tmp_path):
        phi = np.zeros((3, 3, 3), np.float32)
        path = str(tmp_path / "n.vti")
        write_vti(path, phi, (0, 0, 0), 1.0, array_name="SDF values")
        dims, *_ = _read_vti(path)
        assert dims == (3, 3, 3)


class TestCliVti:
    """SDFGEN_VTI=1 switches the CLI's output to .vti, mirroring the
    reference's HAVE_VTK build (test_vtk_output.cpp runs the CLI and checks
    the file and the summary block)."""

    def _run(self, args, cwd, extra_env=None):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.dirname(HERE)
        if extra_env:
            env.update(extra_env)
        return subprocess.run(
            [sys.executable, "-m", "sdfgenfast.cli", *args],
            capture_output=True, text=True, cwd=cwd, env=env, timeout=570,
        )

    def test_cli_writes_vti_mode2a(self, tmp_path):
        import shutil

        shutil.copy(os.path.join(RESOURCES, "box345.stl"), tmp_path)
        res = self._run(["box345.stl", "24", "1"], str(tmp_path),
                        {"SDFGEN_VTI": "1"})
        assert res.returncode == 0, res.stderr
        out = tmp_path / "box345_sdf_24x31x39.vti"
        assert out.exists(), res.stdout
        assert "Writing VTK output to:" in res.stdout
        assert "Inside cells:" in res.stdout
        dims, origin, spacing, payload = _read_vti(str(out))
        assert dims == (24, 31, 39)
        inside = int((payload < 0).sum())
        # the CLI's printed inside count must match the payload
        assert f"Inside cells: {inside} /" in res.stdout
        # and no .sdf should have been produced
        assert not (tmp_path / "box345_sdf_24x31x39.sdf").exists()

    def test_cli_vti_disabled_by_default(self, tmp_path):
        import shutil

        shutil.copy(os.path.join(RESOURCES, "box345.stl"), tmp_path)
        res = self._run(["box345.stl", "16", "1"], str(tmp_path),
                        {"SDFGEN_VTI": "0"})
        assert res.returncode == 0, res.stderr
        assert (tmp_path / "box345_sdf_16x21x25.sdf").exists(), res.stdout
        assert not (tmp_path / "box345_sdf_16x21x25.vti").exists()
