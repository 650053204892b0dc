"""Native C++ I/O library (csrc/sdfgenio.cpp via ctypes): must agree exactly
with the NumPy implementations on every format."""

import os

import numpy as np
import pytest

from sdfgenfast.io import mesh_io, native, sdf_io
from sdfgenfast.mesh import box_mesh, icosphere

HERE = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(HERE, "resources")

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native IO library not buildable here"
)


def _numpy_load(fn, path):
    backup = mesh_io._try_native
    mesh_io._try_native = lambda *a: None
    try:
        return fn(path)
    finally:
        mesh_io._try_native = backup


@pytest.mark.parametrize(
    "fname", ["box345.obj", "icosphere.obj"]
)
def test_obj_matches_numpy(fname):
    path = os.path.join(RES, fname)
    v, t = native.load_obj(path)
    mesh, _, _ = _numpy_load(mesh_io.load_obj, path)
    np.testing.assert_array_equal(v, mesh.verts)
    np.testing.assert_array_equal(t, mesh.tris)


@pytest.mark.parametrize("fname", ["box345.stl", "box345_ascii.stl", "icosphere.stl"])
def test_stl_matches_numpy(fname):
    path = os.path.join(RES, fname)
    v, t = native.load_stl(path)
    mesh, _, _ = _numpy_load(mesh_io.load_stl, path)
    np.testing.assert_array_equal(v, mesh.verts)
    np.testing.assert_array_equal(t, mesh.tris)


def test_obj_quads_and_negative_indices(tmp_path):
    p = str(tmp_path / "q.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
        f.write("f 1/1/1 2//2 3 4\n")  # quad with mixed slash forms
        f.write("f -4 -3 -2\n")  # negative relative indices
    v, t = native.load_obj(p)
    mesh, _, _ = _numpy_load(mesh_io.load_obj, p)
    np.testing.assert_array_equal(v, mesh.verts)
    np.testing.assert_array_equal(t, mesh.tris)
    assert t.shape[0] == 3  # fan-triangulated quad (2) + one triangle


def test_sdf_roundtrip_interop(tmp_path):
    rng = np.random.default_rng(3)
    phi = rng.standard_normal((5, 7, 9)).astype(np.float32)
    p_native = str(tmp_path / "n.sdf")
    p_numpy = str(tmp_path / "p.sdf")
    inside_n = native.write_sdf(p_native, phi, (0.5, -1.0, 2.0), 0.25)
    inside_p = sdf_io.write_sdf(p_numpy, phi, (0.5, -1.0, 2.0), 0.25)
    assert inside_n == inside_p
    # files must be byte-identical
    assert open(p_native, "rb").read() == open(p_numpy, "rb").read()
    # cross-read
    a, mn1, mx1 = native.read_sdf(p_numpy)
    b, mn2, mx2 = sdf_io.read_sdf(p_native)
    np.testing.assert_array_equal(a, phi)
    np.testing.assert_array_equal(b, phi)
    np.testing.assert_array_equal(mn1, mn2)


def test_error_handling():
    with pytest.raises(native.NativeIOError):
        native.load_obj("/nonexistent/file.obj")
    with pytest.raises(native.NativeIOError):
        native.read_sdf("/nonexistent/file.sdf")
