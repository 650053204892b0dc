"""Foundation-layer tests: grid sizing modes, mesh I/O, .sdf I/O."""

import numpy as np
import pytest

from sdfgenfast import GridSpec, Mesh, box_mesh
from sdfgenfast.grid import (
    sizing_mode1_legacy,
    sizing_mode2a_proportional,
    sizing_mode2b_manual,
    sizing_python_api,
)
from sdfgenfast.io import mesh_io, sdf_io


class TestGridSpec:
    def test_basic(self):
        g = GridSpec((0.0, 0.0, 0.0), 0.5, (4, 6, 8))
        assert g.num_cells == 192
        assert np.allclose(g.bounds_max, [2.0, 3.0, 4.0])

    def test_invalid(self):
        with pytest.raises(ValueError):
            GridSpec((0, 0, 0), 0.5, (0, 4, 4))
        with pytest.raises(ValueError):
            GridSpec((0, 0, 0), -1.0, (4, 4, 4))


class TestSizingModes:
    MIN = np.array([-1.0, -1.0, -1.0], np.float32)
    MAX = np.array([2.0, 3.0, 4.0], np.float32)  # 3 x 4 x 5 box

    def test_mode1(self):
        # dims = trunc((extent + 2*pad*dx)/dx): 3/0.1+2=32, 4/0.1+2=42, 5/0.1+2=52
        g = sizing_mode1_legacy(self.MIN, self.MAX, 0.1, 1)
        assert g.shape[0] in (31, 32)  # f32 rounding decides the truncation
        assert abs(g.dx - 0.1) < 1e-6
        assert np.allclose(g.bounds_min, self.MIN - np.float32(0.1), atol=1e-6)

    def test_mode2a(self):
        g = sizing_mode2a_proportional(self.MIN, self.MAX, 64, 1)
        assert g.shape[0] == 64
        # dx = 3/62; ny = trunc(4/dx + 0.5)+2 = 83+2 = 85; nz = trunc(103.33+0.5)+2 = 105
        assert g.shape[1] == 85
        assert g.shape[2] == 105
        # recentered: grid exactly covers sizes*dx centered on mesh center
        assert np.allclose(
            (g.bounds_max + g.bounds_min) / 2, (self.MIN + self.MAX) / 2, atol=1e-5
        )

    def test_mode2b(self):
        g = sizing_mode2b_manual(self.MIN, self.MAX, 64, 64, 64, 1)
        assert g.shape == (64, 64, 64)
        # dx = max over axes of extent/(64-2) = 5/62
        assert abs(g.dx - 5.0 / 62.0) < 1e-6

    def test_python_api_dx_mode(self):
        g = sizing_python_api(self.MIN, self.MAX, dx=0.5, padding=2)
        assert g.shape == (6 + 4, 8 + 4, 10 + 4)
        assert np.allclose(g.origin, self.MIN - 2 * np.float32(0.5), atol=1e-6)

    def test_python_api_proportional(self):
        g = sizing_python_api(self.MIN, self.MAX, nx=30, padding=1)
        dx = 3.0 / 30
        assert g.shape == (32, int(np.ceil(4 / dx)) + 2, int(np.ceil(5 / dx)) + 2)

    def test_python_api_manual(self):
        g = sizing_python_api(self.MIN, self.MAX, nx=10, ny=10, nz=10, padding=1)
        assert g.shape == (12, 12, 12)
        assert abs(g.dx - 0.5) < 1e-6

    def test_python_api_requires_sizing(self):
        with pytest.raises(ValueError):
            sizing_python_api(self.MIN, self.MAX)


class TestMeshIO:
    def test_obj_roundtrip(self, tmp_path):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        p = str(tmp_path / "box.obj")
        mesh_io.save_obj(p, m)
        loaded, mn, mx = mesh_io.load_obj(p)
        assert loaded.num_verts == 8
        assert loaded.num_tris == 12
        np.testing.assert_allclose(mn, [-1, -1, -1])
        np.testing.assert_allclose(mx, [2, 3, 4])

    def test_obj_quads_and_slashes(self, tmp_path):
        p = str(tmp_path / "quad.obj")
        with open(p, "w") as f:
            f.write("# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
            f.write("vn 0 0 1\nvt 0 0\n")
            f.write("f 1/1/1 2/2/1 3/3/1 4/4/1\n")  # quad -> 2 tris (fan)
        m, _, _ = mesh_io.load_obj(p)
        assert m.num_tris == 2
        np.testing.assert_array_equal(m.tris, [[0, 1, 2], [0, 2, 3]])

    def test_stl_binary_roundtrip(self, tmp_path):
        m = box_mesh((3, 4, 5), (-1, -1, -1))
        p = str(tmp_path / "box.stl")
        mesh_io.save_stl(p, m)
        loaded, mn, mx = mesh_io.load_stl(p)
        assert loaded.num_tris == 12
        assert loaded.num_verts == 36  # duplicated per triangle, no dedup
        np.testing.assert_allclose(mn, [-1, -1, -1])
        np.testing.assert_allclose(mx, [2, 3, 4])

    def test_stl_ascii_roundtrip(self, tmp_path):
        m = box_mesh((1, 1, 1))
        p = str(tmp_path / "box_ascii.stl")
        mesh_io.save_stl(p, m, ascii_format=True)
        loaded, mn, mx = mesh_io.load_stl(p)
        assert loaded.num_tris == 12
        np.testing.assert_allclose(mn, [0, 0, 0], atol=1e-6)

    def test_stl_sniffing_binary_starting_with_solid(self, tmp_path):
        # binary STL whose header says "solid": size equation decides binary
        m = box_mesh((1, 1, 1))
        p = str(tmp_path / "tricky.stl")
        mesh_io.save_stl(p, m)
        with open(p, "r+b") as f:
            f.write(b"solid binary header")
        loaded, _, _ = mesh_io.load_stl(p)
        assert loaded.num_tris == 12

    def test_load_mesh_dispatch(self, tmp_path):
        m = box_mesh()
        po = str(tmp_path / "a.OBJ")  # case-insensitive
        mesh_io.save_obj(po, m)
        loaded, _, _ = mesh_io.load_mesh(po)
        assert loaded.num_tris == 12
        with pytest.raises(mesh_io.MeshLoadError):
            mesh_io.load_mesh(str(tmp_path / "a.ply"))


class TestSDFIO:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        phi = rng.standard_normal((5, 6, 7)).astype(np.float32)
        p = str(tmp_path / "t.sdf")
        inside = sdf_io.write_sdf(p, phi, (1.0, 2.0, 3.0), 0.25)
        assert inside == int((phi < 0).sum())
        phi2, mn, mx = sdf_io.read_sdf(p)
        np.testing.assert_array_equal(phi, phi2)
        np.testing.assert_allclose(mn, [1, 2, 3])
        np.testing.assert_allclose(mx, [1 + 5 * 0.25, 2 + 6 * 0.25, 3 + 7 * 0.25])

    def test_header_layout(self, tmp_path):
        phi = np.zeros((2, 3, 4), np.float32)
        p = str(tmp_path / "h.sdf")
        sdf_io.write_sdf(p, phi, (0, 0, 0), 1.0)
        raw = open(p, "rb").read()
        assert len(raw) == 36 + 2 * 3 * 4 * 4
        dims = np.frombuffer(raw[:12], "<i4")
        np.testing.assert_array_equal(dims, [2, 3, 4])

    def test_invalid_dims(self, tmp_path):
        p = str(tmp_path / "bad.sdf")
        with open(p, "wb") as f:
            f.write(np.array([-1, 3, 4], "<i4").tobytes())
            f.write(np.zeros(6, "<f4").tobytes())
        with pytest.raises(sdf_io.SDFIOError):
            sdf_io.read_sdf(p)


class TestMesh:
    def test_validation(self):
        with pytest.raises(ValueError):
            Mesh(np.zeros((3, 2), np.float32), np.zeros((1, 3), np.uint32))
        m = Mesh(np.zeros((3, 3), np.float32), np.array([[0, 1, 5]], np.uint32))
        with pytest.raises(ValueError):
            m.validate_indices()


class TestNativeBinning:
    def test_native_matches_numpy(self):
        import numpy as np
        from sdfgenfast.grid import GridSpec
        from sdfgenfast.io import native
        from sdfgenfast.mesh import icosphere
        from sdfgenfast.ops import band as band_ops

        if not native.available() or native.bin_triangles_native(
            np.zeros((3, 3), np.float32), np.zeros((1, 3), np.uint32),
            (0, 0, 0), 0.5, (4, 4, 4), 1, (4, 4, 4),
        ) is None:
            import pytest
            pytest.skip("native binning unavailable")

        m = icosphere(3, radius=1.0, center=(0.04, -0.06, 0.02))
        g = GridSpec((-1.37, -1.29, -1.33), 0.093, (30, 29, 31))
        bb = band_ops.bin_triangles(m.verts, m.tris, g, 3, (8, 8, 8))

        orig = native.bin_triangles_native
        try:
            native.bin_triangles_native = lambda *a, **k: None
            ref = band_ops.bin_triangles(m.verts, m.tris, g, 3, (8, 8, 8))
        finally:
            native.bin_triangles_native = orig

        np.testing.assert_array_equal(bb.active_ids, ref.active_ids)
        np.testing.assert_array_equal(bb.cand, ref.cand)
        np.testing.assert_array_equal(bb.cand_valid, ref.cand_valid)
        assert bb.tiles_dim == ref.tiles_dim

    def test_native_threaded_matches_numpy(self):
        # >= 8192 triangles engages the multi-threaded chunked fill
        # (csrc/sdfbin.cpp pick_threads); candidate ORDER must still be the
        # serial ascending-triangle order bit-for-bit
        import numpy as np
        from sdfgenfast.grid import GridSpec
        from sdfgenfast.io import native
        from sdfgenfast.mesh import icosphere
        from sdfgenfast.ops import band as band_ops

        if not native.available():
            import pytest
            pytest.skip("native binning unavailable")

        m = icosphere(5, radius=1.0, center=(0.04, -0.06, 0.02))  # 20480 tris
        assert m.num_tris >= 8192
        g = GridSpec((-1.37, -1.29, -1.33), 2.7 / 64, (64, 63, 65))
        bb = band_ops.bin_triangles(m.verts, m.tris, g, 3, (8, 8, 8),
                                    prune=True)

        orig = native.bin_triangles_native
        try:
            native.bin_triangles_native = lambda *a, **k: None
            ref = band_ops.bin_triangles(m.verts, m.tris, g, 3, (8, 8, 8),
                                         prune=True)
        finally:
            native.bin_triangles_native = orig

        np.testing.assert_array_equal(bb.active_ids, ref.active_ids)
        np.testing.assert_array_equal(bb.cand, ref.cand)
        np.testing.assert_array_equal(bb.cand_valid, ref.cand_valid)


class TestTorusMesh:
    def test_flagship_size_and_watertight(self):
        import numpy as np
        from sdfgenfast.mesh import torus_mesh

        m = torus_mesh()
        assert m.num_tris == 100352  # the 100k-triangle benchmark mesh
        m.validate_indices()
        # watertight: every directed edge appears exactly once (its reverse
        # closes the surface)
        t = m.tris.astype(np.int64)
        edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        keys = edges[:, 0] * m.num_verts + edges[:, 1]
        rev = edges[:, 1] * m.num_verts + edges[:, 0]
        assert len(np.unique(keys)) == len(keys)
        assert np.array_equal(np.sort(keys), np.sort(rev))
