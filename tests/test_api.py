"""Public-API tests mirroring the reference's 51-test pytest suite
(``python/tests/test_sdfgen.py:97-1030``, 9 classes). Same class structure,
same behavioral contracts: auto-conversion of compatible dtypes, shape
rejection, error types, backend dispatch, SDF sign properties, and edge cases
(single/degenerate triangles, far-from-origin meshes, dx <= 0).

Grids are kept tiny and shapes shared across tests so jit caches amortize.
"""

import os
import tempfile

import jax
import numpy as np
import pytest

import sdfgenfast as sdfgen
from sdfgenfast import mesh as mesh_mod


@pytest.fixture
def simple_cube():
    """1x1x1 cube centered at the origin — the reference's fixture geometry
    (test_sdfgen.py:15-58), rebuilt from our own mesh generator."""
    from sdfgenfast.mesh import box_mesh

    m = box_mesh((1.0, 1.0, 1.0), (-0.5, -0.5, -0.5))
    return m.verts, m.tris


@pytest.fixture
def temp_obj_file(simple_cube):
    vertices, triangles = simple_cube
    with tempfile.NamedTemporaryFile(mode="w", suffix=".obj", delete=False) as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in triangles:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
        path = f.name
    yield path
    os.unlink(path)


@pytest.fixture
def temp_sdf_file():
    with tempfile.NamedTemporaryFile(suffix=".sdf", delete=False) as f:
        path = f.name
    yield path
    if os.path.exists(path):
        os.unlink(path)


def _gen(vertices, triangles, **kw):
    args = dict(origin=(-1.0, -1.0, -1.0), dx=0.1, nx=20, ny=20, nz=20)
    args.update(kw)
    return sdfgen.generate_sdf(vertices, triangles, **args)


class TestBasicFunctionality:
    def test_generate_sdf_from_arrays(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles)
        assert sdf.shape == (20, 20, 20)
        assert sdf.dtype == np.float32
        assert np.all(np.isfinite(sdf))
        assert np.any(sdf < 0) and np.any(sdf > 0)

    def test_load_mesh_from_file(self, temp_obj_file):
        vertices, triangles, bounds = sdfgen.load_mesh(temp_obj_file)
        assert vertices.shape == (8, 3) and vertices.dtype == np.float32
        assert triangles.shape == (12, 3) and triangles.dtype == np.uint32
        mn, mx = bounds
        np.testing.assert_allclose(mn, (-0.5, -0.5, -0.5))
        np.testing.assert_allclose(mx, (0.5, 0.5, 0.5))

    def test_generate_from_file(self, temp_obj_file):
        sdf, meta = sdfgen.generate_from_file(temp_obj_file, nx=16)
        assert sdf.shape[0] == 16 + 2  # nx + 2*padding
        assert "origin" in meta and "dx" in meta and "bounds" in meta

    def test_generate_from_mesh(self, simple_cube):
        vertices, triangles = simple_cube
        sdf, meta = sdfgen.generate_from_mesh(vertices, triangles, nx=16)
        assert sdf.shape[0] == 16 + 2
        assert meta["dx"] > 0

    def test_save_and_load_sdf(self, simple_cube, temp_sdf_file):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles)
        sdfgen.save_sdf(temp_sdf_file, sdf, origin=(-1.0, -1.0, -1.0), dx=0.1)
        loaded, origin, dx, bounds = sdfgen.load_sdf(temp_sdf_file)
        assert loaded.shape == sdf.shape
        np.testing.assert_array_equal(loaded, sdf)
        np.testing.assert_allclose(origin, (-1.0, -1.0, -1.0), atol=1e-6)
        assert abs(dx - 0.1) < 1e-6


class TestBackends:
    def test_is_gpu_available(self):
        assert isinstance(sdfgen.is_gpu_available(), bool)
        # the probe looks for CUDA devices only: the CPU never counts
        assert sdfgen.is_gpu_available() == bool(
            [d for d in jax.devices() if d.platform == "gpu"])

    def test_cpu_backend(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles, backend="cpu")
        assert sdf.shape == (20, 20, 20)

    @pytest.mark.gpu
    def test_gpu_backend(self, gpu, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles, backend="gpu")
        assert sdf.shape == (20, 20, 20)
        np.testing.assert_allclose(
            sdf, _gen(vertices, triangles, backend="cpu"),
            atol=5e-6, rtol=1e-5)

    def test_auto_backend_matches_cpu(self, simple_cube):
        # the analog of the reference's CPU/GPU consistency check
        # (test_sdfgen.py:268); with parity host-computed the results of the
        # two dispatch targets must agree to float32 roundoff
        vertices, triangles = simple_cube
        a = _gen(vertices, triangles, backend="auto")
        c = _gen(vertices, triangles, backend="cpu")
        np.testing.assert_allclose(a, c, atol=5e-6, rtol=1e-5)


class TestParameters:
    def test_different_grid_sizes(self, simple_cube):
        vertices, triangles = simple_cube
        for n in (8, 16):
            sdf = _gen(vertices, triangles, nx=n, ny=n, nz=n, dx=2.0 / n)
            assert sdf.shape == (n, n, n)

    def test_non_uniform_grid(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles, nx=8, ny=16, nz=24, dx=0.12)
        assert sdf.shape == (8, 16, 24)

    def test_different_cell_sizes(self, simple_cube):
        vertices, triangles = simple_cube
        coarse = _gen(vertices, triangles, dx=0.2)
        fine = _gen(vertices, triangles, dx=0.05)
        assert coarse.shape == fine.shape == (20, 20, 20)
        assert not np.array_equal(coarse, fine)

    def test_exact_band_parameter(self, simple_cube):
        vertices, triangles = simple_cube
        for band in (1, 2, 3):
            sdf = _gen(vertices, triangles, exact_band=band)
            assert sdf.shape == (20, 20, 20)

    def test_num_threads_parameter(self, simple_cube):
        # accepted for reference compatibility, ignored (device parallelism)
        vertices, triangles = simple_cube
        a = _gen(vertices, triangles, num_threads=1)
        b = _gen(vertices, triangles, num_threads=8)
        np.testing.assert_array_equal(a, b)


class TestErrorHandling:
    def test_invalid_backend(self, simple_cube):
        vertices, triangles = simple_cube
        with pytest.raises((ValueError, RuntimeError)):
            _gen(vertices, triangles, backend="invalid")

    def test_invalid_mesh_file(self):
        with pytest.raises(Exception):
            sdfgen.load_mesh("nonexistent_file.obj")

    def test_invalid_array_shapes(self):
        bad_vertices = np.array([[1, 2]], dtype=np.float32)  # missing Z
        triangles = np.array([[0, 1, 2]], dtype=np.uint32)
        with pytest.raises(TypeError):
            _gen(bad_vertices, triangles)


class TestSDFProperties:
    def test_zero_crossing_at_surface(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles)
        # the surface (|x|=0.5 cube) must be bracketed by a sign change along
        # the center row
        row = sdf[:, 10, 10]
        signs = np.sign(row)
        assert np.any(signs[:-1] != signs[1:])

    def test_inside_negative_outside_positive(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles)
        assert sdf[10, 10, 10] < 0  # grid center = cube center
        assert sdf[0, 0, 0] > 0  # corner, far outside
        # inside magnitude bounded by the cube's inradius
        assert sdf[10, 10, 10] >= -0.5 - 0.1


class TestCriticalErrorHandling:
    def test_save_sdf_invalid_path(self, simple_cube):
        sdf = np.zeros((2, 2, 2), np.float32)
        with pytest.raises(Exception):
            sdfgen.save_sdf(
                "/nonexistent_dir_xyz/test.sdf", sdf, origin=(0, 0, 0), dx=0.1
            )

    def test_save_sdf_auto_converts_dtype(self, temp_sdf_file):
        sdf_int32 = np.array([[[1, 2], [3, 4]]], dtype=np.int32)
        sdfgen.save_sdf(temp_sdf_file, sdf_int32, origin=(0, 0, 0), dx=0.1)
        loaded, *_ = sdfgen.load_sdf(temp_sdf_file)
        assert loaded.dtype == np.float32
        assert loaded.shape == (1, 2, 2)

    def test_load_sdf_nonexistent_file(self):
        with pytest.raises(Exception):
            sdfgen.load_sdf("nonexistent_file_xyz.sdf")

    def test_load_sdf_corrupted_file(self):
        with tempfile.NamedTemporaryFile(mode="wb", suffix=".sdf", delete=False) as f:
            f.write(b"corrupted data")
            path = f.name
        try:
            with pytest.raises(Exception):
                sdfgen.load_sdf(path)
        finally:
            os.unlink(path)

    def test_load_sdf_bad_dims(self):
        # negative dims in the header must be rejected (sdf_io.cpp:94-99)
        header = np.zeros(9, np.float32)
        header[:3] = np.array([-1, 4, 4], np.int32).view(np.float32)
        with tempfile.NamedTemporaryFile(mode="wb", suffix=".sdf", delete=False) as f:
            f.write(np.array([-1, 4, 4], "<i4").tobytes())
            f.write(np.zeros(6, "<f4").tobytes())
            f.write(np.zeros(64, "<f4").tobytes())
            path = f.name
        try:
            with pytest.raises(Exception):
                sdfgen.load_sdf(path)
        finally:
            os.unlink(path)

    def test_generate_sdf_empty_mesh(self):
        empty_vertices = np.zeros((0, 3), np.float32)
        empty_triangles = np.zeros((0, 3), np.uint32)
        with pytest.raises(ValueError):
            _gen(empty_vertices, empty_triangles)

    def test_generate_sdf_invalid_grid_size(self, simple_cube):
        vertices, triangles = simple_cube
        with pytest.raises(ValueError):
            _gen(vertices, triangles, nx=0)
        with pytest.raises(ValueError):
            _gen(vertices, triangles, nx=-10)

    def test_generate_from_file_missing_parameters(self, temp_obj_file):
        with pytest.raises(ValueError):
            sdfgen.generate_from_file(temp_obj_file)  # neither nx nor dx

    def test_load_mesh_corrupted_file(self):
        with tempfile.NamedTemporaryFile(mode="w", suffix=".obj", delete=False) as f:
            f.write("invalid obj data\nnot a valid format\n")
            path = f.name
        try:
            with pytest.raises(Exception):
                sdfgen.load_mesh(path)
        finally:
            os.unlink(path)


class TestHighLevelAPIParameters:
    def test_generate_from_file_with_dx(self, temp_obj_file):
        sdf, meta = sdfgen.generate_from_file(temp_obj_file, dx=0.1)
        assert abs(meta["dx"] - 0.1) < 1e-9
        # cube extent 1.0 / 0.1 = 10 cells + 2*padding
        assert sdf.shape == (12, 12, 12)

    def test_generate_from_file_with_explicit_grid(self, temp_obj_file):
        sdf, meta = sdfgen.generate_from_file(temp_obj_file, nx=10, ny=12, nz=14)
        assert sdf.shape == (12, 14, 16)  # + 2*padding each

    def test_generate_from_file_different_paddings(self, temp_obj_file):
        for pad in (1, 2, 4):
            sdf, meta = sdfgen.generate_from_file(temp_obj_file, nx=10, padding=pad)
            assert sdf.shape[0] == 10 + 2 * pad

    def test_generate_from_file_backends(self, temp_obj_file):
        sdf, meta = sdfgen.generate_from_file(temp_obj_file, nx=10, backend="cpu")
        assert meta["backend"] == "cpu"

    def test_generate_from_file_threads(self, temp_obj_file):
        sdf, _ = sdfgen.generate_from_file(temp_obj_file, nx=10, num_threads=4)
        assert sdf.shape[0] == 12

    def test_generate_from_mesh_proportional_sizing(self, simple_cube):
        vertices, triangles = simple_cube
        sdf, meta = sdfgen.generate_from_mesh(vertices, triangles, nx=10)
        assert sdf.shape == (12, 12, 12)  # cube: proportional == equal

    def test_generate_from_mesh_explicit_sizing(self, simple_cube):
        vertices, triangles = simple_cube
        sdf, meta = sdfgen.generate_from_mesh(vertices, triangles, nx=8, ny=10, nz=12)
        assert sdf.shape == (10, 12, 14)

    def test_generate_from_mesh_different_paddings(self, simple_cube):
        vertices, triangles = simple_cube
        for pad in (1, 3):
            sdf, meta = sdfgen.generate_from_mesh(
                vertices, triangles, nx=10, padding=pad
            )
            assert sdf.shape[0] == 10 + 2 * pad

    def test_generate_from_mesh_backends(self, simple_cube):
        vertices, triangles = simple_cube
        sdf, meta = sdfgen.generate_from_mesh(
            vertices, triangles, nx=10, backend="cpu"
        )
        assert meta["backend"] == "cpu"

    def test_generate_from_mesh_with_dx(self, simple_cube):
        vertices, triangles = simple_cube
        sdf, meta = sdfgen.generate_from_mesh(vertices, triangles, nx=10, dx=0.1)
        assert abs(meta["dx"] - 0.1) < 1e-9


class TestDataValidation:
    def test_generate_sdf_wrong_vertex_dtype(self, simple_cube):
        # int32 vertices auto-convert to float32 (test_sdfgen.py:770)
        vertices, triangles = simple_cube
        sdf = _gen((vertices * 2).astype(np.int32), triangles)
        assert sdf.shape == (20, 20, 20) and sdf.dtype == np.float32

    def test_generate_sdf_wrong_triangle_dtype(self, simple_cube):
        # int32 triangles auto-convert to uint32 (test_sdfgen.py:786)
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles.astype(np.int32))
        assert sdf.shape == (20, 20, 20) and sdf.dtype == np.float32

    def test_generate_sdf_float64_vertices(self, simple_cube):
        vertices, triangles = simple_cube
        sdf64 = _gen(vertices.astype(np.float64), triangles)
        sdf32 = _gen(vertices, triangles)
        np.testing.assert_array_equal(sdf64, sdf32)

    def test_generate_sdf_non_contiguous_arrays(self, simple_cube):
        vertices, triangles = simple_cube
        temp = np.zeros((vertices.shape[0] * 2, 3), np.float32)
        temp[::2] = vertices
        non_contig = temp[::2]
        assert not non_contig.flags["C_CONTIGUOUS"]
        sdf = _gen(non_contig, triangles)
        np.testing.assert_array_equal(sdf, _gen(vertices, triangles))

    def test_generate_sdf_out_of_bounds_indices(self, simple_cube):
        vertices, _ = simple_cube
        bad = np.array([[0, 1, 999], [1, 2, 3]], dtype=np.uint32)
        with pytest.raises(ValueError):
            _gen(vertices, bad)

    def test_generate_sdf_negative_indices(self, simple_cube):
        vertices, _ = simple_cube
        bad = np.array([[0, 1, -1]], dtype=np.int32)
        with pytest.raises(ValueError):
            _gen(vertices, bad)

    def test_generate_sdf_1d_arrays(self, simple_cube):
        vertices, triangles = simple_cube
        with pytest.raises(TypeError):
            _gen(vertices.flatten(), triangles)
        with pytest.raises(TypeError):
            _gen(vertices, triangles.flatten())


class TestEdgeCases:
    def test_single_triangle_mesh(self):
        vertices = np.array(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32
        )
        triangles = np.array([[0, 1, 2]], np.uint32)
        sdf = sdfgen.generate_sdf(
            vertices, triangles, origin=(-0.5, -0.5, -0.5), dx=0.1,
            nx=20, ny=20, nz=20,
        )
        assert sdf.shape == (20, 20, 20)
        assert np.all(np.isfinite(sdf))

    def test_minimum_grid_size(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = sdfgen.generate_sdf(
            vertices, triangles, origin=(0.0, 0.0, 0.0), dx=1.0, nx=1, ny=1, nz=1
        )
        assert sdf.shape == (1, 1, 1)

    def test_degenerate_triangles(self):
        vertices = np.full((3, 3), 0.5, np.float32)  # all coincident
        triangles = np.array([[0, 1, 2]], np.uint32)
        sdf = sdfgen.generate_sdf(
            vertices, triangles, origin=(0.0, 0.0, 0.0), dx=0.1,
            nx=10, ny=10, nz=10,
        )
        assert sdf.shape == (10, 10, 10)
        assert np.all(np.isfinite(sdf))
        # distance to the degenerate triangle == distance to the point
        d_point = np.abs(sdf[5, 5, 5])
        expected = np.linalg.norm(np.array([0.5, 0.5, 0.5]) - 0.5)
        assert abs(d_point - expected) < 0.2

    def test_mesh_far_from_origin(self):
        from sdfgenfast.mesh import box_mesh

        offset = 1000.0
        m = box_mesh((1.0, 1.0, 1.0), (offset, offset, offset))
        sdf = sdfgen.generate_sdf(
            m.verts, m.tris,
            origin=(offset - 0.5, offset - 0.5, offset - 0.5), dx=0.1,
            nx=20, ny=20, nz=20,
        )
        assert sdf.shape == (20, 20, 20)
        assert np.all(np.isfinite(sdf))
        assert sdf[10, 10, 10] < 0  # center is inside

    def test_very_fine_resolution(self, simple_cube):
        vertices, triangles = simple_cube
        sdf = _gen(vertices, triangles, dx=0.001)
        assert sdf.shape == (20, 20, 20)

    def test_zero_dx_error(self, simple_cube):
        vertices, triangles = simple_cube
        with pytest.raises(ValueError):
            _gen(vertices, triangles, dx=0.0)

    def test_negative_dx_error(self, simple_cube):
        vertices, triangles = simple_cube
        with pytest.raises(ValueError):
            _gen(vertices, triangles, dx=-0.1)

    def test_gpu_backend_when_unavailable(self, simple_cube, monkeypatch):
        # forced 'gpu' without a CUDA device raises, like the reference's
        # forced-GPU throw (common/sdfgen_unified.cpp:60-63)
        from sdfgenfast import api

        monkeypatch.setattr(api, "_gpu_devices", lambda: [])
        vertices, triangles = simple_cube
        with pytest.raises(RuntimeError):
            _gen(vertices, triangles, backend="gpu")

    @pytest.mark.parametrize("name", ["cuda", "rocm"])
    def test_backend_outside_vocabulary_rejected(self, simple_cube, name):
        # only the reference's words: "auto" | "cpu" | "gpu"
        vertices, triangles = simple_cube
        with pytest.raises(ValueError):
            _gen(vertices, triangles, backend=name)


class TestBatchAPI:
    """generate_sdf_batch: one shared grid, compiled-program reuse across
    meshes (the batch capability — the reference has no
    batch API)."""

    def test_batch_matches_individual(self):
        sg = sdfgen
        rng = np.random.default_rng(5)
        base = mesh_mod.icosphere(2, radius=1.0)
        meshes = []
        for k in range(3):
            v = base.verts + rng.normal(scale=0.01, size=base.verts.shape
                                        ).astype(np.float32)
            meshes.append((v, base.tris))
        origin, dx, dims = (-1.4, -1.4, -1.4), 2.8 / 32, (32, 32, 32)
        batch = sg.generate_sdf_batch(meshes, origin, dx, *dims)
        assert len(batch) == 3
        for (v, t), phi in zip(meshes, batch):
            single = sg.generate_sdf(v, t, origin, dx, *dims)
            np.testing.assert_array_equal(phi, single)

    def test_batch_mixed_crossing_counts(self):
        # meshes with DIFFERENT natural crossings-row buckets (a sphere has
        # 2 x-ray crossings/column, two nested spheres 4): the batch pads
        # later transports to the running max so one traced program serves
        # both, and the padding must not change any value vs single calls
        sg = sdfgen
        s_out = mesh_mod.icosphere(2, radius=1.0)
        s_in = mesh_mod.icosphere(2, radius=0.5)
        nested_v = np.concatenate([s_out.verts, s_in.verts])
        nested_t = np.concatenate(
            [s_out.tris, s_in.tris + len(s_out.verts)])
        meshes = [(s_out.verts, s_out.tris), (nested_v, nested_t)]
        origin, dx, dims = (-1.4, -1.4, -1.4), 2.8 / 32, (32, 32, 32)
        batch = sg.generate_sdf_batch(meshes, origin, dx, *dims)
        for (v, t), phi in zip(meshes, batch):
            single = sg.generate_sdf(v, t, origin, dx, *dims)
            np.testing.assert_array_equal(phi, single)

    def test_batch_rejects_empty_mesh(self):
        sg = sdfgen
        with pytest.raises(ValueError, match="empty mesh"):
            sg.generate_sdf_batch(
                [(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32))],
                (0, 0, 0), 0.1, 8, 8, 8)

    def test_batch_bad_grid(self):
        sg = sdfgen
        m = mesh_mod.box_mesh()
        with pytest.raises(ValueError, match="positive"):
            sg.generate_sdf_batch([(m.verts, m.tris)], (0, 0, 0), 0.1, 0, 8, 8)
