

class TestCrossingsTransport:
    def test_crossings_reconstruct_parity_both_branches(self):
        import numpy as np
        import jax.numpy as jnp
        from sdfgenfast import GridSpec
        from sdfgenfast.io import native
        from sdfgenfast.mesh import icosphere
        from sdfgenfast.ops import sign_host

        m = icosphere(2, radius=1.0, center=(0.04, -0.03, 0.02))
        g = GridSpec((-1.3, -1.25, -1.28), 0.09, (30, 29, 31))
        ref = sign_host.parity_field_host(m.verts, m.tris, g)

        # whichever branch is live (native preferred)
        cr = sign_host.crossings_host(m.verts, m.tris, g)
        got = np.asarray(sign_host.parity_from_crossings_device(
            jnp.asarray(cr), g.shape[0]))
        np.testing.assert_array_equal(got, ref)

        # force the NumPy fallback branch too
        orig = native.crossings
        try:
            native.crossings = lambda *a, **k: None
            cr2 = sign_host.crossings_host(m.verts, m.tris, g)
        finally:
            native.crossings = orig
        got2 = np.asarray(sign_host.parity_from_crossings_device(
            jnp.asarray(cr2), g.shape[0]))
        np.testing.assert_array_equal(got2, ref)
