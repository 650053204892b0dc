"""Multi-host (2-process) execution of the sharded pipeline on CPU.

Spawns two REAL Python processes, each owning 4 virtual CPU devices, joined
via jax.distributed (the DCN coordination layer); the 8-device global mesh
runs the identical shard_map pipeline, and the assembled result must equal
the single-process 8-device run exactly. This is the SURVEY §7 step-5
multi-host requirement: same code path, collectives spanning processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})

import numpy as np
from sdfgenfast import GridSpec, SDFConfig
from sdfgenfast.mesh import icosphere
from sdfgenfast.parallel import bin_mesh_sharded
from sdfgenfast.parallel.multihost import (
    assemble_blocks, fetch_global, global_device_mesh, initialize,
    sharded_sdf_multihost,
)

pid = int(sys.argv[1])
initialize({coord!r}, 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

mesh = global_device_mesh(shape=(2, 4))
m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
g = GridSpec((-1.4, -1.4, -1.4), 2.8 / {n}, ({n}, {n}, {n}))
cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris={dense_cap},
                vdt_max_hop={max_hop}, sign_mode={sign_mode!r})
sb = bin_mesh_sharded(m, g, (2, 4), cfg)
blocks = sharded_sdf_multihost(sb, mesh, m.verts)
phi = assemble_blocks(fetch_global(blocks))
if pid == 0:
    np.save({out!r}, phi)
print("WORKER_OK", pid, flush=True)
"""


_BATCH_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})

import numpy as np
from sdfgenfast import generate_sdf_batch
from sdfgenfast.mesh import torus_mesh
from sdfgenfast.parallel.multihost import global_device_mesh, initialize

pid = int(sys.argv[1])
initialize({coord!r}, 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

mesh = global_device_mesh(shape=(2, 4))
meshes = []
for scale in (1.0, 0.9):
    m = torus_mesh(nu={nu}, nv={nv}, R=1.0, r=0.4 * scale)
    meshes.append((m.verts, m.tris))
out = generate_sdf_batch(meshes, {origin!r}, {dx!r}, *{dims!r},
                         device_mesh=mesh)
assert len(out) == 2
if pid == 0:
    np.save({out_path!r}, np.stack(out))
print("WORKER_OK", pid, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
# (dense_max_tris, vdt_max_hop, grid n, sign_mode): dense shards, the
# capped halo ladder, the default PYRAMID schedule (max_hop None, 64-grid
# so halo repair rounds actually run), and the on-device SOS sign with
# per-process sign-tile partitions — each must match single-process exactly
@pytest.mark.parametrize("dense_cap,max_hop,n,sign_mode", [
    (1024, 4, 32, "host"), (0, 4, 32, "host"), (0, None, 64, "host"),
    (0, 4, 32, "device")])
def test_two_process_matches_single_process(tmp_path, dense_cap, max_hop, n,
                                            sign_mode):
    out = str(tmp_path / "phi_mh.npy")
    coord = f"127.0.0.1:{_free_port()}"
    script = _WORKER.format(repo=REPO, coord=coord, out=out,
                            dense_cap=dense_cap, max_hop=max_hop, n=n,
                            sign_mode=sign_mode)
    # strip the ambient PYTHONPATH and platform pin: the worker script sets
    # its own, and jax.distributed.initialize must run before ANY backend
    # touch
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "PYTHONPATH")
    }

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in o, f"worker {i}:\n{o[-3000:]}"

    phi_mh = np.load(out)

    # single-process 8-device reference on THIS process's virtual mesh
    from sdfgenfast import GridSpec, SDFConfig
    from sdfgenfast.mesh import icosphere
    from sdfgenfast.parallel import bin_mesh_sharded, make_device_mesh, sharded_sdf

    m = icosphere(2, radius=1.0, center=(0.05, -0.02, 0.03))
    g = GridSpec((-1.4, -1.4, -1.4), 2.8 / n, (n, n, n))
    cfg = SDFConfig(tile2d_shape=(8, 8), dense_max_tris=dense_cap,
                    vdt_max_hop=max_hop, sign_mode=sign_mode)
    dmesh = make_device_mesh(shape=(2, 4))
    sb = bin_mesh_sharded(m, g, (2, 4), cfg)
    phi_single = np.asarray(sharded_sdf(sb, dmesh, verts=m.verts))

    np.testing.assert_array_equal(phi_mh, phi_single)


@pytest.mark.slow
def test_batch_sharded_multihost_512class(tmp_path):
    """The batch x sharded x multihost composition: a BATCH of 100k-triangle meshes at a
    512-class grid across 2 processes x 8 devices (generate_sdf_batch with
    a global device mesh), equal to the sequential single-device batch. The
    i axis is kept thin (8 cells, through the torus midplane) to make the
    virtual-CPU-mesh run affordable; the 512-wide sharded axes are what
    exercise the distributed pyramid."""
    nu = nv = 224  # 2*224*224 = 100,352 triangles
    dims = (8, 512, 512)
    dx = 2.9 / 512
    origin = (-4 * dx, -1.45, -0.45)
    out_path = str(tmp_path / "phi_batch_mh.npy")
    coord = f"127.0.0.1:{_free_port()}"
    script = _BATCH_WORKER.format(
        repo=REPO, coord=coord, out_path=out_path, nu=nu, nv=nv,
        origin=tuple(origin), dx=float(dx), dims=tuple(dims))
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "PYTHONPATH")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in o, f"worker {i}:\n{o[-3000:]}"

    phi_mh = np.load(out_path)
    assert phi_mh.shape == (2, *dims)

    # sequential single-device reference batch
    from sdfgenfast import generate_sdf_batch
    from sdfgenfast.mesh import torus_mesh

    meshes = []
    for scale in (1.0, 0.9):
        m = torus_mesh(nu=nu, nv=nv, R=1.0, r=0.4 * scale)
        meshes.append((m.verts, m.tris))
    ref = generate_sdf_batch(meshes, origin, dx, *dims)
    for a, b in zip(phi_mh, ref):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-6)
        np.testing.assert_array_equal(a < 0, b < 0)
