"""Flagship model: the differentiable mesh->SDF generator as a trainable step.

The reference is a one-shot batch tool; this framework's headline capability
is that the SDF grid is differentiable w.r.t. vertex
positions, so mesh geometry can be OPTIMIZED against grid-space objectives.
This module packages that as a "model": parameters = vertex positions,
forward = SDF grid, training step = gradient descent on an SDF-space loss,
shardable over a (j, k) device mesh with the vertex-gradient all-reduce
inserted by shard_map's transpose.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import GridSpec
from ..mesh import Mesh
from ..pipeline import SDFConfig, Binned, bin_mesh, make_level_set3
from ..parallel import ShardedBinned, bin_mesh_sharded, sharded_sdf

__all__ = ["SDFGenerator", "sgd_step"]


@dataclasses.dataclass
class SDFGenerator:
    """verts are the trainable parameters; topology/binning is static state.

    Rebinning (cheap, host-side) is required when vertices cross cell
    boundaries; `refresh()` does it from current params.
    """

    mesh: Mesh
    grid: GridSpec
    config: SDFConfig = dataclasses.field(default_factory=SDFConfig)
    device_mesh: Optional[object] = None  # jax.sharding.Mesh for multi-chip
    binned: Optional[Binned] = None
    sharded_binned: Optional[ShardedBinned] = None

    def __post_init__(self):
        self.refresh()

    def refresh(self):
        if self.device_mesh is not None:
            self.sharded_binned = bin_mesh_sharded(
                self.mesh, self.grid, self.device_mesh.devices.shape, self.config
            )
        else:
            self.binned = bin_mesh(self.mesh, self.grid, self.config)

    @property
    def params(self) -> jnp.ndarray:
        return jnp.asarray(self.mesh.verts)

    def forward(self, verts: jnp.ndarray) -> jnp.ndarray:
        """SDF grid from vertex positions (differentiable)."""
        if self.device_mesh is not None:
            return sharded_sdf(self.sharded_binned, self.device_mesh, verts=verts)
        return make_level_set3(
            self.mesh, self.grid, self.config, binned=self.binned, verts=verts
        )

    def loss(self, verts: jnp.ndarray, target_phi: jnp.ndarray) -> jnp.ndarray:
        """Mean squared SDF mismatch — the canonical grid-space objective."""
        phi = self.forward(verts)
        return jnp.mean((phi - target_phi) ** 2)

    def train_step(self, verts, target_phi, lr=1e-2):
        """One SGD step on vertex positions. Under a device mesh the vertex
        gradient is psum'd across shards by shard_map's transpose (verified:
        the optimized HLO of the compiled step contains the cross-shard
        all-reduce — `tools/overlap_evidence.py` counts the collectives and
        reports whether the backend emitted them as async start/done pairs
        with compute scheduled inside the in-flight window; the CPU test
        backend emits synchronous collectives)."""
        return sgd_step(self, verts, target_phi, lr)

    def commit(self, verts: jnp.ndarray):
        """Adopt new vertex positions and rebin."""
        self.mesh = Mesh(np.asarray(verts), self.mesh.tris)
        self.refresh()


def sgd_step(model: SDFGenerator, verts, target_phi, lr):
    loss, grad = jax.value_and_grad(model.loss)(verts, target_phi)
    return verts - jnp.float32(lr) * grad, loss
