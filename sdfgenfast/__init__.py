"""sdfgenfast — a differentiable mesh -> signed-distance-field framework
(JAX / XLA / Pallas) for NVIDIA GPUs, built from scratch with the
capabilities of the C++/CUDA reference SDFGenFast.

Public surface mirrors the reference package ``sdfgen`` (python/sdfgen.py):
``load_mesh, generate_sdf, save_sdf, load_sdf, is_gpu_available,
generate_from_mesh, generate_from_file`` — plus the new differentiable
pipeline (``pipeline.make_level_set3`` with vertex gradients) and multi-chip
sharding (``parallel``).
"""

__version__ = "0.3.0"

from .api import (  # noqa: F401
    generate_from_file,
    generate_from_mesh,
    generate_sdf,
    generate_sdf_batch,
    is_gpu_available,
    load_mesh,
    load_sdf,
    save_sdf,
)
from .grid import GridSpec  # noqa: F401
from .mesh import Mesh, box_mesh  # noqa: F401
from .pipeline import SDFConfig, bin_mesh, make_level_set3  # noqa: F401

__all__ = [
    "load_mesh",
    "generate_sdf",
    "generate_sdf_batch",
    "save_sdf",
    "load_sdf",
    "is_gpu_available",
    "generate_from_mesh",
    "generate_from_file",
    "GridSpec",
    "Mesh",
    "box_mesh",
    "SDFConfig",
    "bin_mesh",
    "make_level_set3",
]
