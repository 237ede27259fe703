"""brickmap_tpu — a differentiable sparse-voxel path tracer.

A from-scratch JAX/Pallas framework with the capabilities of the CUDA
BrickMap renderer (stijnherfst/BrickMap): two-level sparse voxel grids
(superchunks of 16^3 bricks of 8^3 voxels), 3-level LoD hierarchical DDA,
Preetham-style sun/sky, multi-bounce path tracing with sun NEE — plus a
differentiable-transmittance backward pass and multi-chip ray sharding that the
reference does not have.
"""

from . import bits, config
from .config import (
    BrickmapConfig,
    GridConfig,
    MeshConfig,
    PRESETS,
    RenderConfig,
    SunSkyConfig,
)

__version__ = "0.1.0"

__all__ = [
    "bits",
    "config",
    "BrickmapConfig",
    "GridConfig",
    "MeshConfig",
    "PRESETS",
    "RenderConfig",
    "SunSkyConfig",
]
