"""Static configuration for the brickmap renderer.

The reference keeps every world/tuning constant as compile-time ``constexpr``
(``variables.h:3-35``).  The equivalent here is a frozen
dataclass whose instances are hashable and therefore usable as ``static_argnums``
to :func:`jax.jit` — same "everything static" philosophy, but selectable per run.

Geometry conventions (identical to the reference):

* world voxels: ``x, y in [0, grid_size)``, ``z in [0, grid_height)``; voxel edge = 1
  world unit.
* brick: ``brick_size**3`` voxels (8x8x8 = 512 occupancy bits = 16 uint32 words).
* brick grid ("cells"): ``cells x cells x cells_height`` bricks.
* superchunk: ``supergrid_cell_size**3`` bricks; superchunk grid is
  ``supergrid_xy x supergrid_xy x supergrid_z``.

Index-word bit layout (reference ``variables.h:29-33``)::

    [31: loaded | 30: unloaded | 29: requested | 19:12 lod 2x2x2 byte | 11:0 slot]

The 12-bit slot indexes a brick *within its superchunk's pool segment*; this
build stores all segments in one device-resident linear pool and adds a
per-superchunk base offset (see :mod:`brickmap_tpu.scene`), replacing the reference's per-superchunk
device pointers (``Scene.h:9-17``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Bit-format constants (shared between host and device code).
# Reference: variables.h:29-33.
# ---------------------------------------------------------------------------
BRICK_INDEX_BITS = 0xFFF          # 12-bit slot within superchunk pool segment
BRICK_LOD_BITS = 0xFF000          # 8-bit 2x2x2 coarse-occupancy byte, bits 12-19
BRICK_LOD_SHIFT = 12
BRICK_LOADED_BIT = 0x8000_0000    # brick payload resident in pool
BRICK_UNLOADED_BIT = 0x4000_0000  # brick exists but payload not resident
BRICK_REQUESTED_BIT = 0x2000_0000  # residency request outstanding
BRICK_FLAG_BITS = 0xE000_0000     # any of the three state flags above

# Extension (bits 28:20, unused by the reference format): for EMPTY cells
# the index word carries the Chebyshev (L-inf) distance to the nearest
# non-empty brick cell, enabling empty-space skipping with a single gather per
# traversal step.  Occupied cells always have a flag bit set; empty cells are
# word == 0 (unknown distance) or pure distance bits.
BRICK_DIST_SHIFT = 20
BRICK_DIST_MASK = 0x1FF0_0000     # 9 bits -> skip radius up to 511 cells

PI = math.pi


@dataclass(frozen=True)
class GridConfig:
    """World geometry. Reference: variables.h:7-20."""

    grid_size: int = 4096          # world extent in voxels along x and y
    grid_height: int = 512         # world extent in voxels along z
    brick_size: int = 8            # voxels per brick edge
    supergrid_cell_size: int = 16  # bricks per superchunk edge

    # LoD squared distances in brick units. Reference: variables.h:25-27.
    lod_distance_8: int = 600_000
    lod_distance_2: int = 100_000

    epsilon: float = 0.001         # self-intersection offset (variables.h:22)

    def __post_init__(self) -> None:
        if self.grid_size % (self.brick_size * self.supergrid_cell_size):
            raise ValueError("grid_size must be a multiple of brick*supergrid size")
        if self.grid_height % (self.brick_size * self.supergrid_cell_size):
            raise ValueError("grid_height must be a multiple of brick*supergrid size")

    # -- derived brick-grid extents (variables.h:17-20) ---------------------
    @property
    def cells(self) -> int:
        return self.grid_size // self.brick_size

    @property
    def cells_height(self) -> int:
        return self.grid_height // self.brick_size

    @property
    def cell_members(self) -> int:
        """uint32 words of occupancy bits per brick (512/32 = 16)."""
        return self.brick_size ** 3 // 32

    # -- derived superchunk-grid extents (variables.h:12-13) ----------------
    @property
    def supergrid_xy(self) -> int:
        return self.cells // self.supergrid_cell_size

    @property
    def supergrid_z(self) -> int:
        return self.cells_height // self.supergrid_cell_size

    @property
    def num_superchunks(self) -> int:
        return self.supergrid_xy * self.supergrid_xy * self.supergrid_z

    @property
    def bricks_per_superchunk(self) -> int:
        return self.supergrid_cell_size ** 3

    @property
    def world_max(self) -> tuple[float, float, float]:
        return (float(self.grid_size), float(self.grid_size), float(self.grid_height))


@dataclass(frozen=True)
class SunSkyConfig:
    """Preetham-style sky model constants. Reference: sunsky.cuh:24-42."""

    sun_size_deg: float = 1.5        # angular sun diameter (physical sun: 0.53)
    cutoff_angle: float = PI / 1.95
    steepness: float = 1.5
    sky_factor: float = 1.0
    turbidity: float = 1.0
    mie_coefficient: float = 0.005
    mie_directional_g: float = 0.80
    v: float = 4.0
    rayleigh_zenith_length: float = 8.4e3
    mie_zenith_length: float = 1.25e3
    sun_intensity: float = 1000.0
    primary_wavelengths: tuple[float, float, float] = (680e-9, 550e-9, 450e-9)
    # K (extinction mix) — sunsky.cu:4
    k: tuple[float, float, float] = (0.686, 0.678, 0.666)

    @property
    def sun_angular_diameter_cos(self) -> float:
        return math.cos(self.sun_size_deg * PI / 180.0)


@dataclass(frozen=True)
class RenderConfig:
    """Per-run rendering parameters.

    Reference analogs: resolution main.cpp:49; MAX_BOUNCES kernel.cu:13;
    ray pool variables.h:61; DoF camera.h:8-10.
    """

    width: int = 1920
    height: int = 1080
    max_bounces: int = 3
    samples_per_pixel: int = 1       # samples per pixel per render step
    focal_distance: float = 1.0
    lens_radius: float = 0.0
    # Traversal step caps (static loop bounds for lax.while_loop safety).
    max_top_steps: int = 2048        # top-level DDA steps across the brick grid
    max_brick_steps: int = 22        # 8x8x8 DDA worst case = 3*8 - 2
    max_byte_steps: int = 4          # 2x2x2 DDA worst case = 3*2 - 2
    # Traversal implementation: "auto" = the Triton march kernel on a GPU
    # and the XLA reference on the CPU; "xla" forces the XLA traversal
    # (render.pathtrace._trace).
    traversal: str = "auto"
    # In-program rescue of budget-exhausted lanes (render.pathtrace):
    # rescue_passes - 1 passes with max_top_steps = rescue_top_steps
    # re-sort stragglers by their current superchunk (resume-from-t), then
    # a final pass whose budget no ray can exhaust.
    rescue_passes: int = 1
    rescue_top_steps: int = 512

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip rendering.

    The reference is single-GPU (SURVEY.md §2 P6-P9); rays/tiles are sharded over
    a 1-axis ``rays`` mesh and grid parameters are replicated, with gradient
    ``pmean`` over NVLink (XLA hands the collectives to NCCL; every card
    reaches every other at the same rate, so one axis is enough; see
    brickmap_tpu/parallel/).
    """

    axis_name: str = "rays"
    num_devices: int = 1


@dataclass(frozen=True)
class BrickmapConfig:
    """Top-level bundle: everything jit needs as a static argument."""

    grid: GridConfig = GridConfig()
    sky: SunSkyConfig = SunSkyConfig()
    render: RenderConfig = RenderConfig()
    mesh: MeshConfig = MeshConfig()
    seed: int = 0

    def replace(self, **kw) -> "BrickmapConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The 5 BASELINE.json configs as presets.
# ---------------------------------------------------------------------------

def preset_single_brick() -> BrickmapConfig:
    """Config 1: single 8x8x8 brick, primary rays only, 256x256."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=128, grid_height=128),
        render=RenderConfig(width=256, height=256, max_bounces=0,
                            max_top_steps=64),
    )


def preset_one_superchunk() -> BrickmapConfig:
    """Config 2: one superchunk (16^3 bricks), 3-level LoD, sun/sky shading."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=128, grid_height=128),
        render=RenderConfig(width=512, height=512, max_bounces=1,
                            max_top_steps=64),
    )


def preset_terrain() -> BrickmapConfig:
    """Config 3: simplex terrain world, multi-superchunk, pool residency."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=1024, grid_height=256),
        render=RenderConfig(width=960, height=540, max_bounces=3,
                            max_top_steps=512),
    )


def preset_full() -> BrickmapConfig:
    """Config 4: full path tracing at 1920x1080 on the 4096^2x512 world."""
    return BrickmapConfig(
        grid=GridConfig(),
        render=RenderConfig(),
    )


def preset_inverse(num_devices: int = 1) -> BrickmapConfig:
    """Config 5: inverse rendering, rays sharded across devices."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=64, grid_height=64),
        render=RenderConfig(width=128, height=128, max_bounces=0,
                            max_top_steps=48),
        mesh=MeshConfig(num_devices=num_devices),
    )


PRESETS = {
    "single_brick": preset_single_brick,
    "one_superchunk": preset_one_superchunk,
    "terrain": preset_terrain,
    "full": preset_full,
    "inverse": preset_inverse,
}
