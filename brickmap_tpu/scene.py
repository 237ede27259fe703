"""Scene construction: two-level sparse voxel grid with an HBM-resident pool.

Reference model (``/root/reference/src/Scene.{h,cpp}``): a host-side
``supergrid`` of 32x32x4 superchunks, each holding a growable list of 64-byte
bricks plus a 16^3 table of packed index words; the GPU sees a table of device
pointers per superchunk (``Scene.h:9-17``).

Redesign (SURVEY.md §7): **flat arrays, no pointer chasing**.

* ``index_volume``  — uint32 ``[cells_z, cells_y, cells_x]`` dense brick-grid of
  packed index words (bit layout identical to the reference, variables.h:29-33).
* ``pool_words``    — uint32 ``[pool_capacity, 16]`` single linear brick pool in
  HBM; a brick's global pool slot is ``pool_base[superchunk] + (word & 0xFFF)``.
* ``pool_base``     — int32 ``[num_superchunks]`` segment base offsets, replacing
  the reference's per-superchunk device pointers.

Worldgen: the reference fills per-voxel occupancy with a triple loop over every
voxel (Scene.cpp:78-108).  Terrain is a heightfield, so per-column occupancy is
fully described by a *count* (number of solid voxels from the brick floor):
``count = clamp(ceil(h) - brick_z0, 0, 8)``.  Bricks, LoD bytes and emptiness
all derive from the 2-D count field with vectorized bit-plane packing — output
is bit-identical to the reference's loop for the same height function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from . import bits, noise
from .config import GridConfig

Array = Any

__all__ = ["VoxelScene", "generate_terrain_scene", "scene_from_dense",
           "save_scene", "load_scene", "scene_summary"]


@dataclass(frozen=True)
class VoxelScene:
    """Device-side scene: flat arrays only (a JAX pytree).

    ``occupancy`` / ``albedo`` are the optional differentiable fields (soft
    occupancy in [0,1] and RGB albedo per pool voxel); ``None`` for the classic
    binary renderer.
    """

    index_volume: Array       # uint32 [CZ, CY, CX]
    pool_words: Array         # uint32 [P, cell_members]
    pool_base: Array          # int32  [num_superchunks]
    occupancy: Array | None = None   # float32 [P, 8, 8, 8] (z, y, x) or None
    albedo: Array | None = None      # float32 [P, 8, 8, 8, 3] or None

    def tree_flatten(self):
        return (
            (self.index_volume, self.pool_words, self.pool_base,
             self.occupancy, self.albedo),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_bricks(self) -> int:
        return self.pool_words.shape[0]


def _register_pytree() -> None:
    import jax

    jax.tree_util.register_pytree_node(
        VoxelScene, VoxelScene.tree_flatten, VoxelScene.tree_unflatten
    )


_register_pytree()


# ---------------------------------------------------------------------------
# Worldgen
# ---------------------------------------------------------------------------

def _column_counts(heights: np.ndarray, brick_z0: int, brick_size: int) -> np.ndarray:
    """Solid-voxel count per column within one brick layer.

    Integer voxel z is solid iff ``z + brick_z0 < h`` (Scene.cpp:90), so the
    per-column count is ``clamp(ceil(h) - brick_z0, 0, brick_size)``.
    """
    return np.clip(
        np.ceil(heights).astype(np.int32) - brick_z0, 0, brick_size
    ).astype(np.int32)


def _pack_layer(counts: np.ndarray, grid: GridConfig):
    """Pack one brick layer from per-column counts.

    counts: int32 [grid_size(y), grid_size(x)] in [0, 8] for this layer.
    Returns (words [CY, CX, 16] uint32, lod [CY, CX] uint32, nonempty [CY, CX] bool).
    """
    b = grid.brick_size
    cy, cx = counts.shape[0] // b, counts.shape[1] // b
    # Layers wholly above or below the terrain surface are uniform.
    lo, hi = counts.min(), counts.max()
    if hi == 0 or lo >= b:
        full = lo >= b
        return (np.full((cy, cx, grid.cell_members),
                        0xFFFFFFFF if full else 0, np.uint32),
                np.full((cy, cx), 0xFF if full else 0, np.uint32),
                np.full((cy, cx), full))
    # [CY, y, CX, x] -> [CY, CX, y, x]
    c = counts.reshape(cy, b, cx, b).transpose(0, 2, 1, 3)

    # Occupancy bit-planes: voxel z solid iff z < count. Plane z is a [CY,CX,y,x]
    # bool; each 8x8 (y,x) plane is 64 bits = 2 uint32 words with bit x + 8*(y%4).
    words = np.zeros((cy, cx, grid.cell_members), np.uint32)
    xshift = np.arange(b, dtype=np.uint32)  # bit position of x within a row
    for z in range(b):
        plane = (c > z)  # [CY, CX, y, x]
        rowbits = (plane.astype(np.uint32) << xshift).sum(-1)  # [CY, CX, y]
        lo = (rowbits[..., 0] | (rowbits[..., 1] << 8)
              | (rowbits[..., 2] << 16) | (rowbits[..., 3] << 24))
        hi = (rowbits[..., 4] | (rowbits[..., 5] << 8)
              | (rowbits[..., 6] << 16) | (rowbits[..., 7] << 24))
        words[..., 2 * z] = lo
        words[..., 2 * z + 1] = hi

    # LoD byte: half-cell (hx, hy, hz) occupied iff any column of its 4x4 xy
    # block has count > hz*4; bit = hx + 2*hy + 4*hz (Scene.cpp:95).
    h = b // 2
    cmax = c.reshape(cy, cx, 2, h, 2, h).max(axis=(3, 5))  # [CY, CX, hy, hx]
    lod = np.zeros((cy, cx), np.uint32)
    for hz in range(2):
        occ = cmax > hz * h  # [CY, CX, hy, hx]
        for hy in range(2):
            for hx in range(2):
                bit = hx + 2 * hy + 4 * hz
                lod |= occ[..., hy, hx].astype(np.uint32) << np.uint32(bit)

    nonempty = c.any(axis=(2, 3))
    return words, lod, nonempty


def chebyshev_distance_field(nonempty: np.ndarray, cap: int = 511) -> np.ndarray:
    """L-inf distance to the nearest non-empty cell, clamped to ``cap``.

    Computed by iterated 3x3x3 dilation (separable max-filter per axis): a cell
    first covered at dilation k has distance k.  This is the empty-space-skip
    radius: all cells within L-inf distance (d-1) of an empty cell with
    distance d are guaranteed empty.
    """
    dist = np.full(nonempty.shape, cap, np.int32)
    dist[nonempty] = 0
    cover = nonempty.copy()
    for k in range(1, cap + 1):
        if cover.all():
            break
        prev = cover
        # separable 3-wide max filter (dilation) along each axis
        for ax in range(3):
            a = cover
            left = np.zeros_like(a)
            right = np.zeros_like(a)
            sl_l = [slice(None)] * 3
            sl_r = [slice(None)] * 3
            sl_l[ax] = slice(1, None)
            sl_r[ax] = slice(None, -1)
            left[tuple(sl_r)] = a[tuple(sl_l)]
            right[tuple(sl_l)] = a[tuple(sl_r)]
            cover = a | left | right
        newly = cover & ~prev
        dist[newly] = k
    return dist


def _assemble(grid: GridConfig, layer_words, layer_lod, layer_nonempty,
              residency: str):
    """Build index volume + linear pool from per-layer packed data.

    Slot assignment within a superchunk follows the reference's fill order:
    x fastest, then y, then z (Scene.cpp:78-104), so slot numbers are
    bit-comparable for the same world.
    """
    cz, cy, cx = grid.cells_height, grid.cells, grid.cells
    s = grid.supergrid_cell_size
    sx, sz = grid.supergrid_xy, grid.supergrid_z

    nonempty = np.stack(layer_nonempty)              # [CZ, CY, CX]
    lod = np.stack(layer_lod)                        # [CZ, CY, CX]

    # Superchunk id per brick and the reference's intra-superchunk fill order.
    bz, by, bx = np.meshgrid(np.arange(cz), np.arange(cy), np.arange(cx),
                             indexing="ij")
    sc_id = (bx // s) + (by // s) * sx + (bz // s) * sx * sx  # Scene.cpp:197
    # Order key: superchunk first, then (z, y, x) within it.
    local_rank = ((bz % s) * s + (by % s)) * s + (bx % s)
    order = np.argsort((sc_id * (s ** 3) + local_rank).ravel(), kind="stable")

    flat_nonempty = nonempty.ravel()[order]
    flat_sc = sc_id.ravel()[order]

    # Slot within superchunk = running count of non-empty bricks in fill order.
    csum = np.cumsum(flat_nonempty)
    seg_start_count = np.zeros(grid.num_superchunks, np.int64)
    first_idx = np.searchsorted(flat_sc, np.arange(grid.num_superchunks))
    seg_start_count = np.where(first_idx > 0, csum[first_idx - 1], 0)
    slot_sorted = (csum - 1) - seg_start_count[flat_sc]  # valid where nonempty

    slots = np.zeros(cz * cy * cx, np.int64)
    slots[order] = slot_sorted
    slots = slots.reshape(cz, cy, cx)

    per_sc_counts = np.bincount(flat_sc[flat_nonempty],
                                minlength=grid.num_superchunks)
    if per_sc_counts.max(initial=0) > 4096:
        raise ValueError("superchunk overflows the 12-bit slot space")
    pool_base = np.zeros(grid.num_superchunks, np.int32)
    pool_base[1:] = np.cumsum(per_sc_counts)[:-1].astype(np.int32)
    total = int(per_sc_counts.sum())

    # Gather brick words into the pool in global-slot order.
    pool = np.zeros((max(total, 1), grid.cell_members), np.uint32)
    global_slot = pool_base.astype(np.int64)[sc_id] + slots
    words = np.stack(layer_words)                     # [CZ, CY, CX, 16]
    mask = nonempty
    pool[global_slot[mask]] = words[mask]

    loaded = residency == "full"
    # Streaming init mirrors the reference (Scene.cpp:160): word = unloaded | lod,
    # slot assigned only once the brick becomes resident.
    packed_slots = slots.astype(np.uint32) if loaded else np.zeros_like(
        slots, dtype=np.uint32)
    # Empty cells carry the Chebyshev skip distance in bits 28:20 (an
    # extension; the reference leaves those bits zero and tests `if (index)`,
    # which our traversal refines to `flags != 0`).
    dist = chebyshev_distance_field(nonempty)
    index_volume = np.where(
        nonempty,
        bits.pack_index_word(
            packed_slots, lod,
            loaded=np.full(nonempty.shape, loaded),
            unloaded=np.full(nonempty.shape, not loaded),
            requested=np.zeros(nonempty.shape, bool),
        ),
        (dist.astype(np.uint32) << 20),
    ).astype(np.uint32)

    return index_volume, pool, pool_base


def generate_terrain_scene(grid: GridConfig, residency: str = "full",
                           octaves: int = 8,
                           feature_scale: float = 2048.0,
                           use_native: bool = True) -> VoxelScene:
    """Generate the simplex-fBm terrain world (Scene::generate semantics).

    residency="full": every non-empty brick resident with the loaded bit set —
    the north-star HBM-resident design.  residency="streaming": index words
    start ``unloaded | lod`` like the reference's GPU init (Scene.cpp:157-175);
    pair with :mod:`brickmap_tpu.stream`.

    use_native: evaluate the heightfield with the multithreaded C++ library
    (csrc/worldgen.cpp, the analog of the reference's thread fan-out,
    Scene.cpp:124-147); falls back to vectorized NumPy automatically.
    """
    g = grid.grid_size
    heights = None
    if use_native:
        from . import native

        heights = native.terrain_heights(g, grid.grid_height, octaves,
                                         feature_scale)
    if heights is None:
        xs = np.arange(g, dtype=np.float32)
        wy, wx = np.meshgrid(xs, xs, indexing="ij")  # heights[y, x]
        heights = np.asarray(
            noise.terrain_height(wx, wy, grid.grid_height, octaves=octaves,
                                 feature_scale=feature_scale)
        )

    layer_words, layer_lod, layer_nonempty = [], [], []
    for czi in range(grid.cells_height):
        counts = _column_counts(heights, czi * grid.brick_size, grid.brick_size)
        w, l, ne = _pack_layer(counts, grid)
        layer_words.append(w)
        layer_lod.append(l)
        layer_nonempty.append(ne)

    index_volume, pool, pool_base = _assemble(
        grid, layer_words, layer_lod, layer_nonempty, residency
    )
    return VoxelScene(index_volume=index_volume, pool_words=pool,
                      pool_base=pool_base)


def scene_from_dense(dense: np.ndarray, grid: GridConfig,
                     residency: str = "full") -> VoxelScene:
    """Build a scene from a dense bool occupancy volume [Z, Y, X] (tests, IO,
    voxelized meshes).  Shapes must match ``grid``."""
    gz, gy, gx = dense.shape
    assert gx == grid.grid_size and gy == grid.grid_size
    assert gz == grid.grid_height
    b = grid.brick_size

    layer_words, layer_lod, layer_nonempty = [], [], []
    for czi in range(grid.cells_height):
        sub = dense[czi * b:(czi + 1) * b]             # [8(z), Y, X]
        # [CY, CX, z, y, x]
        blk = sub.reshape(b, grid.cells, b, grid.cells, b).transpose(1, 3, 0, 2, 4)
        # Pack via bits helpers (z-major [z, y, x] per brick).
        words = bits.brick_words_from_dense(blk)
        lod = bits.lod_byte_from_dense(blk)
        layer_words.append(np.asarray(words, np.uint32))
        layer_lod.append(np.asarray(lod, np.uint32))
        layer_nonempty.append(np.asarray(blk.any(axis=(2, 3, 4))))

    index_volume, pool, pool_base = _assemble(
        grid, layer_words, layer_lod, layer_nonempty, residency
    )
    return VoxelScene(index_volume=index_volume, pool_words=pool,
                      pool_base=pool_base)


# ---------------------------------------------------------------------------
# Persistence (reference has none — world is regenerated per run; SURVEY.md §5)
# ---------------------------------------------------------------------------

def save_scene(path: str, scene: VoxelScene) -> None:
    arrays = {
        "index_volume": np.asarray(scene.index_volume),
        "pool_words": np.asarray(scene.pool_words),
        "pool_base": np.asarray(scene.pool_base),
    }
    if scene.occupancy is not None:
        arrays["occupancy"] = np.asarray(scene.occupancy)
    if scene.albedo is not None:
        arrays["albedo"] = np.asarray(scene.albedo)
    np.savez_compressed(path, **arrays)


def load_scene(path: str) -> VoxelScene:
    data = np.load(path)
    return VoxelScene(
        index_volume=data["index_volume"],
        pool_words=data["pool_words"],
        pool_base=data["pool_base"],
        occupancy=data["occupancy"] if "occupancy" in data else None,
        albedo=data["albedo"] if "albedo" in data else None,
    )


def scene_summary(scene: VoxelScene, grid: GridConfig) -> dict:
    """Residency statistics — the analog of Scene::dump (Scene.cpp:254-259)."""
    iv = np.asarray(scene.index_volume)
    nonempty = (iv & np.uint32(0xE000_0000)) != 0
    loaded = (iv & np.uint32(0x8000_0000)) != 0
    s = grid.supergrid_cell_size
    cz, cy, cx = iv.shape
    per_sc = loaded.reshape(
        cz // s, s, cy // s, s, cx // s, s
    ).sum(axis=(1, 3, 5))
    return {
        "num_bricks": int(scene.pool_words.shape[0]),
        "nonempty_bricks": int(nonempty.sum()),
        "loaded_bricks": int(loaded.sum()),
        "per_superchunk_loaded": per_sc,
        "pool_bytes": int(np.asarray(scene.pool_words).nbytes),
    }
