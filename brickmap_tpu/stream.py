"""Brick residency streaming: the C5-C8 pipeline.

Reference pipeline (SURVEY.md §2 C5-C8): traversal atomically marks unloaded
bricks requested and appends coords to a device queue (voxel.cuh:228-245); the
CPU drains the queue, stages 64 B payloads + new index words into pinned
buffers (Scene.cpp:200-252), grows per-superchunk GPU pools by powers of two,
and a scatter kernel installs them next frame (kernel.cu:141-151).

Redesign: no atomics, no pinned staging, no device pointers.

* Traversal returns per-ray ``(request, request_pos)`` — the queue is an
  output, not a side effect.
* The manager dedupes host-side (the role of the ``requested`` bit +
  atomicOr), caps per step at ``queue_size`` (brick_load_queue_size = 1024,
  variables.h:35; overflow dropped and retried by later waves, same policy as
  voxel.cuh:237-240).
* Residency updates are **O(requests) device scatters** (fixed queue-size
  shapes, so the scatter executables compile once): index words and pool
  rows (kernel.cu:141-151's role).  Host arrays remain the truth only as the
  payload source (the CPU supergrid, Scene.h:19-29).
* Pool growth doubles segment capacity (Scene.cpp:235-250) and re-bases one
  global linear pool; the re-upload happens only on the log-many doublings.
"""

from __future__ import annotations


import numpy as np

from . import bits, scene as scene_mod
from .config import GridConfig

__all__ = ["StreamingScene", "pull_requests"]


_compact_req_jit = None


def compact_requests(mask, pos, cap: int):
    """Device-compact a wave's streaming requests to <= ``cap`` rows.

    The request mask/pos are ray-resolution arrays (a 1080p wave's pos is
    ~24 MB); one gather program shrinks the host pull to ``cap`` rows
    (~KB).  Requests beyond cap are dropped this
    wave and re-requested by later waves — the reference's queue-overflow
    policy (voxel.cuh:237-240) at device granularity; ``cap`` should give
    dedupe headroom over ``queue_size`` (duplicate brick coords from many
    lanes collapse on the host).
    """
    global _compact_req_jit
    if _compact_req_jit is None:
        from functools import partial

        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("cap",))
        def body(mask, pos, cap):
            idx = jnp.nonzero(mask, size=cap, fill_value=0)[0]
            total = jnp.sum(mask.astype(jnp.int32))
            rows = jnp.take(pos, idx, axis=0)
            valid = jnp.arange(cap, dtype=jnp.int32) \
                < jnp.minimum(total, cap)
            return total, rows, valid

        _compact_req_jit = body
    return _compact_req_jit(mask, pos, cap)


def pull_requests(req, queue_size: int = 1024) -> list:
    """Compacted (x, y, z) request tuples from a wave's ``req`` dict.

    Replaces the ``np.asarray(req["pos"])[np.asarray(req["mask"])]``
    full-array pull at every streaming call site (bench/CLI/chunked wave).
    """
    total, rows, valid = compact_requests(req["mask"], req["pos"],
                                          4 * queue_size)
    rows = np.asarray(rows)[np.asarray(valid)]
    return [tuple(int(v) for v in r) for r in rows]


_scatter_rows_jit = None


def _scatter_rows(arr, idx, rows):
    """Jitted device scatter: arr[idx] = rows (fixed shapes, compiled once).

    Padded entries repeat a real index with its current row value, making the
    scatter idempotent without shape-varying programs.  The jitted callee is
    module-global: a per-call local ``@jax.jit`` would re-trace every call.
    """
    global _scatter_rows_jit
    if _scatter_rows_jit is None:
        import jax

        _scatter_rows_jit = jax.jit(lambda a, i, r: a.at[i].set(r))
    return _scatter_rows_jit(arr, idx, rows)


class StreamingScene:
    """Host-side residency manager around persistent device arrays.

    ``truth`` is a fully-built host scene (every brick's payload + slot known,
    the analog of the CPU-side supergrid, Scene.h:19-29); the managed device
    scene starts with every brick ``unloaded | lod`` and no payloads
    (Scene.cpp:157-175).
    """

    def __init__(self, truth: scene_mod.VoxelScene, grid: GridConfig,
                 queue_size: int = 1024, starting_capacity: int = 16):
        import jax.numpy as jnp

        self.grid = grid
        self.queue_size = queue_size
        self.truth = truth
        iv_truth = np.asarray(truth.index_volume)
        self._truth_pool = np.asarray(truth.pool_words)
        self._truth_base = np.asarray(truth.pool_base)

        nonempty = (iv_truth & np.uint32(0xE000_0000)) != 0
        # Device init: unloaded | lod for non-empty, dist bits for empty.
        lod = bits.index_lod_byte(iv_truth).astype(np.uint32)
        self._iv = np.where(
            nonempty,
            np.uint32(0x4000_0000) | (lod << 12),
            iv_truth & np.uint32(0x1FF0_0000),
        ).astype(np.uint32)

        s = grid.num_superchunks
        self.capacity = np.full(s, starting_capacity, np.int64)
        self.highest = np.zeros(s, np.int64)     # gpu_index_highest
        self._pool = np.zeros((self._padded_total(), grid.cell_members),
                              np.uint32)
        self._rebase()
        self.total_uploaded = 0
        self.total_dropped = 0
        self._jnp = jnp

        # Persistent device arrays (scattered into, never re-uploaded except
        # on pool growth).
        self._dev_iv = jnp.asarray(self._iv)
        self._dev_pool = jnp.asarray(self._pool)
        self._dev_base = jnp.asarray(self.pool_base)

    # -- bookkeeping --------------------------------------------------------

    def _padded_total(self) -> int:
        """Global pool rows padded to a power of two: the device array's shape
        changes only on the log-many global doublings, so downstream programs
        recompile rarely (the reference reallocs without recompiling; XLA
        recompiles per shape)."""
        total = int(self.capacity.sum())
        return int(2 ** np.ceil(np.log2(max(total, 16))))

    def _rebase(self) -> None:
        self.pool_base = np.zeros(self.grid.num_superchunks, np.int32)
        self.pool_base[1:] = np.cumsum(self.capacity)[:-1].astype(np.int32)

    def device_scene(self) -> scene_mod.VoxelScene:
        """Current device-resident scene (persistent arrays; O(requests)
        scatters keep them current — no per-wave re-upload)."""
        return scene_mod.VoxelScene(
            index_volume=self._dev_iv,
            pool_words=self._dev_pool,
            pool_base=self._dev_base,
        )

    def _sc_id(self, x, y, z):
        s = self.grid.supergrid_cell_size
        return (x // s + (y // s) * self.grid.supergrid_xy
                + (z // s) * self.grid.supergrid_xy ** 2)

    # -- the per-frame CPU half (Scene::process_load_queue) -----------------

    def process_requests(self, requests) -> int:
        """Service up to ``queue_size`` brick requests; returns uploads done.

        ``requests``: iterable of brick-grid (x, y, z) coords (from traversal
        output).  Duplicates and already-resident bricks are ignored; overflow
        beyond the queue cap is dropped (retried by later waves, the
        reference's voxel.cuh:237-240 policy).
        """
        fresh = []
        seen = set()
        for xyz in requests:
            xyz = tuple(int(v) for v in xyz)
            if xyz in seen:
                continue
            seen.add(xyz)
            x, y, z = xyz
            word = self._iv[z, y, x]
            if not (word & np.uint32(0x4000_0000)):
                continue  # already loaded (or empty)
            if len(fresh) >= self.queue_size:
                self.total_dropped += 1
                continue
            fresh.append(xyz)
        if not fresh:
            return 0

        # Slot assignment + pow-2 segment growth (Scene.cpp:222-250).
        needed = self.highest.copy()
        for x, y, z in fresh:
            needed[self._sc_id(x, y, z)] += 1
        grew = False
        for sc in np.nonzero(needed > self.capacity)[0]:
            self.capacity[sc] = int(2 ** np.ceil(np.log2(needed[sc])))
            grew = True
        if grew:
            old_pool, old_base = self._pool, self.pool_base.copy()
            self._rebase()
            new_pool = np.zeros((self._padded_total(),
                                 self.grid.cell_members), np.uint32)
            for sc in range(self.grid.num_superchunks):
                h = int(self.highest[sc])
                if h:
                    new_pool[self.pool_base[sc]:self.pool_base[sc] + h] = \
                        old_pool[old_base[sc]:old_base[sc] + h]
            self._pool = new_pool

        # Host bookkeeping for the batch.
        n = len(fresh)
        coords = np.asarray(fresh, np.int64)          # [n, 3] (x, y, z)
        scs = self._sc_id(coords[:, 0], coords[:, 1], coords[:, 2])
        slots = np.empty(n, np.int64)
        for i, sc in enumerate(scs):
            slots[i] = self.highest[sc]
            self.highest[sc] += 1
        gslots = self.pool_base[scs] + slots
        twords = np.asarray(self.truth.index_volume)[
            coords[:, 2], coords[:, 1], coords[:, 0]]
        tslots = self._truth_base[scs] + (twords & np.uint32(0xFFF))
        payloads = self._truth_pool[tslots]           # [n, 16]
        lods = (twords >> 12) & np.uint32(0xFF)
        new_words = (np.uint32(0x8000_0000) | (lods << 12)
                     | slots.astype(np.uint32))

        self._iv[coords[:, 2], coords[:, 1], coords[:, 0]] = new_words
        self._pool[gslots] = payloads

        # ---- device scatters, O(requests) (kernel.cu:141-151's role) ------
        jnp = self._jnp
        q = self.queue_size

        def pad_idx(a):
            return jnp.asarray(np.concatenate(
                [a, np.repeat(a[-1:], q - n, 0)]).astype(np.int32))

        def pad_rows(a):
            return jnp.asarray(np.concatenate(
                [a, np.repeat(a[-1:], q - n, 0)]))

        # Index words: flat scatter into [CZ*CY*CX].
        cz, cy, cx = self._iv.shape
        flat_idx = (coords[:, 2] * cy + coords[:, 1]) * cx + coords[:, 0]
        self._dev_iv = _scatter_rows(
            self._dev_iv.reshape(-1), pad_idx(flat_idx),
            pad_rows(new_words)).reshape(cz, cy, cx)

        # Pool payload rows.
        self._dev_pool = _scatter_rows(self._dev_pool, pad_idx(gslots),
                                       pad_rows(payloads))

        if grew:
            # Rare (log-many) full re-upload after segment re-basing.
            self._dev_pool = jnp.asarray(self._pool)
            self._dev_base = jnp.asarray(self.pool_base)

        self.total_uploaded += n
        return n

    # -- diagnostics --------------------------------------------------------

    def dump(self):
        """Per-superchunk resident-brick counts (Scene::dump, Scene.cpp:254)."""
        return self.highest.copy()

    def fully_resident(self) -> bool:
        return not ((self._iv & np.uint32(0x4000_0000)) != 0).any()

    def surface_stats(self) -> dict:
        """Residency vs the surface/reachable brick sets.

        The reference's defining streaming property: "only bricks that lay
        on the surface of a superchunk will be loaded since rays won't
        penetrate into the inside" (README.md:7).  Two tiers:

        * ``surface``: any 6-neighbor cell is EMPTY (air-exposed faces).
        * ``reachable``: any 6-neighbor cell is empty OR partially filled —
          a ray can pass through a partial neighbor's gaps and strike this
          brick at fine LoD, so these loads are legitimate even without an
          air face.  A loaded brick with six completely-solid neighbors is
          unreachable: ``loaded_unreachable`` must stay 0.
        """
        iv = np.asarray(self.truth.index_volume)
        nonempty = (iv & np.uint32(0xE000_0000)) != 0
        # Full bricks: all 512 occupancy bits set in the truth payload.
        full = np.zeros_like(nonempty)
        zz, yy, xx = np.nonzero(nonempty)
        scs = self._sc_id(xx, yy, zz)
        rows = self._truth_base[scs] + (iv[zz, yy, xx]
                                        & np.uint32(0xFFF)).astype(np.int64)
        words = self._truth_pool[rows]
        full[zz, yy, xx] = (words == np.uint32(0xFFFFFFFF)).all(axis=1)

        def any_neighbor(pred):
            out = np.zeros_like(nonempty)
            for axis in range(3):
                for side in (-1, 1):
                    nb = np.ones_like(pred)   # out-of-world counts as true
                    src = [slice(None)] * 3
                    dst = [slice(None)] * 3
                    src[axis] = slice(1, None) if side > 0 \
                        else slice(None, -1)
                    dst[axis] = slice(None, -1) if side > 0 \
                        else slice(1, None)
                    nb[tuple(dst)] = pred[tuple(src)]
                    out |= nb
            return out

        surface = nonempty & any_neighbor(~nonempty)
        reachable = nonempty & any_neighbor(~full)
        loaded = (self._iv & np.uint32(0x8000_0000)) != 0
        return {
            "loaded_total": int(loaded.sum()),
            "loaded_surface": int((loaded & surface).sum()),
            "loaded_reachable": int((loaded & reachable).sum()),
            "loaded_unreachable": int((loaded & ~reachable).sum()),
            "surface_total": int(surface.sum()),
            "reachable_total": int(reachable.sum()),
            "nonempty_total": int(nonempty.sum()),
        }
