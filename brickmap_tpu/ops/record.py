"""Segment recorder (plain XLA): per-ray lists of occupied cells.

The differentiable compositor (:mod:`brickmap_tpu.diff.sparse`) needs each
ray's front-to-back sequence of bricks.  Recording it once and replaying
bounded-K segments keeps the backward pass free of while-loop residuals —
the "store hit segment list per ray, bounded K" design (SURVEY.md section 7,
milestone 4).

This is the reference implementation of the recorder: one lockstep
``lax.while_loop`` over the top-level brick grid of the flat
:class:`~brickmap_tpu.scene.VoxelScene`, with the traversal's empty-space
jumps (:func:`~brickmap_tpu.ops.traverse.top_step`).  Every occupied cell
crossed is appended and the ray continues until it leaves the world or has
K segments.  The GPU runs the same march as the record mode of
:mod:`brickmap_tpu.pallas.march`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import (
    BRICK_DIST_SHIFT,
    BRICK_FLAG_BITS,
    BRICK_INDEX_BITS,
    BRICK_LOADED_BIT,
    GridConfig,
)
from .traverse import BIG, _sel3, aabb_clip, top_step

__all__ = ["record_segments_xla", "record_budget"]


def record_budget(grid: GridConfig) -> int:
    """Top-level cells a straight line can cross in the brick grid: the
    recorder's iteration budget, which no ray can exhaust."""
    return 2 * grid.cells + grid.cells_height + 1


@partial(jax.jit, static_argnames=("grid", "k_segments", "use_ess"))
def record_segments_xla(origin, direction, index_volume, pool_base,
                        grid: GridConfig, k_segments: int = 16,
                        use_ess: bool = True):
    """Record each ray's first ``k_segments`` occupied cells, front to back.

    Returns dict(cells [N,K] i32 packed x|y<<10|z<<20 (-1 = unused),
    nd [N,K] f32 entry distance in cell units from the clipped origin,
    ncode [N,K] i32 entry-face axis (-1 = ray starts in the cell),
    slot [N,K] i32 global pool row (-1 = unused or not loaded),
    count [N] i32, tminn [N] f32, entry_normal [N,3], o_cells [N,3]
    (clipped origin in cell units), exhausted [N] bool).
    """
    n = origin.shape[0]
    k = k_segments
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    cx_max, cy_max, cz_max = grid.cells, grid.cells, grid.cells_height
    s = grid.supergrid_cell_size

    ok, tminn, clipped, entry_normal = aabb_clip(origin, direction, grid)
    o_cells = clipped / float(grid.brick_size)
    d = direction.astype(f32)
    sf = jnp.sign(d)
    rd = jnp.where(d == 0.0, 0.0, 1.0 / d)
    si = sf.astype(i32)
    td = sf * rd
    p0 = jnp.trunc(o_cells).astype(i32)
    cb = jnp.where(d > 0, p0.astype(f32) + 1.0, p0.astype(f32))
    t0 = jnp.where(d != 0.0, (cb - o_cells) * rd, f32(BIG))
    inside = jnp.all((p0 >= 0) & (p0 < jnp.asarray([cx_max, cy_max, cz_max])),
                     axis=1)
    iv_flat = index_volume.reshape(-1)
    rows = jnp.arange(n, dtype=i32)
    d3, si3, td3 = (tuple(a[:, i] for i in range(3)) for a in (d, si, td))

    state = dict(
        it=jnp.int32(0), active=ok & inside,
        px=p0[:, 0], py=p0[:, 1], pz=p0[:, 2],
        tx=t0[:, 0], ty=t0[:, 1], tz=t0[:, 2],
        axis0=jnp.full(n, -1, i32), count=jnp.zeros(n, i32),
        cells=jnp.full((n, k), -1, i32), nd=jnp.zeros((n, k), f32),
        ncode=jnp.full((n, k), -1, i32), slot=jnp.full((n, k), -1, i32))

    def cond(st):
        return (st["it"] < record_budget(grid)) & jnp.any(st["active"])

    def body(st):
        active = st["active"]
        px, py, pz = st["px"], st["py"], st["pz"]
        pcx = jnp.clip(px, 0, cx_max - 1)
        pcy = jnp.clip(py, 0, cy_max - 1)
        pcz = jnp.clip(pz, 0, cz_max - 1)
        word = jnp.take(iv_flat, (pcz * cy_max + pcy) * cx_max + pcx)
        occ = active & ((word & u32(BRICK_FLAG_BITS)) != 0)
        axis0 = st["axis0"]
        entered = axis0 >= 0
        nd_new = jnp.where(entered, _sel3(axis0, st["tx"], st["ty"], st["tz"])
                           - _sel3(axis0, *td3), 0.0)
        sc_id = jnp.clip(pcx // s + (pcy // s) * grid.supergrid_xy
                         + (pcz // s) * grid.supergrid_xy ** 2,
                         0, grid.num_superchunks - 1)
        loaded = (word & u32(BRICK_LOADED_BIT)) != 0
        gslot = jnp.take(pool_base, sc_id) \
            + (word & u32(BRICK_INDEX_BITS)).astype(i32)
        col = jnp.where(occ, st["count"], k)          # k = dropped

        def put(a, v):
            return a.at[rows, col].set(v, mode="drop")

        count = st["count"] + occ.astype(i32)
        step = active & (count < k)
        skip_r = jnp.maximum(
            ((word >> BRICK_DIST_SHIFT) & u32(0x1FF)).astype(i32) - 1, 0)
        use_skip = step & ~occ & (skip_r >= 1) if use_ess \
            else jnp.zeros(n, bool)
        pxn, pyn, pzn, txn, tyn, tzn, t_axis, exited = top_step(
            px, py, pz, st["tx"], st["ty"], st["tz"], d3, si3, td3, skip_r,
            use_skip, grid)
        return dict(
            it=st["it"] + 1, active=step & ~exited,
            px=jnp.where(step, pxn, px), py=jnp.where(step, pyn, py),
            pz=jnp.where(step, pzn, pz),
            tx=jnp.where(step, txn, st["tx"]),
            ty=jnp.where(step, tyn, st["ty"]),
            tz=jnp.where(step, tzn, st["tz"]),
            axis0=jnp.where(step, t_axis, axis0), count=count,
            cells=put(st["cells"], px | (py << 10) | (pz << 20)),
            nd=put(st["nd"], nd_new),
            ncode=put(st["ncode"], jnp.where(entered, axis0, -1)),
            slot=put(st["slot"], jnp.where(loaded, gslot, -1)))

    st = jax.lax.while_loop(cond, body, state)
    return dict(cells=st["cells"], nd=st["nd"], ncode=st["ncode"],
                slot=st["slot"], count=st["count"], tminn=tminn,
                entry_normal=entry_normal, o_cells=o_cells,
                exhausted=st["active"])
