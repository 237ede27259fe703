"""8x8x8 brick DDA in plain XLA (BASELINE config 1).

The innermost traversal level (``intersect_brick``, voxel.cuh:79-133) for a
batch of rays against one brick: a fixed 22-step masked DDA (the 8^3 worst
case) over the brick's 16 occupancy words, which XLA fuses into one loop
kernel.  Semantics are :func:`brickmap_tpu.ops.dda_ref.intersect_brick`'s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .traverse import BIG, _sel3, _sel_axis

__all__ = ["trace_single_brick"]

MAX_STEPS = 22  # 3*8 - 2: worst-case voxel visits crossing an 8^3 brick


@jax.jit
def trace_single_brick(origins, directions, words):
    """DDA every ray against one brick.

    Args:
      origins, directions: float32 [N, 3]; origins in brick-local voxel
        coordinates (outside [0,8) only by the entry nudge).
      words: uint32 [16] occupancy words of the brick.

    Returns dict(hit bool [N], t f32 [N] local voxel units (0 for an
    entry-cell hit), axis i32 [N] step axis of the hit face (-1 = entry
    cell)); the normal is ``-sign(d[axis])``.
    """
    f32, i32 = jnp.float32, jnp.int32
    n = origins.shape[0]

    def setup(o, d):
        p = jnp.trunc(o).astype(i32)   # C trunc, matching dda_ref
        sf = jnp.sign(d)
        rd = jnp.where(d == 0.0, 0.0, 1.0 / d)
        cb = jnp.where(d > 0, p.astype(f32) + 1.0, p.astype(f32))
        t = jnp.where(d != 0.0, (cb - o) * rd, f32(BIG))
        out = jnp.where(d > 0, 8, -1)
        return jax.lax.rem(p, 8), sf.astype(i32), t, sf * rd, out

    (px, sx, tx, tdx, outx), (py, sy, ty, tdy, outy), \
        (pz, sz, tz, tdz, outz) = (setup(origins[:, k], directions[:, k])
                                   for k in range(3))

    def body(_, c):
        px, py, pz, tx, ty, tz, axis, active, hit, thit, haxis = c
        lin = px + py * 8 + pz * 64
        inb = (lin >= 0) & (lin < 512)
        word = jnp.take(words, jnp.where(inb, lin >> 5, 0))
        occ = inb & (((word >> (lin & 31).astype(jnp.uint32)) & 1) != 0)

        new_hit = active & occ
        entered = axis >= 0
        t_val = jnp.where(entered, _sel3(axis, tx, ty, tz)
                          - _sel3(axis, tdx, tdy, tdz), 0.0)
        thit = jnp.where(new_hit, t_val, thit)
        haxis = jnp.where(new_hit, axis, haxis)
        hit = hit | new_hit
        active = active & ~occ

        ax = _sel_axis(tx, ty, tz)
        pxn = px + jnp.where(ax == 0, sx, 0)
        pyn = py + jnp.where(ax == 1, sy, 0)
        pzn = pz + jnp.where(ax == 2, sz, 0)
        exited = _sel3(ax, pxn, pyn, pzn) == _sel3(ax, outx, outy, outz)
        px = jnp.where(active, pxn, px)
        py = jnp.where(active, pyn, py)
        pz = jnp.where(active, pzn, pz)
        tx = jnp.where(active & (ax == 0), tx + tdx, tx)
        ty = jnp.where(active & (ax == 1), ty + tdy, ty)
        tz = jnp.where(active & (ax == 2), tz + tdz, tz)
        axis = jnp.where(active, ax, axis)
        return (px, py, pz, tx, ty, tz, axis, active & ~exited, hit, thit,
                haxis)

    init = (px, py, pz, tx, ty, tz, jnp.full(n, -1, i32), jnp.ones(n, bool),
            jnp.zeros(n, bool), jnp.zeros(n, f32), jnp.full(n, -1, i32))
    out = jax.lax.fori_loop(0, MAX_STEPS, body, init)
    return {"hit": out[8], "t": out[9], "axis": out[10]}
