"""Differentiable voxel rendering: transmittance compositing along DDA rays.

The reference has no backward pass of any kind; this is the new capability the
build adds (BASELINE.json config 5): pixel gradients w.r.t. per-voxel
``occupancy`` (soft opacity in [0,1]) and ``albedo`` (RGB).

Model: a ray visits voxels front-to-back in exact DDA order (same traversal
semantics as :mod:`brickmap_tpu.ops.traverse`, voxel.cuh:79-133, but over a
dense float grid).  Each visited voxel contributes

    w_i = T_{i-1} * occ_i,      T_i = T_{i-1} * (1 - occ_i)

and the pixel radiance is ``sum_i w_i * albedo_i * shade_i + T_N * sky``.
With binary occupancy this reduces exactly to the hard-surface renderer (the
first solid voxel takes all the weight), which is the parity limit tested
against the scalar oracle.

The visit sequence is computed in closed form (the 3-way merge of per-axis
arithmetic crossing-time progressions, ranked by floor-division counts — the
same vectorization as :mod:`brickmap_tpu.diff.sparse`), all voxel values come
from ONE flat gather, and compositing uses the analytic custom-VJP core — a
``lax.scan`` over steps would execute one whole-batch HBM round-trip per
step.  This dense-grid path is the small-scene reference; the production
differentiable renderer over the sparse brick pool is
:mod:`brickmap_tpu.diff.sparse` (Pallas segment recording + bounded-K
replay).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .sparse import _composite_core, _merge_offsets

__all__ = ["composite_rays", "render_image", "l2_loss_and_grads"]


def _dda_state(origin, direction):
    """Unit-voxel DDA setup (shared semantics with ops/traverse)."""
    pos = jnp.floor(origin).astype(jnp.int32)
    step = jnp.sign(direction)
    rdinv = jnp.where(direction == 0.0, 0.0, 1.0 / direction)
    cb = jnp.where(direction > 0, pos + 1.0, pos.astype(jnp.float32))
    tmax = jnp.where(direction != 0.0, (cb - origin) * rdinv, 1e6)
    tdelta = step * rdinv
    return pos, step.astype(jnp.int32), tmax, tdelta


def _sel_axis(tmax):
    tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
    return jnp.where(tx < ty, jnp.where(tx < tz, 0, 2),
                     jnp.where(ty < tz, 1, 2)).astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_steps",))
def composite_rays(origin, direction, occupancy, albedo, background,
                   max_steps: int = 192):
    """Alpha-composite rays through a dense voxel grid.

    Args:
      origin, direction: float32 [N, 3]; the grid occupies
        [0, X) x [0, Y) x [0, Z) with unit voxels; occupancy is [Z, Y, X],
        albedo [Z, Y, X, 3] (same z-major layout as the index volume).
      background: [N, 3] radiance composited behind the grid.
      max_steps: static DDA step budget.

    Returns (rgb [N, 3], transmittance [N], expected_depth [N]).
    """
    nz, ny, nx = occupancy.shape
    ext = jnp.asarray([nx, ny, nz], jnp.int32)
    n = origin.shape[0]

    # Clip to the grid AABB (enter at tmin like voxel.cuh:137-155, simplified:
    # no entry-face epsilon games needed — the compositor is robust to starting
    # slightly outside because out-of-bounds voxels contribute nothing).
    box_max = ext.astype(jnp.float32)
    rd = jnp.where(direction == 0, 0.0, 1.0 / direction)
    t1 = (0.0 - origin) * rd
    t2 = (box_max - origin) * rd
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    lo = jnp.where(direction == 0.0, -jnp.inf, lo)
    hi = jnp.where(direction == 0.0, jnp.inf, hi)
    tenter = jnp.maximum(jnp.max(lo, axis=1), 0.0)
    texit = jnp.min(hi, axis=1)
    inside_box = jnp.all((origin >= 0) & (origin < box_max), axis=1)
    valid = (texit > tenter) | inside_box

    start = origin + direction * jnp.where(inside_box, 0.0, tenter + 1e-4)[:, None]
    pos, stepv, tmax, tdelta = _dda_state(start, direction)
    tdabs = jnp.abs(tdelta)

    # Closed-form rank merge of the per-axis crossing-time progressions
    # (shared with diff.sparse; binary-search form keeps memory at
    # [C, V] instead of a [C, V-1, V] comparison tensor).
    offs = _merge_offsets(tmax, tdabs, direction != 0.0,
                          max_steps - 1, max_steps)      # [C, V, 3]
    pk = pos[:, None, :] + stepv[:, None, :] * offs
    inb = jnp.all((pk >= 0) & (pk < ext[None, None, :]), axis=2) \
        & valid[:, None]
    pc = jnp.clip(pk, 0, ext[None, None, :] - 1)
    flat = (pc[..., 2] * ny + pc[..., 1]) * nx + pc[..., 0]

    occ_v = jnp.take(occupancy.reshape(-1), flat)        # [C, V]
    occ_v = jnp.where(inb, jnp.clip(occ_v, 0.0, 1.0), 0.0)
    alb_v = jnp.take(albedo.reshape(-1, 3), flat, axis=0)
    rgb, trans = _composite_core(occ_v, alb_v, background)

    # Expected depth: per-step [t_entry, t_exit] from the crossing counts
    # (next crossing per axis = tmax_a + cnt_a * tdelta_a).  Weights come
    # from a plain cumprod — depth is a forward-only diagnostic output.
    t_next = jnp.min(jnp.where(
        (direction != 0.0)[:, None, :],
        tmax[:, None, :] + offs.astype(jnp.float32) * tdabs[:, None, :],
        jnp.float32(1e6)), axis=2)                       # t_exit_k  [C, V]
    t_entry = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.float32), t_next[:, :-1]], axis=1)
    cp = jnp.cumprod(1.0 - occ_v, axis=1)
    t_excl = jnp.concatenate([jnp.ones((n, 1), jnp.float32), cp[:, :-1]],
                             axis=1)
    depth = jnp.sum(occ_v * t_excl * 0.5 * (t_entry + t_next), axis=1)
    # Depth accumulated in start-local t; shift by the clip distance weighted
    # by total opacity (sum of weights = 1 - trans).
    depth = depth + (1.0 - trans) * jnp.where(inside_box, 0.0, tenter)
    return rgb, trans, depth


def render_image(camera_origin, camera_rays, occupancy, albedo, background,
                 max_steps: int = 192):
    """Convenience wrapper: [H*W] rays -> rgb image terms."""
    return composite_rays(camera_origin, camera_rays, occupancy, albedo,
                          background, max_steps=max_steps)


@partial(jax.jit, static_argnames=("max_steps", "rays_per_chunk"))
def l2_loss_and_grads(origin, direction, occupancy, albedo, background,
                      target, max_steps: int = 192,
                      rays_per_chunk: int = 32768):
    """L2 image loss and gradients w.r.t. (occupancy, albedo).

    Rays are processed in chunks via ``lax.map`` so the backward pass stores
    scan residuals for one chunk at a time (a full 1080p frame at 192 steps
    would need tens of GB of residuals otherwise); gradients accumulate across
    chunks inside the map.
    """
    n = origin.shape[0]

    def loss_fn(occ, alb):
        if n <= rays_per_chunk:
            rgb, _, _ = composite_rays(origin, direction, occ, alb,
                                       background, max_steps=max_steps)
            return jnp.mean((rgb - target) ** 2)
        pad = (-n) % rays_per_chunk
        o = jnp.concatenate([origin, jnp.zeros((pad, 3), origin.dtype)])
        d = jnp.concatenate([direction, jnp.ones((pad, 3), direction.dtype)])
        bg = jnp.concatenate([background, jnp.zeros((pad, 3), jnp.float32)])
        tg = jnp.concatenate([target, jnp.zeros((pad, 3), jnp.float32)])
        w = jnp.concatenate([jnp.ones((n,), jnp.float32),
                             jnp.zeros((pad,), jnp.float32)])
        c = o.shape[0] // rays_per_chunk

        # remat: without it, map-as-scan stacks every chunk's scan residuals
        # (C x steps x chunk x ...) and a 1080p frame needs tens of GB; with
        # it, each chunk's forward is recomputed during its own backward.
        @jax.checkpoint
        def one(args):
            oc, dc, bgc, tgc, wc = args
            rgb, _, _ = composite_rays(oc, dc, occ, alb, bgc,
                                       max_steps=max_steps)
            return jnp.sum(wc[:, None] * (rgb - tgc) ** 2)

        sq = jax.lax.map(one, tuple(
            a.reshape(c, rays_per_chunk, *a.shape[1:])
            for a in (o, d, bg, tg, w)))
        return jnp.sum(sq) / (n * 3)

    loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(occupancy, albedo)
    return loss, grads
