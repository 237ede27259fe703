"""Config 1 end-to-end: render a single 8x8x8 brick.

BASELINE.json config 1 ("single 8x8x8 brick, primary rays only, 256x256,
CPU-reference DDA"): camera rays are clipped to the brick's AABB, the XLA
brick DDA (:mod:`brickmap_tpu.ops.brick`) traverses, and shading is a
face-normal lambert against the sun; oracle-checked by tests/test_brick.py
and tests/test_single_brick.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import sunsky as sunsky_mod
from ..ops.brick import trace_single_brick
from .camera import Camera, primary_rays

__all__ = ["render_single_brick"]


def render_single_brick(words, camera: Camera, width: int, height: int,
                        sun_direction, key=None):
    """Primary-ray render of one brick occupying [0,8)^3 world units.

    Returns (rgb [H, W, 3] float32 in [0,1], hit mask [H, W]).
    """
    key = jax.random.PRNGKey(0) if key is None else key
    origins, dirs, _ = primary_rays(key, camera, width, height)

    # AABB clip to the brick (slab test; voxel.cuh:13-24 semantics).
    rd = jnp.where(dirs == 0.0, 0.0, 1.0 / dirs)
    t1 = (0.0 - origins) * rd
    t2 = (8.0 - origins) * rd
    lo = jnp.where(dirs == 0.0, -jnp.inf, jnp.minimum(t1, t2))
    hi = jnp.where(dirs == 0.0, jnp.inf, jnp.maximum(t1, t2))
    tenter = jnp.maximum(jnp.max(lo, axis=1), 0.0)
    texit = jnp.min(hi, axis=1)
    valid = texit > tenter
    clipped = origins + dirs * (tenter + 1e-3)[:, None]

    res = trace_single_brick(clipped, dirs, words)
    hit = res["hit"] & valid
    axis = res["axis"]

    # Face normal from the hit axis + direction sign (voxel.cuh:114-117).
    sign = jnp.take_along_axis(
        jnp.sign(dirs), jnp.maximum(axis, 0)[:, None], axis=1)[:, 0]
    normal = jnp.where(
        (axis[:, None] == jnp.arange(3)[None, :]) & (axis >= 0)[:, None],
        -sign[:, None], 0.0)

    sun = jnp.asarray(sun_direction, jnp.float32)
    lambert = jnp.clip(jnp.sum(normal * sun[None, :], axis=1), 0.0, 1.0)
    albedo = jnp.asarray([0.8, 0.6, 0.4], jnp.float32)
    lit = albedo[None, :] * (0.25 + 0.75 * lambert)[:, None]

    sky = sunsky_mod.sunsky(dirs, sun)
    rgb = jnp.where(hit[:, None], lit, jnp.clip(sky, 0.0, 1.0))
    return (rgb.reshape(height, width, 3),
            hit.reshape(height, width))
