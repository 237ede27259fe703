"""Scripted-viewpoint benchmark harness.

Reuses the reference's nine fixed camera positions and yaw/pitch angles
(``performance_measure.h:4-25``) over the same simplex-noise world for
like-for-like scene content (BASELINE.md measurement protocol), reporting
Mrays/s instead of the reference's avg/min/max ms (``performance_measure.cpp:
82-101`` — those stats are also recorded per viewpoint).

Viewpoint-pinning mirrors ``measure_convergence`` (performance_measure.cpp:
74-76); the reference has 9 positions but only 8 angle entries (its index 8
reads out of bounds), so angles wrap modulo 8 here.

Viewpoint geometry note: positions 4-8 lie OUTSIDE the world AABB even in
the reference (e.g. x=11298 vs grid_size 4096, z=5531 vs height 512) — the
scripted camera flies out and looks back, so most of those rays miss or
clip the world edge.  Scaling positions by world_size/4096 for smaller
worlds preserves that outside-looking-in geometry; it is the protocol, not
a bug (performance_measure.h:4-14).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BrickmapConfig
from ..ops import sunsky as ss
from ..render import pathtrace
from ..render.camera import Camera
from ..utils.metrics import FrameTimer

# performance_measure.h:4-14
TEST_POSITIONS = [
    (512.0, 512.0, 300.0),
    (840.254, 832.446, 1169.88),
    (2227.83, 774.886, 204.955),
    (3326.19, 2055.72, 44.7995),
    (7134.6, 1262.44, 5531.79),
    (11298.6, 3113.03, 598.019),
    (10921.4, 4774.14, 267.808),
    (9961.29, 4508.12, 189.59),
    (10835.3, 4160.83, 359.992),
]

# performance_measure.h:16-25 (8 entries; wraps for viewpoint 9)
TEST_ANGLES = [
    (-61863.5, -0.501796),
    (-61864.4, -0.429796),
    (-61863.9, 0.0622036),
    (-61864.2, -0.981796),
    (-61865.2, -0.501796),
    (-61866.3, -0.141796),
    (-61859.4, 0.0142036),
    (-61857.2, -0.261796),
]

SUN_POSITION = (0.05, 0.1)  # variables.cpp:3


def benchmark_cameras(scale: float = 1.0):
    """The nine scripted viewpoints as Camera objects (optionally scaled for
    smaller worlds)."""
    cams = []
    for i, pos in enumerate(TEST_POSITIONS):
        h, v = TEST_ANGLES[i % len(TEST_ANGLES)]
        cams.append(Camera.from_angles(
            tuple(p * scale for p in pos), h, v))
    return cams


def run_forward_benchmark(scene, cfg: BrickmapConfig, *, waves_per_view: int = 2,
                          warmup_waves: int = 1, scale: float = 1.0,
                          verbose: bool = True,
                          strict_exhausted: bool = True,
                          on_view=None) -> dict:
    """Path-trace each viewpoint for `waves_per_view` sample waves; return
    per-viewpoint and aggregate Mrays/s + frame-time stats.

    ``strict_exhausted`` (default): FAIL if any timed ray was truncated by a
    traversal budget — a benchmark that drops rays both biases the image and
    flatters the timing (every reference ray terminates with a defined
    result, voxel.cuh:135-261; the rescue pass in render.pathtrace is
    expected to keep this at zero).

    ``on_view``: optional callback invoked with the per-view result list
    after EACH completed viewpoint."""
    w, h = cfg.render.width, cfg.render.height
    sun_dir = ss.sun_direction_from_position(jnp.asarray(SUN_POSITION))
    results = []
    timer = FrameTimer()

    for vi, cam in enumerate(benchmark_cameras(scale)):
        arrays = pathtrace.camera_arrays_for(cam, sun_dir, w, h)
        cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
        key = jax.random.PRNGKey(vi)

        # Warm-up (compile once; shapes are identical across viewpoints).
        for i in range(warmup_waves):
            out = pathtrace.render_wave(jax.random.fold_in(key, 1000 + i),
                                        scene, arrays, cam_brick, cfg, w, h,
                                        retry_on_overflow=False)
            jax.block_until_ready(out)

        # All timed waves issue back-to-back with ONE sync at the end: a
        # per-wave sync would serialize the dispatch pipeline (the reference
        # likewise never reads frames back mid-measurement).
        # retry_on_overflow=False keeps the waves sync-free; exhausted rays
        # still FAIL the bench loudly below.
        timer.reset()
        reqs = []
        t0 = time.perf_counter()
        for i in range(waves_per_view):
            rgb, count, req = pathtrace.render_wave(
                jax.random.fold_in(key, i), scene, arrays, cam_brick, cfg,
                w, h, retry_on_overflow=False)
            reqs.append(req)
        rays_dev = sum(r["traced_rays"] for r in reqs)
        exh_dev = sum(r["exhausted_rays"] for r in reqs)
        jax.block_until_ready((rgb, count, reqs, rays_dev, exh_dev))
        dt = time.perf_counter() - t0
        total_rays = int(np.asarray(rays_dev))
        total_exhausted = int(np.asarray(exh_dev))
        timer.add(dt / waves_per_view)

        stats = timer.stats()
        mrays = total_rays / dt / 1e6
        results.append({
            "viewpoint": vi,
            "mrays_per_s": mrays,
            "rays": total_rays,
            "exhausted": total_exhausted,
            "seconds": dt,
            **stats,
        })
        if verbose:
            exh = (f"  EXHAUSTED {total_exhausted}"
                   if total_exhausted else "")
            print(f"view {vi}: {mrays:8.2f} Mrays/s  "
                  f"avg {stats['avg_ms']:.1f} ms  fps {stats['fps']:.2f}"
                  f"{exh}")
        if on_view is not None:
            on_view(results)

    agg_rays = sum(r["rays"] for r in results)
    agg_s = sum(r["seconds"] for r in results)
    total_exh = sum(r["exhausted"] for r in results)
    if strict_exhausted and total_exh:
        raise RuntimeError(
            f"benchmark invalid: {total_exh} rays exhausted their traversal "
            "budget (the rescue pass should have re-traced them; see "
            "render.pathtrace._maybe_rescue)")
    return {
        "per_view": results,
        "mrays_per_s": agg_rays / agg_s / 1e6,
        "total_rays": agg_rays,
        "total_exhausted": sum(r["exhausted"] for r in results),
        "total_seconds": agg_s,
        "resolution": [w, h],
        "bounces": cfg.render.max_bounces,
    }
