"""Bounce-iterated wavefront path tracer.

The reference implements one *frame* as five persistent-thread kernels over a
2M-ray pool that mixes bounce generations, with atomic counters and queues
(``kernel.cu:154-346``, SURVEY.md §3.4).  XLA has no dynamic queues, and the
estimator does not need them: this renderer iterates bounces to completion for a
full sample wave (one sample per pixel) with masked lanes — the same Monte
Carlo estimator, restructured for fixed shapes:

  primary_rays  ->  per bounce: [extend -> shade -> NEE shadow connect]

Per bounce there is ONE combined traversal call for extension rays and the
previous bounce's shadow rays (the reference's ``extend`` + ``connect`` in a
single lockstep while_loop — fewer total iterations than two calls).

Shading model = the reference's: pure diffuse albedo 1, sun NEE with cone
sampling + 1e-5 radiance scale (kernel.cu:274-279), cosine-weighted bounce
(kernel.cu:287-296), miss radiance ``sunsky`` at bounce 0 else ``sky``
(kernel.cu:316-323), termination after ``max_bounces`` diffuse bounces.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BrickmapConfig
from ..ops import sunsky as sunsky_mod
from ..ops.traverse import trace_rays
from ..pallas.march import trace_rays_kernel
from .camera import Camera, primary_rays
from .sampling import cone_sample, cosine_hemisphere

__all__ = ["render_wave", "Film", "film_init", "film_add", "tonemap"]


def film_init(width: int, height: int):
    """Progressive accumulation buffer: rgb sums + sample count per pixel
    (the reference's RGBA32F blit buffer, state.h:22, kernel.cu:348-364)."""
    return {
        "rgb": jnp.zeros((height * width, 3), jnp.float32),
        "count": jnp.zeros((height * width,), jnp.float32),
    }


def film_add(film, rgb, count):
    return {"rgb": film["rgb"] + rgb, "count": film["count"] + count}


def tonemap(film, width: int, height: int):
    """count-normalize + gamma 1/2.2 (blit_onto_framebuffer, kernel.cu:357-362)."""
    c = jnp.maximum(film["count"][:, None], 1e-8)
    img = jnp.clip(film["rgb"] / c, 0.0, None) ** (1.0 / 2.2)
    return jnp.clip(img, 0.0, 1.0).reshape(height, width, 3)


def _compact_trace(o_all, d_all, live, scene, cam_brick, cfg: BrickmapConfig,
                   bucket: int):
    """Trace only the live lanes, packed into a ``bucket``-lane buffer.

    Scattered live lanes (a few % after bounce 1) otherwise keep every ray
    tile alive and pay the full lockstep traversal cost — measured 10-20x
    slower than tracing the same rays densely packed.  The pack index is a
    cumsum (no sort); results scatter back to full shape with dead-lane
    defaults.  ``bucket`` is static, chosen per wave by the host from the
    live count (a handful of executables, compiled once each).
    """
    m = o_all.shape[0]
    pos = jnp.cumsum(live.astype(jnp.int32)) - 1
    src = jnp.full((bucket,), -1, jnp.int32)
    src = src.at[jnp.where(live, pos, bucket)].set(
        jnp.arange(m, dtype=jnp.int32), mode="drop")
    valid = src >= 0
    safe = jnp.maximum(src, 0)
    # Tail lanes (bucket > live count) get clip-failing rays (cost ~nothing).
    oc = jnp.where(valid[:, None], jnp.take(o_all, safe, axis=0), -10.0)
    dc = jnp.where(valid[:, None], jnp.take(d_all, safe, axis=0), -1.0)

    # Packing alone brings distant pixels into the same ray block.  Sort the
    # packed lanes by (origin superchunk, direction octant) so that a
    # kernel block's rays, and a warp's, walk the same cells and finish
    # together.
    s16 = float(cfg.grid.brick_size * cfg.grid.supergrid_cell_size)
    q = jnp.clip((oc / s16).astype(jnp.int32), 0,
                 max(cfg.grid.supergrid_xy, cfg.grid.supergrid_z) - 1)
    sc_id = (q[:, 0] + q[:, 1] * cfg.grid.supergrid_xy
             + q[:, 2] * cfg.grid.supergrid_xy ** 2)
    octant = ((dc[:, 0] > 0).astype(jnp.int32)
              + 2 * (dc[:, 1] > 0).astype(jnp.int32)
              + 4 * (dc[:, 2] > 0).astype(jnp.int32))
    key = jnp.where(valid, sc_id * 8 + octant, jnp.int32(2 ** 30))
    order = jnp.argsort(key)
    res_c = _trace(jnp.take(oc, order, axis=0), jnp.take(dc, order, axis=0),
                   scene, cam_brick, cfg)

    src_sorted = jnp.take(src, order, axis=0)
    back_idx = jnp.where(jnp.take(valid, order, axis=0), src_sorted, m)

    def back(x, default, dtype=None):
        full = jnp.full((m, *x.shape[1:]), default, dtype or x.dtype)
        return full.at[back_idx].set(x, mode="drop")

    return {
        "hit": back(res_c["hit"], False),
        "t": back(res_c["t"], 0.0),
        "normal": back(res_c["normal"], 0.0),
        "request": back(res_c["request"], False),
        "request_pos": back(res_c["request_pos"], 0),
        "exhausted": back(res_c["exhausted"], False),
        "resume_t": back(res_c["resume_t"], 0.0),
    }


def _pick_bucket(count: int, m: int) -> int | None:
    """Smallest compaction bucket holding ``count`` live lanes (buckets are
    static so only a few executables ever compile).  ``m`` itself is a valid
    bucket: no lanes are dropped, but the coherence sort still applies —
    measured faster than tracing a mostly-live incoherent wave unsorted."""
    for frac in (16, 4, 2, 1):
        b = max(-(-m // frac) // 1024 * 1024, 4096)
        if count <= b and b <= m:
            return b
    return m


def _ladder_buckets(m: int) -> list[int]:
    """The static bucket ladder (same tiers as :func:`_pick_bucket`),
    deduplicated ascending — the in-program bucket select switches over
    these."""
    out = []
    for frac in (16, 4, 2, 1):
        b = min(max(-(-m // frac) // 1024 * 1024, 4096), m)
        if b not in out:
            out.append(b)
    return sorted(out)


@jax.jit
def _live_count_dev(a, b):
    return jnp.sum(a.astype(jnp.int32)) + jnp.sum(b.astype(jnp.int32))


def _live_count(st):
    return int(_live_count_dev(st["active"], st["sh_active"]))


def trace_budget(cfg: BrickmapConfig) -> int:
    """Loop iterations one traversal call may take per ray.

    The budget is shared across DDA levels: a grazing ray can descend into
    many bricks (~22 iterations each), so it is sized from traversal
    geometry, not bounce count."""
    r = cfg.render
    return r.max_top_steps + 32 * (r.max_brick_steps + r.max_byte_steps)


def _trace(origins, dirs, scene, cam_brick, cfg: BrickmapConfig):
    """Trace a ray batch through the flat scene.

    ``traversal="auto"`` picks the implementation from the platform the
    program is compiled for: the Triton march kernel on a GPU, the XLA
    reference :func:`trace_rays` on the CPU.  ``"xla"`` forces the XLA
    traversal on any platform (the comparison that keeps the kernel
    honest)."""
    r = cfg.render
    args = (origins, dirs, scene.index_volume, scene.pool_words,
            scene.pool_base, cam_brick)
    xla = partial(trace_rays, grid=cfg.grid, max_iters=trace_budget(cfg))
    if r.traversal == "xla":
        return xla(*args)
    kernel = partial(trace_rays_kernel, grid=cfg.grid,
                     max_iters=trace_budget(cfg))
    return jax.lax.platform_dependent(*args, cpu=xla, cuda=kernel)


def wave_for_indices(key, idx, scene, camera_arrays, cam_brick,
                     cfg: BrickmapConfig, width: int, height: int):
    """Trace one sample wave for an explicit pixel-index array ``idx`` [M].

    The shard body for multi-chip rendering (each device passes its own
    pixel-index slice, see brickmap_tpu.parallel) and the core of
    :func:`render_wave`.  Returns (rgb [M,3], count [M], requests) in ``idx``
    order.
    """
    k_pix, k_loop = jax.random.split(key)
    st = _primary_state(k_pix, camera_arrays, cfg, width, height,
                        pixel_order=idx)
    for bounce in range(cfg.render.max_bounces + 1):
        k_loop, k_b = jax.random.split(k_loop)
        st = _bounce_step(jnp.int32(bounce), k_b, st, scene, cam_brick,
                          camera_arrays["sun_direction"], cfg)
    return _final_shadow(st, scene, cam_brick, cfg)


def _rescue_cfg(cfg: BrickmapConfig) -> BrickmapConfig:
    """Escalated traversal budget for re-tracing budget-exhausted lanes.

    The reference contract is that every ray terminates with a defined
    result (voxel.cuh:135-261).  A straight line crosses at most
    ``2 * cells + cells_height`` top-level cells, and each costs at most
    one test plus one brick DDA of ``3 * brick_size - 2`` steps, so this
    budget is one no ray can exhaust.  The loops exit as soon as every lane
    resolves, so the big budget costs only what it uses.
    """
    import dataclasses

    g, r = cfg.grid, cfg.render
    bound = (2 * g.cells + g.cells_height) * (3 * g.brick_size - 1)
    return dataclasses.replace(
        cfg, render=dataclasses.replace(
            r, max_top_steps=max(r.max_top_steps, bound)))


def _rescue_bucket(m: int) -> int:
    """Static in-program rescue capacity: m/16 lanes, so that the rescue's
    dead-lane overhead stays near 1/16 of a full-width trace."""
    return max(4096, -(-m // 16) // 1024 * 1024)


def _bucketed_wave(key, st, scene, cam_brick, sun_dir, cfg: BrickmapConfig,
                   host_rescue: bool = False):
    """Shared bounce loop: trace -> exhausted-lane rescue -> shade per
    bounce, with compaction-bucket choice ON DEVICE (``lax.switch`` over the
    static ladder inside the trace program) so a wave runs with zero
    per-bounce host round-trips, like the reference's uninterrupted kernel
    sequence (kernel.cu:416-431).

    The in-program rescue (``lax.cond`` + static ``_rescue_bucket``)
    guarantees zero budget-truncated rays in the wave result (asserted by
    the benchmark harness), resuming exhausted lanes from their reported
    entry distance.  ``host_rescue=True`` is the retry mode for the (never
    yet observed) case of more exhausted lanes than the static bucket:
    host-pulled live counts size exact per-stage buckets instead."""
    n = st["origins"].shape[0]
    k_loop = key
    for bounce in range(cfg.render.max_bounces + 1):
        k_loop, k_b = jax.random.split(k_loop)
        if host_rescue:
            bucket = None if bounce == 0 \
                else _pick_bucket(_live_count(st), 2 * n)
            res = _trace_stage(st, scene, cam_brick, cfg, bucket)
            res = _maybe_rescue(res, st, scene, cam_brick, cfg, 2 * n,
                                final=False)
        elif bounce == 0:
            # Fully-live extension lanes + no shadow lanes yet: the fixed
            # m/2 compaction needs no count.
            res = _trace_stage(st, scene, cam_brick, cfg,
                               _ladder_buckets(2 * n)[-2]
                               if len(_ladder_buckets(2 * n)) > 1 else None)
        else:
            res = _trace_stage_ladder(st, scene, cam_brick, cfg)
        st = _shade_stage(jnp.int32(bounce), k_b, st, res, sun_dir, cfg)
    if host_rescue:
        fbucket = _pick_bucket(
            int(jnp.sum(st["sh_active"].astype(jnp.int32))), n)
        res = _final_trace_stage(st, scene, cam_brick, cfg, fbucket)
        res = _maybe_rescue(res, st, scene, cam_brick, cfg, n, final=True)
    else:
        res = _final_trace_stage_ladder(st, scene, cam_brick, cfg)
    return _final_accum_stage(st, res)


def _maybe_rescue(res, st, scene, cam_brick, cfg: BrickmapConfig, m: int,
                  final: bool):
    """Re-trace exhausted live lanes with the escalated budget (host-gated:
    one tiny scalar pull; the rescue executable compiles per bucket size)."""
    n_exh = int(np.asarray(res["exh_n"]))
    if not n_exh:
        return res
    bucket = _pick_bucket(n_exh, m)
    return _rescue_stage(res, st, scene, cam_brick, _rescue_cfg(cfg), bucket,
                         final)


@partial(jax.jit, static_argnames=("cfg", "width", "height"))
def _primary_state(key, camera_arrays, cfg: BrickmapConfig, width: int,
                   height: int, pixel_order=None):
    """Primary rays + initial wave state, one device program.

    ``pixel_order``: optional explicit pixel-index array (any subset/order of
    the frame — shard slices, tile permutations); defaults to row-major.
    """
    from .camera import primary_rays_from_arrays

    idx = jnp.arange(width * height, dtype=jnp.int32) if pixel_order is None \
        else pixel_order
    n = idx.shape[0]
    origins, dirs = primary_rays_from_arrays(key, camera_arrays, idx, width,
                                             height)
    return {
        "origins": origins, "dirs": dirs,
        "accum": jnp.zeros((n, 3), jnp.float32),
        "throughput": jnp.ones((n, 3), jnp.float32),
        "active": jnp.ones((n,), bool),
        # Bounce 0 has no shadow rays yet; start them outside the world AABB
        # pointing away so aabb_clip deactivates the lanes immediately (they
        # cost ~nothing to trace instead of crossing the whole grid).
        "sh_o": jnp.full((n, 3), -10.0, jnp.float32),
        "sh_d": jnp.full((n, 3), -1.0, jnp.float32),
        "sh_color": jnp.zeros((n, 3), jnp.float32),
        "sh_active": jnp.zeros((n,), bool),
        "req_mask": jnp.zeros((n,), bool),
        "req_pos": jnp.zeros((n, 3), jnp.int32),
        "traced": jnp.zeros((), jnp.int32),
        "exh_count": jnp.zeros((), jnp.int32),
    }


def _concat_rays(st):
    """Extension + shadow rays of the wave state as one 2n-lane batch."""
    o_all = jnp.concatenate([st["origins"], st["sh_o"]], axis=0)
    d_all = jnp.concatenate([st["dirs"], st["sh_d"]], axis=0)
    live = jnp.concatenate([st["active"], st["sh_active"]])
    return o_all, d_all, live


def _with_exh(res, live):
    """Restrict the exhausted flag to live lanes + attach its lane count
    (pulled by the host to gate the rescue pass)."""
    exh = res["exhausted"] & live
    return dict(res, exhausted=exh,
                exh_n=jnp.sum(exh.astype(jnp.int32)))


def _rescue_pass(res, o_all, d_all, scene, cam_brick, rcfg: BrickmapConfig,
                 bucket: int):
    """One conditional rescue pass over ``res``'s exhausted lanes (skipped
    entirely when nothing is exhausted — the common case costs one scalar
    compare, no host gate).

    Resume-from-t: the exhausted lane's marched prefix is known empty (the
    kernel reports the entry distance of the cell it stopped in), so the
    pass clips the ray forward to just before that point — the re-trace
    only pays for the unexplored suffix.  The 2-voxel backstep absorbs
    float noise in the re-entry position.  Because the resumed origin IS
    the lane's current position, ``_compact_trace``'s (superchunk, octant)
    sort regroups stragglers by where they actually are.

    The static ``_rescue_bucket`` can in principle overflow; un-packed
    lanes KEEP their exhausted flag (never silently become misses) so the
    caller's wave-level retry (``render_wave``) catches them."""
    exh = res["exhausted"]

    def do_rescue(_):
        off = jnp.where(exh, jnp.maximum(res["resume_t"] - 2.0, 0.0), 0.0)
        r2 = _compact_trace(o_all + d_all * off[:, None], d_all, exh, scene,
                            cam_brick, rcfg, bucket)
        pos = jnp.cumsum(exh.astype(jnp.int32)) - 1
        included = exh & (pos < bucket)
        t2 = jnp.where(r2["hit"], r2["t"] + off, 0.0)
        r2 = dict(r2, t=t2, resume_t=r2["resume_t"] + off)
        merged = {
            k: jnp.where(included if res[k].ndim == 1 else included[:, None],
                         r2[k], res[k])
            for k in ("hit", "t", "normal", "request", "request_pos",
                      "resume_t")
        }
        still = (r2["exhausted"] & included) | (exh & ~included)
        # dict(res, ...) keeps pass-through keys (e.g. "iters") so both
        # cond branches share one pytree structure.
        return _with_exh(dict(res, **merged, exhausted=still), exh)

    return jax.lax.cond(res["exh_n"] > 0, do_rescue, lambda _: res, None)


def _cond_rescue(res, o_all, d_all, scene, cam_brick, cfg: BrickmapConfig):
    """Multi-pass in-program rescue: ``rescue_passes - 1`` passes with the
    ``rescue_top_steps`` budget that re-sort stragglers by their CURRENT
    superchunk (resume-from-t makes the sort key the lane's live
    position), then one final pass with a budget no ray can exhaust."""
    import dataclasses

    m = o_all.shape[0]
    bucket = _rescue_bucket(m)
    for _ in range(max(cfg.render.rescue_passes - 1, 0)):
        mid = dataclasses.replace(
            cfg, render=dataclasses.replace(
                cfg.render, max_top_steps=cfg.render.rescue_top_steps))
        res = _rescue_pass(res, o_all, d_all, scene, cam_brick, mid, bucket)
    return _rescue_pass(res, o_all, d_all, scene, cam_brick,
                        _rescue_cfg(cfg), bucket)


@partial(jax.jit, static_argnames=("cfg", "bucket"))
def _trace_stage(st, scene, cam_brick, cfg: BrickmapConfig,
                 bucket: int | None):
    o_all, d_all, live = _concat_rays(st)
    if bucket is None:
        res = _trace(o_all, d_all, scene, cam_brick, cfg)
    else:
        res = _compact_trace(o_all, d_all, live, scene, cam_brick, cfg,
                             bucket)
    res = _with_exh(res, live)
    return _cond_rescue(res, o_all, d_all, scene, cam_brick, cfg)


def _ladder_switch(o_all, d_all, live, scene, cam_brick,
                   cfg: BrickmapConfig):
    """In-program bucket select: trace the live lanes through the smallest
    ladder bucket that holds them, chosen with ``lax.switch`` on the device
    live count, so no scalar is pulled to the host per bounce (the
    reference's frame is one uninterrupted kernel sequence,
    kernel.cu:416-431).  Every branch feeds the same rescue, so results are
    bit-identical to the host-picked equivalent."""
    m = o_all.shape[0]
    buckets = _ladder_buckets(m)
    count = jnp.sum(live.astype(jnp.int32))
    idx = sum((count > b).astype(jnp.int32) for b in buckets[:-1])

    def mk(bucket):
        def branch(_):
            res = _compact_trace(o_all, d_all, live, scene, cam_brick, cfg,
                                 bucket)
            return _with_exh(res, live)
        return branch

    # Rescue OUTSIDE the switch: one shared rescue chain per program instead
    # of one per ladder branch (each branch would add its own traversal
    # instance to the compile).
    res = jax.lax.switch(idx, [mk(b) for b in buckets], None)
    return _cond_rescue(res, o_all, d_all, scene, cam_brick, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _trace_stage_ladder(st, scene, cam_brick, cfg: BrickmapConfig):
    o_all, d_all, live = _concat_rays(st)
    return _ladder_switch(o_all, d_all, live, scene, cam_brick, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _final_trace_stage_ladder(st, scene, cam_brick, cfg: BrickmapConfig):
    return _ladder_switch(st["sh_o"], st["sh_d"], st["sh_active"], scene,
                          cam_brick, cfg)


@partial(jax.jit, static_argnames=("cfg", "bucket"))
def _final_trace_stage(st, scene, cam_brick, cfg: BrickmapConfig,
                       bucket: int | None):
    if bucket is None:
        res = _trace(st["sh_o"], st["sh_d"], scene, cam_brick, cfg)
    else:
        res = _compact_trace(st["sh_o"], st["sh_d"], st["sh_active"], scene,
                             cam_brick, cfg, bucket)
    res = _with_exh(res, st["sh_active"])
    return _cond_rescue(res, st["sh_o"], st["sh_d"], scene, cam_brick, cfg)


@partial(jax.jit, static_argnames=("cfg", "bucket", "final"))
def _rescue_stage(res, st, scene, cam_brick, cfg: BrickmapConfig,
                  bucket: int, final: bool):
    """Re-trace ``res``'s exhausted lanes (compacted) with the escalated
    ``cfg`` budgets and merge the rescue results over them."""
    if final:
        o_all, d_all = st["sh_o"], st["sh_d"]
    else:
        o_all, d_all, _ = _concat_rays(st)
    exh = res["exhausted"]
    off = jnp.where(exh, jnp.maximum(res["resume_t"] - 2.0, 0.0), 0.0)
    r2 = _compact_trace(o_all + d_all * off[:, None], d_all, exh, scene,
                        cam_brick, cfg, bucket)
    r2 = dict(r2, t=jnp.where(r2["hit"], r2["t"] + off, 0.0),
              resume_t=r2["resume_t"] + off)
    merged = {
        k: jnp.where(exh if res[k].ndim == 1 else exh[:, None], r2[k],
                     res[k])
        for k in ("hit", "t", "normal", "request", "request_pos",
                  "resume_t")
    }
    return _with_exh(dict(merged, exhausted=r2["exhausted"]), exh)


@partial(jax.jit, static_argnames=("cfg",))
def _shade_stage(bounce, key, st, res, sun_dir, cfg: BrickmapConfig):
    return _shade_update(bounce, key, st, res, sun_dir, cfg)


@partial(jax.jit, static_argnames=("cfg", "bucket"))
def _bounce_step(bounce, key, st, scene, cam_brick, sun_dir,
                 cfg: BrickmapConfig, bucket: int | None = None):
    """One bounce: combined extend+connect traversal, then shade + NEE.

    ``bounce`` is traced, so one executable serves every bounce at a given
    compaction ``bucket`` (the reference relaunches the same five kernels per
    frame, kernel.cu:416-420 — same idea, one fused launch here).  This is
    the fully-fused single-program form used inside ``shard_map`` /
    ``lax``-driven callers; the host-orchestrated wave uses the staged
    ``_trace_stage``/``_shade_stage`` pair so exhausted lanes can be rescued
    between them.
    """
    o_all, d_all, live = _concat_rays(st)
    if bucket is None:
        res = _trace(o_all, d_all, scene, cam_brick, cfg)
    else:
        res = _compact_trace(o_all, d_all, live, scene, cam_brick, cfg,
                             bucket)
    return _shade_update(bounce, key, st, res, sun_dir, cfg)


def _shade_update(bounce, key, st, res, sun_dir, cfg: BrickmapConfig):
    """Shading + NEE + next-bounce state from a traversal result (the
    reference's ``shade`` kernel, kernel.cu:242-325)."""
    n = st["origins"].shape[0]
    active, sh_active = st["active"], st["sh_active"]
    origins, dirs = st["origins"], st["dirs"]
    eps = cfg.grid.epsilon

    traced = st["traced"] + jnp.sum(active) + jnp.sum(sh_active)
    ext_hit = res["hit"][:n]
    ext_t = res["t"][:n]
    ext_n = res["normal"][:n]
    sh_hit = res["hit"][n:]
    # Budget-truncated lanes are NOT misses: they must neither shade as sky
    # (extension) nor count as unoccluded sun paths (shadow).  The reference
    # contract is that every ray terminates with a defined result
    # (voxel.cuh:135-261); here truncation is surfaced as a count the
    # harness asserts to be zero.
    ext_exh = res["exhausted"][:n] & active
    sh_exh = res["exhausted"][n:] & sh_active

    req_mask = st["req_mask"] | (res["request"][:n] & active) \
        | (res["request"][n:] & sh_active)
    req_pos = jnp.where((res["request"][:n] & active)[:, None],
                        res["request_pos"][:n], st["req_pos"])
    req_pos = jnp.where((res["request"][n:] & sh_active)[:, None],
                        res["request_pos"][n:], req_pos)

    accum = st["accum"] + jnp.where((sh_active & ~sh_hit & ~sh_exh)[:, None],
                                    st["sh_color"], 0.0)

    miss = active & ~ext_hit & ~ext_exh
    sky_v = sunsky_mod.sky(dirs, sun_dir, cfg.sky)
    sunsky_v = sunsky_mod.sunsky(dirs, sun_dir, cfg.sky)
    miss_rad = jnp.where(bounce == 0, sunsky_v, sky_v)
    accum = accum + jnp.where(miss[:, None], st["throughput"] * miss_rad, 0.0)

    hit = active & ext_hit
    n_len2 = jnp.sum(ext_n * ext_n, axis=1, keepdims=True)
    ext_n = jnp.where(n_len2 > 0.0, ext_n, -dirs)
    hitpoint = origins + dirs * ext_t[:, None] + ext_n * (2.0 * eps)

    k_cone, k_bounce = jax.random.split(key)
    cone_ext = sunsky_mod.cone_extent(cfg.sky)
    sdir = cone_sample(k_cone, sun_dir, cone_ext, shape=(n,))
    sun_cos = jnp.sum(ext_n * sdir, axis=1)
    sun_rad = sunsky_mod.sun(sdir, sun_dir, cfg.sky)

    new_dirs = cosine_hemisphere(k_bounce, ext_n)
    more = bounce < cfg.render.max_bounces
    new_active = hit & more
    new_sh_active = hit & (sun_cos > 0.0)
    # Dead lanes get a ray that fails the AABB clip immediately: otherwise
    # they re-trace their stale previous ray through the whole grid on every
    # later bounce (measured ~2 s/bounce at 1080p with 0 live lanes).
    dead_o = jnp.full((1, 3), -10.0, jnp.float32)
    dead_d = jnp.full((1, 3), -1.0, jnp.float32)
    return dict(
        st,
        origins=jnp.where(new_active[:, None],
                          jnp.where(hit[:, None], hitpoint, origins), dead_o),
        dirs=jnp.where(new_active[:, None],
                       jnp.where(hit[:, None], new_dirs, dirs), dead_d),
        active=new_active,
        sh_o=jnp.where(new_sh_active[:, None], hitpoint, dead_o),
        sh_d=jnp.where(new_sh_active[:, None], sdir, dead_d),
        sh_color=st["throughput"] * sun_rad * (sun_cos[:, None] * 1e-5),
        sh_active=new_sh_active,
        accum=accum, req_mask=req_mask, req_pos=req_pos, traced=traced,
        exh_count=st["exh_count"] + jnp.sum(ext_exh.astype(jnp.int32))
        + jnp.sum(sh_exh.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("cfg", "bucket"))
def _final_shadow(st, scene, cam_brick, cfg: BrickmapConfig,
                  bucket: int | None = None):
    if bucket is None:
        res = _trace(st["sh_o"], st["sh_d"], scene, cam_brick, cfg)
    else:
        res = _compact_trace(st["sh_o"], st["sh_d"], st["sh_active"], scene,
                             cam_brick, cfg, bucket)
    return _final_accum_update(st, res)


@jax.jit
def _final_accum_stage(st, res):
    return _final_accum_update(st, res)


def _final_accum_update(st, res):
    traced = st["traced"] + jnp.sum(st["sh_active"])
    sh_exh = res["exhausted"] & st["sh_active"]
    accum = st["accum"] + jnp.where(
        (st["sh_active"] & ~res["hit"] & ~sh_exh)[:, None],
        st["sh_color"], 0.0)
    req_mask = st["req_mask"] | (res["request"] & st["sh_active"])
    req_pos = jnp.where((res["request"] & st["sh_active"])[:, None],
                        res["request_pos"], st["req_pos"])
    count = jnp.ones(st["accum"].shape[0], jnp.float32)
    exh = st["exh_count"] + jnp.sum(sh_exh.astype(jnp.int32))
    return accum, count, {"mask": req_mask, "pos": req_pos,
                          "traced_rays": traced, "exhausted_rays": exh}


def _tile_permutation(width: int, height: int, tile: int = 128):
    """Pixel ordering that groups square tiles (ray coherence: chunks sharing
    blocks/bricks exit their lockstep loops together). Returns (perm, inv)."""
    import numpy as np

    idx = np.arange(width * height, dtype=np.int32)
    x = idx % width
    y = idx // width
    key = ((y // tile).astype(np.int64) * ((width + tile - 1) // tile)
           + (x // tile)) * (width * height) + idx
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


_tile_perm_cache: dict = {}


def render_wave(key, scene, camera_arrays, cam_brick, cfg: BrickmapConfig,
                width: int, height: int, retry_on_overflow: bool = True):
    """Trace one full sample wave (1 spp for every pixel).

    Host-orchestrated like the reference's per-frame kernel launches
    (kernel.cu:416-420): one primary program, one trace and one shade
    program per bounce, one final shadow pass; the bounce executables
    compile once.  Pixels are processed in square-tile order so traversal
    blocks stay ray-coherent; outputs are returned in row-major pixel
    order.

    ``retry_on_overflow`` (default): pull the exhausted count and re-run
    the wave with host-gated exact-bucket rescues if the static in-program
    rescue bucket overflowed (>m/16 exhausted lanes in one stage).  The
    pull is a host sync that serializes the dispatch pipeline; callers
    that already FAIL loudly on any exhausted ray (the benchmark harness)
    pass False and keep the wave entirely sync-free.

    Returns (delta_rgb [N,3], delta_count [N], requests dict) — add to a Film.
    """
    if (width, height) not in _tile_perm_cache:
        _tile_perm_cache[(width, height)] = _tile_permutation(width, height)
    perm, inv = _tile_perm_cache[(width, height)]
    perm_j = jnp.asarray(perm)
    inv_j = jnp.asarray(inv)

    k_pix, k_loop = jax.random.split(key)
    st = _primary_state(k_pix, camera_arrays, cfg, width, height,
                        pixel_order=perm_j)
    rgb, count, req = _bucketed_wave(k_loop, st, scene, cam_brick,
                                     camera_arrays["sun_direction"], cfg)
    if retry_on_overflow and int(np.asarray(req["exhausted_rays"])) > 0:
        # The same key reproduces the identical sample paths, now all
        # resolved by exact-bucket host-gated rescues.
        rgb, count, req = _bucketed_wave(
            k_loop, st, scene, cam_brick, camera_arrays["sun_direction"],
            cfg, host_rescue=True)
    return (jnp.take(rgb, inv_j, axis=0), jnp.take(count, inv_j, axis=0),
            dict(req, mask=jnp.take(req["mask"], inv_j, axis=0),
                 pos=jnp.take(req["pos"], inv_j, axis=0)))


_jit_wave = jax.jit(wave_for_indices, static_argnames=("cfg", "width", "height"))


def render_frame(key, scene, camera_arrays, cam_brick, cfg: BrickmapConfig,
                 width: int, height: int, rays_per_chunk: int = 61440):
    """One sample wave rendered in pixel chunks (separate device programs).

    Chunking bounds per-call device memory and lets chunks whose rays all
    terminate early exit their loops sooner than a whole-frame batch would.

    Returns (rgb [N,3], count [N], traced_rays int, requests list of (x,y,z),
    exhausted_rays int).
    """
    import numpy as np

    n = width * height
    rays_per_chunk = min(rays_per_chunk, n)
    rgb_parts, count_parts, reqs = [], [], []
    traced = 0
    exhausted = 0
    for c, start in enumerate(range(0, n, rays_per_chunk)):
        stop = min(start + rays_per_chunk, n)
        # Equal chunk shapes avoid recompiles; final partial chunk wraps.
        idx = jnp.arange(stop - rays_per_chunk, stop, dtype=jnp.int32) \
            if stop - start < rays_per_chunk \
            else jnp.arange(start, stop, dtype=jnp.int32)
        rgb, count, req = _jit_wave(
            jax.random.fold_in(key, c), idx, scene, camera_arrays, cam_brick,
            cfg, width, height)
        if stop - start < rays_per_chunk:
            keep = rays_per_chunk - (stop - start)
            rgb, count = rgb[keep:], count[keep:]
        rgb_parts.append(rgb)
        count_parts.append(count)
        traced += int(req["traced_rays"])
        exhausted += int(req["exhausted_rays"])
        from ..stream import pull_requests

        reqs.extend(pull_requests(req))
    return (jnp.concatenate(rgb_parts), jnp.concatenate(count_parts),
            traced, reqs, exhausted)


# Re-export: the implementation lives with the camera model (one source of
# truth for primary-ray generation).
from .camera import camera_arrays_for  # noqa: E402
