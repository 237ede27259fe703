#!/usr/bin/env python
"""Driver benchmark: prints ONE JSON line with the headline metric.

Headline: Mrays/s, forward path tracing at 1920x1080, 3 bounces, over the
reference's 9 scripted viewpoints on the simplex-terrain world (BASELINE.md;
resolution main.cpp:49, world variables.h:7-8, viewpoints
performance_measure.h:4-25).  The traversal is the one ``render_wave``
dispatches to: the Triton march kernel on a GPU (``--xla-path`` forces the
XLA reference traversal instead).

Every stage runs in a subprocess of its own, one after another, so that one
process holds the card at a time; this parent never imports JAX.  A stage
that fails or times out fails the bench.  Heartbeats go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
_T0 = time.time()


def _hb(msg: str) -> None:
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


# ---------------------------------------------------------------------------
# Subprocess plumbing
# ---------------------------------------------------------------------------

def _run_stage(argv: list[str], timeout: float, label: str):
    """Run ``python bench.py <argv>``; return the payload of its final
    ``STAGE_RESULT {json}`` stdout line.  Raises if the stage fails."""
    _hb(f"stage {label}: starting (timeout {timeout:.0f}s)")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__)] + argv,
        stdout=subprocess.PIPE, stderr=None, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)), check=True)
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("STAGE_RESULT "):
            _hb(f"stage {label}: ok")
            return json.loads(line[len("STAGE_RESULT "):])
    raise RuntimeError(f"stage {label} printed no result: "
                       f"{proc.stdout[-500:]!r}")


def _stage_setup():
    """In a stage process: stdout becomes heartbeats, the compile cache is
    set up; returns the real stdout for the result line."""
    real_stdout = sys.stdout
    sys.stdout = sys.stderr
    from brickmap_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return real_stdout


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------------------
# Forward-bench stage (runs inside the subprocess)
# ---------------------------------------------------------------------------

def _load_world(tag: str, cfg, scene_mod):
    cache_path = os.path.join(CACHE, f"scene_{tag}.npz")
    t0 = time.time()
    if os.path.exists(cache_path):
        sc = scene_mod.load_scene(cache_path)
        _hb(f"scene loaded from cache in {time.time()-t0:.1f}s")
    else:
        sc = scene_mod.generate_terrain_scene(cfg.grid)
        os.makedirs(CACHE, exist_ok=True)
        scene_mod.save_scene(cache_path, sc)
        _hb(f"scene generated in {time.time()-t0:.1f}s")
    return sc


def _device_scene(sc):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, sc)


def _fwd_stage_main(tag: str, xla: bool, waves: int) -> None:
    """Subprocess entry: scene prep + 9-viewpoint forward bench."""
    real_stdout = _stage_setup()

    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu.app.benchmark import run_forward_benchmark
    from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig

    render = RenderConfig(width=1920, height=1080, max_bounces=3,
                          traversal="xla" if xla else "auto")
    if tag == "small":
        cfg = BrickmapConfig(grid=GridConfig(grid_size=1024, grid_height=256),
                             render=render)
        scale = 1024.0 / 4096.0
    else:
        cfg = BrickmapConfig(grid=GridConfig(), render=render)
        scale = 1.0
    scene = _device_scene(_load_world(tag, cfg, scene_mod))
    _hb("forward benchmark: starting")
    fwd = run_forward_benchmark(scene, cfg, waves_per_view=waves,
                                scale=scale, verbose=True)
    per_view = fwd["per_view"]
    payload = {
        "mrays_per_s": fwd["mrays_per_s"],
        "per_view_mrays": [round(r["mrays_per_s"], 2) for r in per_view],
        "exhausted_rays": fwd["total_exhausted"],
        "avg_ms": round(sum(r["avg_ms"] for r in per_view)
                        / max(len(per_view), 1), 2),
        "width": cfg.render.width, "height": cfg.render.height,
        "bounces": cfg.render.max_bounces,
        "world": tag, "traversal": "xla" if xla else "auto",
        "device": _device(),
    }
    print("STAGE_RESULT " + json.dumps(payload), file=real_stdout, flush=True)


# ---------------------------------------------------------------------------
# Aux benches (each in its own subprocess; see _aux_main)
# ---------------------------------------------------------------------------

AUX = {}


def _aux_main(name: str) -> None:
    """Subprocess entry for one aux bench."""
    real_stdout = _stage_setup()
    from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig

    cfg = BrickmapConfig(
        grid=GridConfig(),
        render=RenderConfig(width=1920, height=1080, max_bounces=3))
    print("STAGE_RESULT " + json.dumps({"value": AUX[name](cfg)}),
          file=real_stdout, flush=True)


def _timed(fn, reps: int = 2) -> float:
    """Best wall time of ``reps`` calls of ``fn`` after one warm-up; ``fn``
    returns device arrays, waited for with ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _bwd_bench(cfg):
    """fwd+bwd differentiable render throughput over a 64^3 dense grid at the
    benchmark resolution (config-5 style gradients)."""
    import numpy as np
    import jax.numpy as jnp

    from brickmap_tpu.diff.render import l2_loss_and_grads

    rng = np.random.default_rng(0)
    occ = jnp.asarray(rng.uniform(0, 1, (64, 64, 64)).astype(np.float32))
    alb = jnp.asarray(rng.uniform(0, 1, (64, 64, 64, 3)).astype(np.float32))
    n = cfg.render.width * cfg.render.height
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([32, 32, 32]) - dirs * 96).astype(np.float32)
    bg = np.zeros((n, 3), np.float32)
    tgt = np.full((n, 3), 0.5, np.float32)
    args_j = (jnp.asarray(origins), jnp.asarray(dirs), occ, alb,
              jnp.asarray(bg), jnp.asarray(tgt))
    return n / _timed(lambda: l2_loss_and_grads(*args_j, max_steps=192),
                      reps=3) / 1e6


def _downward_rays(n: int, lo: float, hi: float, z: float, seed: int = 0):
    """The inverse-rendering workload: rays from above, pointing down."""
    import numpy as np
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    ox = rng.uniform(lo, hi, n).astype(np.float32)
    oy = rng.uniform(lo, hi, n).astype(np.float32)
    origins = np.stack([ox, oy, np.full(n, z, np.float32)], 1)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return jnp.asarray(origins), jnp.asarray(dirs)


def _sparse_step_rates(n, step):
    """Mrays/s of a full sparse step and of the cached optimizer step (record
    and sorts reused, as in an inverse-rendering loop)."""
    cache: dict = {}
    return {"full": n / _timed(lambda: step(None)) / 1e6,
            "cached_step": n / _timed(lambda: step(cache)) / 1e6}


def _sparse_bwd_bench(cfg):
    """fwd+bwd over the SPARSE brick pool at benchmark resolution: segment
    recording + bounded-K replay gradients (diff/sparse.py), on the
    1024^2x256 world."""
    import jax.numpy as jnp

    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu.config import BrickmapConfig, GridConfig
    from brickmap_tpu.diff.sparse import (
        cell_pool_map, l2_loss_and_grads_sparse, pool_fields_from_bitmask)

    grid = GridConfig(grid_size=1024, grid_height=256)
    sc = _load_world("small", BrickmapConfig(grid=grid), scene_mod)
    jsc = _device_scene(sc)
    cellmap = jnp.asarray(cell_pool_map(sc, grid))
    occ, alb = pool_fields_from_bitmask(sc)
    occ_j = jnp.asarray(occ * 0.8)
    alb_j = jnp.asarray(alb * 0.6)
    n = cfg.render.width * cfg.render.height
    origins, dirs = _downward_rays(n, 64, 960, 250.0)
    bg = jnp.zeros((n, 3), jnp.float32)
    tgt = jnp.full((n, 3), 0.4, jnp.float32)
    return _sparse_step_rates(n, lambda cache: l2_loss_and_grads_sparse(
        origins, dirs, jsc, cellmap, occ_j, alb_j, bg, tgt, grid,
        k_segments=8, seg_cache=cache))


def _sparse_bwd_full_bench(cfg):
    """fwd+bwd over the FULL 4096^2x512 world's sparse pool, with the field
    restricted to the frame's active bricks (diff.sparse.active_brick_fields).
    Rays cover a 2048^2 central region, a realistic single-frame
    footprint."""
    import jax.numpy as jnp

    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu.config import BrickmapConfig, GridConfig
    from brickmap_tpu.diff.sparse import (
        active_brick_fields, l2_loss_and_grads_sparse, record_segments)

    grid = GridConfig()
    sc = _load_world("full", BrickmapConfig(grid=grid), scene_mod)
    jsc = _device_scene(sc)
    n = cfg.render.width * cfg.render.height
    k = 8
    origins, dirs = _downward_rays(n, 1024, 3072, 500.0)
    bg = jnp.zeros((n, 3), jnp.float32)
    tgt = jnp.full((n, 3), 0.4, jnp.float32)

    t0 = time.perf_counter()
    slots = record_segments(origins, dirs, jsc, grid, k_segments=k)["slot"]
    cellmap, occ, alb = active_brick_fields(sc, grid, slots)
    a = occ.shape[0]
    _hb(f"active set: {a} of {sc.pool_words.shape[0]} bricks "
        f"({time.perf_counter()-t0:.1f}s prepass)")
    cellmap_j = jnp.asarray(cellmap)
    occ_j, alb_j = jnp.asarray(occ * 0.8), jnp.asarray(alb * 0.6)
    rates = _sparse_step_rates(n, lambda cache: l2_loss_and_grads_sparse(
        origins, dirs, jsc, cellmap_j, occ_j, alb_j, bg, tgt, grid,
        k_segments=k, seg_cache=cache))
    return dict(rates, active_bricks=int(a))


def _streaming_bench(cfg):
    """Cold-start streaming on the full world (the subsystem the reference
    is named for, Scene.cpp:200-252): 12 waves at 960x540 from all-unloaded
    residency, reporting Mrays/s during convergence and the sustained
    process_requests upload rate."""
    import jax
    import jax.numpy as jnp

    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu import stream as stream_mod
    from brickmap_tpu.app.benchmark import SUN_POSITION, TEST_ANGLES, \
        TEST_POSITIONS
    from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig
    from brickmap_tpu.ops import sunsky as ss
    from brickmap_tpu.render import pathtrace
    from brickmap_tpu.render.camera import Camera
    from brickmap_tpu.stream import StreamingScene

    grid = GridConfig()
    full_cfg = BrickmapConfig(
        grid=grid, render=RenderConfig(width=960, height=540, max_bounces=3))
    sc = _load_world("full", full_cfg, scene_mod)
    t0 = time.time()
    mgr = StreamingScene(sc, grid, starting_capacity=256)
    _hb(f"streaming manager cold init in {time.time()-t0:.1f}s")
    w, h = 960, 540
    cam = Camera.from_angles(TEST_POSITIONS[0], *TEST_ANGLES[0])
    sun = ss.sun_direction_from_position(jnp.asarray(SUN_POSITION))
    arrays = pathtrace.camera_arrays_for(cam, sun, w, h)
    cam_brick = jnp.asarray(cam.brick_position, jnp.int32)

    waves = 12
    uploads = 0
    upload_s = render_s = 0.0
    rays = 0
    for i in range(waves):
        tw = time.perf_counter()
        rgb, count, req = pathtrace.render_wave(
            jax.random.PRNGKey(i), mgr.device_scene(), arrays, cam_brick,
            full_cfg, w, h)
        jax.block_until_ready((rgb, req))
        if i > 0:                     # wave 0 pays compiles
            render_s += time.perf_counter() - tw
            rays += int(req["traced_rays"])
        # The reference's per-frame CPU side (Scene::process_load_queue):
        # request pull + dedupe + slot assignment + the device scatters.
        tu = time.perf_counter()
        got = stream_mod.pull_requests(req, mgr.queue_size)
        if got:
            uploads += mgr.process_requests(got)
        upload_s += time.perf_counter() - tu
    return {
        "mrays_during_convergence": rays / render_s / 1e6,
        "bricks_uploaded": uploads,
        "upload_bricks_per_s": uploads / max(upload_s, 1e-9),
        "waves": waves,
    }


def _brick_bench(cfg):
    """Config-1 class microbenchmark: the 8^3 brick DDA (ops/brick.py)."""
    import numpy as np
    import jax.numpy as jnp

    from brickmap_tpu import bits
    from brickmap_tpu.ops.brick import trace_single_brick

    rng = np.random.default_rng(0)
    dense = rng.random((8, 8, 8)) < 0.12
    words = jnp.asarray(np.asarray(
        bits.brick_words_from_dense(dense[None])[0], np.uint32))
    n = 1 << 21  # 2M rays
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    start = np.array([4.0, 4.0, 4.0]) - dirs * 20
    with np.errstate(divide="ignore"):
        tenter = np.minimum((0.0 - start) / dirs,
                            (8.0 - start) / dirs).max(1) + 1e-3
    o = jnp.asarray((start + dirs * tenter[:, None]).astype(np.float32))
    d = jnp.asarray(dirs)
    return n / _timed(lambda: trace_single_brick(o, d, words), reps=3) / 1e6


def _kernel_ab_bench(cfg, rounds: int = 6):
    """Paired end-to-end readings behind the kernel choices (PERF.md), all
    in one process: the march kernel's default block (32 rays, 1 warp)
    against 128 rays / 4 warps in 1080p 3-bounce ``render_wave`` at views
    0 and 3 of the full world, and the kernel recorder against the XLA
    recorder in the small-world sparse step.  The variants alternate
    A B B A ... so that drift hits both; every reading is kept."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu.app.benchmark import SUN_POSITION, benchmark_cameras
    from brickmap_tpu.config import BrickmapConfig, GridConfig
    from brickmap_tpu.diff import sparse
    from brickmap_tpu.ops import sunsky as ss
    from brickmap_tpu.ops.record import record_segments_xla
    from brickmap_tpu.pallas.march import trace_rays_kernel
    from brickmap_tpu.render import pathtrace

    order = [("a", "b", "b", "a")[i % 4] for i in range(rounds)]
    out = {"order": "".join(order)}
    w, h = cfg.render.width, cfg.render.height
    jsc = _device_scene(_load_world("full", cfg, scene_mod))
    sun = ss.sun_direction_from_position(jnp.asarray(SUN_POSITION))
    blocks = {"a": (32, 1), "b": (128, 4)}
    for v in (0, 3):
        cam = benchmark_cameras()[v]
        arrays = pathtrace.camera_arrays_for(cam, sun, w, h)
        cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
        reads = {"a": [], "b": []}
        for i, variant in enumerate(order):
            block, warps = blocks[variant]
            pathtrace.trace_rays_kernel = partial(
                trace_rays_kernel, block=block, num_warps=warps)
            jax.clear_caches()

            def wave(k):
                return pathtrace.render_wave(
                    jax.random.PRNGKey(k), jsc, arrays, cam_brick, cfg, w, h,
                    retry_on_overflow=False)

            jax.block_until_ready(wave(1000 + i))
            t0 = time.perf_counter()
            outs = jax.block_until_ready([wave(2 * i), wave(2 * i + 1)])
            dt = time.perf_counter() - t0
            rays = sum(int(r["traced_rays"]) for _, _, r in outs)
            assert sum(int(r["exhausted_rays"]) for _, _, r in outs) == 0
            reads[variant].append(rays / dt / 1e6)
            _hb(f"view {v} block {block}/{warps}: {reads[variant][-1]} "
                f"Mrays/s")
        out[f"view{v}_block32w1_mrays"] = reads["a"]
        out[f"view{v}_block128w4_mrays"] = reads["b"]
    pathtrace.trace_rays_kernel = trace_rays_kernel
    jax.clear_caches()
    del jsc

    grid = GridConfig(grid_size=1024, grid_height=256)
    sc = _load_world("small", BrickmapConfig(grid=grid), scene_mod)
    jsc = _device_scene(sc)
    cellmap = jnp.asarray(sparse.cell_pool_map(sc, grid))
    occ, alb = sparse.pool_fields_from_bitmask(sc)
    occ_j, alb_j = jnp.asarray(occ * 0.8), jnp.asarray(alb * 0.6)
    n = w * h
    origins, dirs = _downward_rays(n, 64, 960, 250.0)
    bg = jnp.zeros((n, 3), jnp.float32)
    tgt = jnp.full((n, 3), 0.4, jnp.float32)
    kernel_rec = sparse.record_segments_kernel
    recorders = {"a": kernel_rec, "b": record_segments_xla}
    reads = {"a": [], "b": []}

    def step():
        return sparse.l2_loss_and_grads_sparse(
            origins, dirs, jsc, cellmap, occ_j, alb_j, bg, tgt, grid,
            k_segments=8)

    for variant in ("a", "b"):
        sparse.record_segments_kernel = recorders[variant]
        jax.block_until_ready(step())
    for variant in order:
        sparse.record_segments_kernel = recorders[variant]
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        reads[variant].append((time.perf_counter() - t0) * 1e3)
        _hb(f"sparse step, recorder {variant}: {reads[variant][-1]} ms")
    sparse.record_segments_kernel = kernel_rec
    out["sparse_step_kernel_recorder_ms"] = reads["a"]
    out["sparse_step_xla_recorder_ms"] = reads["b"]
    return out


AUX.update({
    "kernel-ab": _kernel_ab_bench,
    "bwd": _bwd_bench,
    "sparse-bwd": _sparse_bwd_bench,
    "sparse-bwd-full": _sparse_bwd_full_bench,
    "streaming": _streaming_bench,
    "brick": _brick_bench,
})


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="1024^2x256 world instead of the full 4096^2x512")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--skip-bwd", action="store_true")
    ap.add_argument("--xla-path", action="store_true",
                    help="benchmark the XLA reference traversal instead of "
                         "the march kernel")
    ap.add_argument("--kernel-ab", action="store_true",
                    help="only the paired readings behind the kernel "
                         "choices (block size, recorder)")
    ap.add_argument("--stage", choices=["fwd"], help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="full", help=argparse.SUPPRESS)
    ap.add_argument("--aux", choices=sorted(AUX), help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.aux:
        _aux_main(args.aux)
        return
    if args.kernel_ab:
        print(json.dumps(_run_stage(["--aux", "kernel-ab"], 1500,
                                    "aux:kernel-ab")["value"]), flush=True)
        return
    if args.stage == "fwd":
        _fwd_stage_main(args.tag, args.xla_path, args.waves)
        return

    tag = "small" if args.small else "full"
    argv = ["--stage", "fwd", "--tag", tag, f"--waves={args.waves}"]
    fwd = _run_stage(argv + (["--xla-path"] if args.xla_path else []),
                     2400, f"fwd-{tag}")

    def aux(name, timeout=1200):
        return _run_stage(["--aux", name], timeout, f"aux:{name}")["value"]

    extras = {"brick_mrays_per_s": aux("brick", 900),
              "streaming": aux("streaming", 900)}
    if not args.skip_bwd:
        sparse = aux("sparse-bwd")
        full = aux("sparse-bwd-full", 1800)
        extras.update({
            "sparse_fwd_bwd_mrays_per_s": sparse["full"],
            "sparse_cached_step_mrays_per_s": sparse["cached_step"],
            "sparse_bwd_world": "small",
            "sparse_fwd_bwd_full_mrays_per_s": full["full"],
            "sparse_full_cached_step_mrays_per_s": full["cached_step"],
            "sparse_full_active_bricks": full["active_bricks"],
            "fwd_bwd_mrays_per_s": aux("bwd", 900),
        })
    print(json.dumps({
        "metric": f"Mrays/s fwd path tracing {fwd['width']}x{fwd['height']} "
                  f"{fwd['bounces']}b, 9-viewpoint avg, {fwd['world']} world",
        "value": fwd["mrays_per_s"],
        "unit": "Mrays/s",
        "vs_baseline": None,  # reference publishes no numbers (BASELINE.md)
        **{k: fwd[k] for k in ("per_view_mrays", "exhausted_rays", "avg_ms",
                               "world", "traversal", "device")},
        **extras,
    }), flush=True)


if __name__ == "__main__":
    main()
