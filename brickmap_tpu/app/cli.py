"""Command-line harness — this build's ``main()``.

The reference's application layer is a GLFW/ImGui interactive loop
(``main.cpp:26-190``); on a headless host the equivalents are batch
subcommands:

* ``render``  — progressive path-traced render of a world to PNG
  (frame loop -> sample-wave loop; camera flags replace WASD).
* ``bench``   — the 9-viewpoint scripted benchmark (performance_measure.cpp).
* ``inverse`` — inverse-rendering demo: optimize occupancy+albedo to match
  target renders (the new differentiable capability).
* ``info``    — scene statistics (Scene::dump analog).
* ``scaling`` — data-parallel scaling-efficiency benchmark over growing
  device meshes (BASELINE >=80% target; no reference analog).

Run as ``python -m brickmap_tpu <cmd> ...``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


class CliError(RuntimeError):
    """User-facing error: printed as a message, not a traceback."""


def _build_world(args, cfg):
    from .. import scene as scene_mod

    if getattr(args, "load", None):
        if not os.path.exists(args.load):
            raise CliError(f"scene file not found: {args.load}")
        try:
            sc = scene_mod.load_scene(args.load)
        except Exception as e:
            raise CliError(f"could not load scene {args.load}: {e}") from e
        print(f"loaded {args.load}", file=sys.stderr)
    else:
        t0 = time.time()
        sc = scene_mod.generate_terrain_scene(cfg.grid)
        print(f"terrain generated in {time.time()-t0:.1f}s", file=sys.stderr)
    if getattr(args, "save_scene", None):
        scene_mod.save_scene(args.save_scene, sc)
    return sc


def _to_device(sc):
    import jax.numpy as jnp

    from .. import scene as scene_mod

    return scene_mod.VoxelScene(
        index_volume=jnp.asarray(sc.index_volume),
        pool_words=jnp.asarray(sc.pool_words),
        pool_base=jnp.asarray(sc.pool_base),
    )


def _camera_for(args, position, look):
    from ..render.camera import Camera

    if args.angles:
        h, v = args.angles
        return Camera.from_angles(position, h, v,
                                  focal_distance=args.focal_distance,
                                  lens_radius=args.lens_radius)
    d = np.asarray(look, np.float64) - np.asarray(position, np.float64)
    n = np.linalg.norm(d)
    if n < 1e-9:
        raise CliError("--camera and --look coincide; no view direction")
    d = d / n
    return Camera(position=tuple(float(p) for p in position),
                  direction=tuple(d),
                  focal_distance=args.focal_distance,
                  lens_radius=args.lens_radius)


def _apply_camera_input(cam, deltas, move_scale: float):
    """Fly-camera update from preview input deltas (camera.cpp:3-46):
    move = [forward, right, up] impulses, rot = [dyaw, dpitch] radians."""
    import math

    from ..render.camera import Camera

    d = np.asarray(cam.direction, np.float64)
    yaw = math.atan2(d[0], d[1])            # camera.cpp:49-53 convention
    pitch = math.asin(max(-1.0, min(1.0, d[2])))
    yaw += deltas["rot"][0]
    pitch = max(-1.55, min(1.55, pitch + deltas["rot"][1]))
    fwd = np.array([math.cos(pitch) * math.sin(yaw),
                    math.cos(pitch) * math.cos(yaw), math.sin(pitch)])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= max(np.linalg.norm(right), 1e-9)
    pos = (np.asarray(cam.position, np.float64)
           + move_scale * (deltas["move"][0] * fwd
                           + deltas["move"][1] * right
                           + deltas["move"][2] * np.array([0.0, 0.0, 1.0])))
    return Camera.from_angles(tuple(pos), yaw, pitch,
                              focal_distance=cam.focal_distance,
                              lens_radius=cam.lens_radius)


def cmd_render(args) -> int:
    """Progressive render; with --turntable, a scripted camera path with
    accumulation reset on every camera move (the reference's interactive
    reset, kernel.cu:387-403, driven by waypoints instead of WASD).  With
    --serve, the preview page's WASD/arrow input flies the camera live."""
    import jax
    import jax.numpy as jnp

    from ..config import BrickmapConfig, GridConfig, RenderConfig
    from ..ops import sunsky as ss
    from ..render import pathtrace
    from ..utils.image import write_png
    from ..utils.metrics import FrameTimer, MetricsLogger

    if args.spp < 1:
        raise CliError("--spp must be >= 1")
    cfg = BrickmapConfig(
        grid=GridConfig(grid_size=args.world, grid_height=args.world_height),
        render=RenderConfig(width=args.width, height=args.height,
                            max_bounces=args.bounces,
                            max_top_steps=args.max_steps,
                            focal_distance=args.focal_distance,
                            lens_radius=args.lens_radius),
    )
    sc = _build_world(args, cfg)

    mgr = None
    if args.streaming:
        from ..stream import StreamingScene

        # Generous starting capacity: each pool-shape change recompiles the
        # render executables, so unlike the reference's cheap cudaMalloc
        # doubling (Scene.cpp:235-250) we start near the expected resident
        # set.
        mgr = StreamingScene(sc, cfg.grid, starting_capacity=256)
        jsc = mgr.device_scene()
    else:
        jsc = _to_device(sc)

    sun = ss.sun_direction_from_position(jnp.asarray(args.sun))

    # Camera schedule: static, or a turntable orbit around --look (one frame
    # per position; moving the camera resets accumulation like the
    # reference's camera-delta check).
    def camera_at(frame):
        if not args.turntable:
            return _camera_for(args, args.camera, args.look)
        look = np.asarray(args.look, np.float64)
        rel = np.asarray(args.camera, np.float64) - look
        th = 2.0 * np.pi * frame / args.turntable
        rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                        [np.sin(th), np.cos(th), 0.0],
                        [0.0, 0.0, 1.0]])
        return _camera_for(args, tuple(look + rot @ rel), tuple(look))

    from ..utils.profiling import trace as profile_trace

    server = None
    if args.serve is not None:
        from ..utils.preview import PreviewServer

        server = PreviewServer(args.serve, host=args.serve_host)
        print(f"live preview: http://localhost:{server.port}/",
              file=sys.stderr)

    frames = args.turntable if args.turntable else 1
    timer = FrameTimer()
    metrics = MetricsLogger(args.metrics, echo=args.verbose)
    prev_cam = None
    film = None
    wave_idx = 0
    prof = profile_trace(args.profile)
    prof.__enter__()
    # Preview fly-camera: once input arrives it overrides the schedule.
    override_cam = None
    move_scale = max(args.world / 128.0, 1.0)
    for frame in range(frames):
        cam = override_cam if override_cam is not None else camera_at(frame)
        if cam != prev_cam:
            # Accumulation reset on camera change (kernel.cu:387-403).
            film = pathtrace.film_init(args.width, args.height)
            prev_cam = cam
        arrays = pathtrace.camera_arrays_for(cam, sun, args.width,
                                             args.height)
        cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
        for s in range(args.spp):
            t0 = time.perf_counter()
            rgb, count, req = pathtrace.render_wave(
                jax.random.PRNGKey(args.seed + wave_idx), jsc, arrays,
                cam_brick, cfg, args.width, args.height)
            film = pathtrace.film_add(film, rgb, count)
            jax.block_until_ready(film["rgb"])
            dt = time.perf_counter() - t0
            timer.add(dt)
            uploads = 0
            if mgr is not None:
                # The per-frame CPU half of streaming (main.cpp:144 ->
                # Scene::process_load_queue): service this wave's requests,
                # then render against the updated residency next wave.
                from ..stream import pull_requests

                got = pull_requests(req, mgr.queue_size)
                if got:
                    uploads = mgr.process_requests(got)
                    jsc = mgr.device_scene()
            metrics.log(wave_idx, wave_s=dt, traced=int(req["traced_rays"]),
                        mrays_s=int(req["traced_rays"]) / dt / 1e6,
                        uploads=uploads,
                        exhausted=int(req["exhausted_rays"]))
            if args.verbose:
                extra = f" uploads {uploads}" if mgr is not None else ""
                print(f"frame {frame} wave {s}: {dt*1000:.0f} ms{extra}",
                      file=sys.stderr)
            wave_idx += 1
            preview_now = args.preview_every \
                and (s + 1) % args.preview_every == 0 and s + 1 < args.spp
            if server is not None or preview_now:
                img = np.asarray(pathtrace.tonemap(film, args.width,
                                                   args.height))
                if preview_now:
                    write_png(args.out, img)
                if server is not None:
                    server.update(
                        img, frame=frame, wave=s + 1, spp=args.spp,
                        wave_ms=round(dt * 1000, 1),
                        mrays_s=round(int(req["traced_rays"]) / dt / 1e6, 2),
                        camera=[round(p, 1) for p in cam.position])
            if server is not None:
                deltas = server.pop_camera()
                if deltas is not None:
                    # Apply preview fly-camera input between waves: move the
                    # camera and restart accumulation (the reference applies
                    # input per frame, main.cpp:119-127 + kernel.cu:387-403).
                    override_cam = _apply_camera_input(cam, deltas,
                                                       move_scale)
                    cam = override_cam
                    film = pathtrace.film_init(args.width, args.height)
                    arrays = pathtrace.camera_arrays_for(
                        cam, sun, args.width, args.height)
                    cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
                    prev_cam = cam
        img = np.asarray(pathtrace.tonemap(film, args.width, args.height))
        out = args.out if frames == 1 else \
            args.out.replace(".png", f"_{frame:03d}.png")
        write_png(out, img)
        if server is not None:
            server.update(img, frame=frame, wave=args.spp, spp=args.spp,
                          done=frame + 1 == frames)
    prof.__exit__(None, None, None)
    if mgr is not None:
        res = mgr.dump()
        surf = mgr.surface_stats()
        print(f"streaming: {int(res.sum())} bricks resident, "
              f"{mgr.total_uploaded} uploaded, {mgr.total_dropped} dropped",
              file=sys.stderr)
        # The reference's locality invariant (README.md:7): rays don't
        # penetrate solid volume, so every load is ray-reachable (air face
        # or a partially-filled neighbor); unreachable loads must be 0.
        print(f"streaming: {surf['loaded_surface']} air-surface + "
              f"{surf['loaded_reachable'] - surf['loaded_surface']} "
              f"behind-partial / {surf['loaded_unreachable']} unreachable "
              f"(world: {surf['surface_total']} surface, "
              f"{surf['reachable_total']} reachable of "
              f"{surf['nonempty_total']} non-empty)", file=sys.stderr)

    stats = timer.stats()
    # The timer counts timed WAVES; don't let its "frames" key shadow the
    # camera-frame count.
    stats["waves"] = stats.pop("frames")
    print(json.dumps({"out": args.out, "spp": args.spp, "frames": frames,
                      **stats}))
    return 0


def cmd_bench(args) -> int:
    from ..config import BrickmapConfig, GridConfig, RenderConfig
    from .benchmark import run_forward_benchmark

    cfg = BrickmapConfig(
        grid=GridConfig(grid_size=args.world, grid_height=args.world_height),
        render=RenderConfig(width=args.width, height=args.height,
                            max_bounces=args.bounces,
                            max_top_steps=args.max_steps),
    )
    sc = _build_world(args, cfg)
    jsc = _to_device(sc)
    out = run_forward_benchmark(jsc, cfg, waves_per_view=args.waves,
                                scale=args.world / 4096.0)
    print(json.dumps({k: v for k, v in out.items() if k != "per_view"}))
    return 0


def cmd_inverse(args) -> int:
    import jax
    import jax.numpy as jnp
    import optax

    from ..diff.render import composite_rays, l2_loss_and_grads
    from ..utils.image import write_png

    if args.sparse:
        return _cmd_inverse_sparse(args)

    rng = np.random.default_rng(args.seed)
    g = args.grid
    # Ground truth: a floating blob of solid voxels with banded albedo.
    occ_true = np.zeros((g, g, g), np.float32)
    c = g // 2
    zz, yy, xx = np.meshgrid(*[np.arange(g)] * 3, indexing="ij")
    occ_true[(zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2 < (g // 3) ** 2] = 1
    alb_true = np.stack([
        0.2 + 0.6 * (zz / g), 0.3 + 0.4 * (yy / g), 0.8 - 0.5 * (xx / g)
    ], -1).astype(np.float32)

    n = args.rays
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([c, c, c]) - dirs * (2.2 * g)).astype(np.float32)
    bg = np.zeros((n, 3), np.float32)
    target, _, _ = composite_rays(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ_true),
        jnp.asarray(alb_true), jnp.asarray(bg), max_steps=3 * g)

    occ = jnp.full((g, g, g), 0.3)
    alb = jnp.full((g, g, g, 3), 0.5)
    opt = optax.adam(args.lr)
    state = opt.init((occ, alb))
    t0 = time.perf_counter()
    loss0 = None
    for step in range(args.steps):
        loss, grads = l2_loss_and_grads(
            jnp.asarray(origins), jnp.asarray(dirs), occ, alb,
            jnp.asarray(bg), target, max_steps=3 * g)
        if loss0 is None:
            loss0 = float(loss)
        updates, state = opt.update(grads, state)
        occ, alb = optax.apply_updates((occ, alb), updates)
        occ = jnp.clip(occ, 0.0, 1.0)
        alb = jnp.clip(alb, 0.0, 1.0)
        if step % 20 == 0:
            print(f"step {step}: loss {float(loss):.6f}", file=sys.stderr)
    print(json.dumps({
        "steps": args.steps, "loss_first": loss0, "loss_final": float(loss),
        "seconds": time.perf_counter() - t0,
    }))
    return 0


def _cmd_inverse_sparse(args) -> int:
    """Inverse rendering over the SPARSE brick pool (BASELINE config 5):
    recover per-voxel albedo (and refine occupancy) of a terrain world from
    rendered targets, via segment recording + bounded-K replay."""
    import jax
    import jax.numpy as jnp
    import optax

    from .. import scene as scene_mod
    from ..config import GridConfig
    from ..diff.sparse import (cell_pool_map, composite_sparse,
                               l2_loss_and_grads_sparse,
                               pool_fields_from_bitmask, record_segments)

    grid = GridConfig(grid_size=args.world, grid_height=args.world_height)
    sc = scene_mod.generate_terrain_scene(grid)
    psc = _to_device(sc)
    cellmap = jnp.asarray(cell_pool_map(sc, grid))
    occ_true, _ = pool_fields_from_bitmask(sc)
    print(f"terrain world {args.world}^2x{args.world_height}, "
          f"{occ_true.shape[0]} resident bricks", file=sys.stderr)

    # Ground-truth albedo: height bands over the brick pool's voxels.
    cm = np.asarray(cellmap)
    zz, yy, xx = np.nonzero(cm >= 0)
    vz = np.zeros((occ_true.shape[0], 512), np.float32)
    vz[cm[zz, yy, xx]] = (zz[:, None] * 8
                          + (np.arange(512) // 64)[None, :]).astype(
                              np.float32) / (args.world_height)
    alb_true = np.stack([0.2 + 0.7 * vz, 0.5 + 0.3 * np.sin(vz * 9.0),
                         0.9 - 0.6 * vz], axis=-1).astype(np.float32)

    rng = np.random.default_rng(args.seed)
    n = args.rays
    m = float(args.world)
    ox = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
    oy = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
    oz = np.full(n, args.world_height - 2.0, np.float32)
    origins = jnp.asarray(np.stack([ox, oy, oz], 1))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.7
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = jnp.asarray(dirs)
    bg = jnp.zeros((n, 3), jnp.float32)

    segs = record_segments(origins, dirs, psc, grid, k_segments=8)
    target, _ = composite_sparse(segs["o_cells"], dirs, segs, cellmap,
                                 jnp.asarray(occ_true),
                                 jnp.asarray(alb_true), bg, grid,
                                 k_segments=8)

    occ = jnp.asarray(occ_true * 0.6)   # soft start; recover hardness
    alb = jnp.full_like(jnp.asarray(alb_true), 0.5)
    opt = optax.adam(args.lr)
    state = opt.init((occ, alb))
    t0 = time.perf_counter()
    loss0 = None
    seg_cache: dict = {}   # record + sorts are loop-invariant (fixed rays)
    for step in range(args.steps):
        loss, (docc, dalb) = l2_loss_and_grads_sparse(
            origins, dirs, psc, cellmap, occ, alb, bg, target, grid,
            k_segments=8, seg_cache=seg_cache)
        if loss0 is None:
            loss0 = float(loss)
        updates, state = opt.update((docc, dalb), state)
        occ, alb = optax.apply_updates((occ, alb), updates)
        occ = jnp.clip(occ, 0.0, 1.0)
        alb = jnp.clip(alb, 0.0, 1.0)
        if step % 10 == 0:
            print(f"step {step}: loss {float(loss):.6f}", file=sys.stderr)
    print(json.dumps({
        "mode": "sparse", "world": args.world, "rays": n,
        "bricks": int(occ_true.shape[0]), "steps": args.steps,
        "loss_first": loss0, "loss_final": float(loss),
        "seconds": time.perf_counter() - t0,
    }))
    return 0


def cmd_info(args) -> int:
    from .. import scene as scene_mod
    from ..config import GridConfig

    if not os.path.exists(args.load):
        raise CliError(f"scene file not found: {args.load}")
    sc = scene_mod.load_scene(args.load)
    cz, cy, cx = sc.index_volume.shape
    grid = GridConfig(grid_size=cx * 8, grid_height=cz * 8)
    info = scene_mod.scene_summary(sc, grid)
    info.pop("per_superchunk_loaded")
    print(json.dumps(info))
    return 0


def cmd_scaling(args) -> int:
    """Data-parallel scaling-efficiency benchmark (BASELINE >=80% target,
    SURVEY P6-P8): forward waves + sparse inverse steps on growing meshes."""
    from ..config import BrickmapConfig, GridConfig, RenderConfig
    from .scaling import init_distributed, run_scaling_benchmark

    if args.distributed:
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
    cfg = BrickmapConfig(
        grid=GridConfig(grid_size=args.world, grid_height=args.world_height),
        render=RenderConfig(width=args.width, height=args.height,
                            max_bounces=args.bounces,
                            max_top_steps=args.max_steps),
    )
    sc = _build_world(args, cfg)
    counts = [int(c) for c in args.devices.split(",")] if args.devices \
        else None
    out = run_scaling_benchmark(
        sc, cfg, args.width, args.height, device_counts=counts,
        waves=args.waves, inverse_rays=args.inverse_rays,
        skip_inverse=args.skip_inverse)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="brickmap_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="path-trace a world to PNG")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--width", type=int, default=960)
    pr.add_argument("--height", type=int, default=540)
    pr.add_argument("--spp", type=int, default=8)
    pr.add_argument("--bounces", type=int, default=3)
    pr.add_argument("--world", type=int, default=1024)
    pr.add_argument("--world-height", type=int, default=256)
    pr.add_argument("--max-steps", type=int, default=512)
    pr.add_argument("--camera", type=float, nargs=3,
                    default=[128.0, 128.0, 180.0])
    pr.add_argument("--look", type=float, nargs=3,
                    default=[512.0, 512.0, 80.0])
    pr.add_argument("--angles", type=float, nargs=2, default=None,
                    help="yaw pitch instead of --look")
    pr.add_argument("--sun", type=float, nargs=2, default=[0.05, 0.1])
    pr.add_argument("--focal-distance", type=float, default=1.0)
    pr.add_argument("--lens-radius", type=float, default=0.0)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--load", default=None)
    pr.add_argument("--save-scene", default=None)
    pr.add_argument("--metrics", default=None)
    pr.add_argument("--profile", default=None,
                    help="capture a jax.profiler trace into this directory "
                         "(view with tensorboard/xprof)")
    pr.add_argument("--streaming", action="store_true",
                    help="start with all bricks unloaded and stream residency "
                         "from per-wave requests (reference C6-C8 pipeline)")
    pr.add_argument("--preview-every", type=int, default=0,
                    help="write the progressive image to --out every N waves")
    pr.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live progressive preview + stats over HTTP "
                         "on PORT (the reference's interactive window, "
                         "main.cpp:26-190, as a browser view with WASD fly-"
                         "camera input; 0 = any port)")
    pr.add_argument("--serve-host", default="127.0.0.1",
                    help="bind address for --serve (default loopback only; "
                         "set 0.0.0.0 to expose externally)")
    pr.add_argument("--turntable", type=int, default=0,
                    help="render N frames orbiting --look (accumulation "
                         "resets per camera move); frames saved as "
                         "out_###.png")
    pr.add_argument("--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="9-viewpoint scripted benchmark")
    pb.add_argument("--width", type=int, default=1920)
    pb.add_argument("--height", type=int, default=1080)
    pb.add_argument("--bounces", type=int, default=3)
    pb.add_argument("--world", type=int, default=1024)
    pb.add_argument("--world-height", type=int, default=256)
    pb.add_argument("--max-steps", type=int, default=512)
    pb.add_argument("--waves", type=int, default=2)
    pb.add_argument("--load", default=None)
    pb.add_argument("--save-scene", default=None)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("inverse", help="inverse-rendering optimization demo")
    pi.add_argument("--grid", type=int, default=24)
    pi.add_argument("--rays", type=int, default=4096)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=0.05)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--sparse", action="store_true",
                    help="optimize the sparse brick-pool fields of a "
                         "terrain world (config 5) instead of a dense grid")
    pi.add_argument("--world", type=int, default=256,
                    help="terrain world size for --sparse")
    pi.add_argument("--world-height", type=int, default=128)
    pi.set_defaults(fn=cmd_inverse)

    pn = sub.add_parser("info", help="scene statistics")
    pn.add_argument("load")
    pn.set_defaults(fn=cmd_info)

    ps = sub.add_parser(
        "scaling", help="data-parallel scaling-efficiency benchmark "
        "(BASELINE >=80% target) over 1/2/4/.../D-device meshes")
    ps.add_argument("--width", type=int, default=512)
    ps.add_argument("--height", type=int, default=288)
    ps.add_argument("--bounces", type=int, default=3)
    ps.add_argument("--world", type=int, default=512)
    ps.add_argument("--world-height", type=int, default=128)
    ps.add_argument("--max-steps", type=int, default=512)
    ps.add_argument("--waves", type=int, default=2)
    ps.add_argument("--devices", default=None,
                    help="comma-separated device counts (default 1,2,4,..,D)")
    ps.add_argument("--inverse-rays", type=int, default=65536)
    ps.add_argument("--skip-inverse", action="store_true")
    ps.add_argument("--load", default=None)
    ps.add_argument("--save-scene", default=None)
    ps.add_argument("--distributed", action="store_true",
                    help="call jax.distributed.initialize first (multi-host)")
    ps.add_argument("--coordinator", default=None,
                    help="coordinator address host:port for --distributed")
    ps.add_argument("--num-processes", type=int, default=None)
    ps.add_argument("--process-id", type=int, default=None)
    ps.set_defaults(fn=cmd_scaling)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
