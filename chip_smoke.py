#!/usr/bin/env python3
"""Prove on the GPU that the renderer and the sparse inverse step run.

    python chip_smoke.py                # one card: phases 1-5
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Phases, in order, each through the entry points a user calls, at full size:

1. device: fails unless JAX's first device is a GPU; prints the card's name
   and power limit, the JAX version and the compile-cache directory;
2. kernel parity at real widths: the Triton march kernel against the XLA
   traversal on ~1M primary rays of views 0 and 3 of the full 4096^2x512
   world, its record mode against the XLA recorder, the replay's gather
   against a compare-select reference;
3. forward: ``render_wave`` at 1920x1080, 3 bounces, views 0 and 3, with the
   kernel and with the XLA traversal (view 3's camera is inside the
   terrain: a black image whose rays all end at once);
4. streaming: ``StreamingScene`` cold start on the full world;
5. inverse: the ``inverse --sparse`` CLI loop on the 1024^2x256 world, and one
   ``l2_loss_and_grads_sparse`` step over a 1080p frame of the full world.

``--four-cards`` runs only ``render_wave_sharded`` and
``inverse_train_step_sparse`` on four cards against one card.  Any failure
raises; the last line is a JSON object only when every phase passed.  Images
go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import time

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
# Parity tolerances of the march kernel against the XLA traversal.  Both
# run the same float32 arithmetic, but the GPU compilers may fuse a multiply
# and an add differently, which can flip a DDA step at an exact tie between
# two axes: at most TIE_BUDGET of the rays may differ in hit, normal or
# request, and t may differ by T_RTOL relative where both hit.
TIE_BUDGET = 1e-5
T_RTOL = 1e-5
# Sizes of each phase (a rehearsal on the CPU may shrink them).
SIZES = dict(parity_side=1024, record_rays=65536, frame=(1920, 1080),
             stream_frame=(960, 540), cli_world=(1024, 256),
             cli_rays=65536, sharded_world=(1024, 256), sharded_rays=65536)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peak_bytes() -> int:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def timed(fn):
    """(result, seconds) of ``fn()`` waited for with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's first device is "
                         f"{dev.platform}")
    from brickmap_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log(f"[device] {card_line()}")
    log(f"[device] jax {jax.__version__}, {len(jax.devices())} x "
        f"{dev.device_kind}, compile cache {cache}")
    return dev


# ---------------------------------------------------------------------------
# Shared set-up
# ---------------------------------------------------------------------------

def make_world(grid):
    import jax
    import jax.numpy as jnp

    from brickmap_tpu import scene as scene_mod

    t0 = time.perf_counter()
    sc = scene_mod.generate_terrain_scene(grid)
    dev = jax.block_until_ready(jax.tree.map(jnp.asarray, sc))
    log(f"[setup] world {grid.grid_size}^2x{grid.grid_height}: "
        f"{sc.pool_words.shape[0]} bricks, generated and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    return sc, dev


def view(grid, v, width: int, height: int):
    """Camera arrays, brick position and primary rays of viewpoint ``v``
    (an index of the benchmark's viewpoints, or a Camera)."""
    import jax
    import jax.numpy as jnp

    from brickmap_tpu.app.benchmark import SUN_POSITION, benchmark_cameras
    from brickmap_tpu.ops import sunsky as ss
    from brickmap_tpu.render import pathtrace
    from brickmap_tpu.render.camera import primary_rays_from_arrays

    cam = benchmark_cameras(grid.grid_size / 4096.0)[v] \
        if isinstance(v, int) else v
    sun = ss.sun_direction_from_position(jnp.asarray(SUN_POSITION))
    arrays = pathtrace.camera_arrays_for(cam, sun, width, height)
    o, d = primary_rays_from_arrays(
        jax.random.PRNGKey(0), arrays,
        jnp.arange(width * height, dtype=jnp.int32), width, height)
    return arrays, jnp.asarray(cam.brick_position, jnp.int32), o, d


# ---------------------------------------------------------------------------
# Phase 2: kernel parity at real widths
# ---------------------------------------------------------------------------

def compare_select(rows2, lin2):
    """Plain reference of the replay's gather: one compare-select sum per
    visited voxel over the row (what a per-lane gather is made of without
    native gathers)."""
    import jax.numpy as jnp

    cs, nvox = lin2.shape
    nv = rows2.shape[1] // 4
    r = rows2.reshape(cs, 4, nv)
    vox = jnp.arange(nv, dtype=jnp.int32)
    cols = [jnp.sum(jnp.where(lin2[:, None, j, None] == vox, r, 0.0), axis=2)
            for j in range(nvox)]
    return jnp.stack(cols, axis=2).reshape(cs, 4 * nvox)


def phase_parity(grid, scene):
    import jax
    import jax.numpy as jnp

    from brickmap_tpu.diff.sparse import _gather_visited
    from brickmap_tpu.ops.record import record_segments_xla
    from brickmap_tpu.ops.traverse import trace_rays
    from brickmap_tpu.pallas.march import (record_segments_kernel,
                                           trace_rays_kernel)
    from brickmap_tpu.render.pathtrace import trace_budget
    from brickmap_tpu.config import BrickmapConfig

    budget = trace_budget(BrickmapConfig(grid=grid))
    w = h = SIZES["parity_side"]
    for v in (0, 3):
        _, cam_brick, o, d = view(grid, v, w, h)
        args = (o, d, scene.index_volume, scene.pool_words, scene.pool_base,
                cam_brick)
        kern = trace_rays_kernel.lower(*args, grid,
                                       max_iters=budget).compile()
        jax.block_until_ready(kern(*args))
        res, tk = timed(lambda: kern(*args))
        jax.block_until_ready(trace_rays(*args, grid, max_iters=budget))
        ref, tx = timed(lambda: trace_rays(*args, grid, max_iters=budget))
        n = w * h
        differ = np.zeros(n, bool)
        for k in ("hit", "normal", "request", "request_pos", "exhausted"):
            a, b = np.asarray(res[k]), np.asarray(ref[k])
            differ |= (a != b).reshape(n, -1).any(1)
        both = np.asarray(res["hit"]) & np.asarray(ref["hit"])
        ta, tb = np.asarray(res["t"])[both], np.asarray(ref["t"])[both]
        rel = float((np.abs(ta - tb) / np.maximum(np.abs(tb), 1.0)).max(
            initial=0.0))
        log(f"[parity] view {v}: {n} rays, {int(differ.sum())} differ, "
            f"t rel err max {rel:.3g}, hit fraction "
            f"{float(np.asarray(res['hit']).mean()):.3f}, "
            f"{int(np.asarray(res['exhausted']).sum())} exhausted; "
            f"kernel {tk * 1e3:.1f} ms vs XLA {tx * 1e3:.1f} ms")
        assert differ.sum() <= TIE_BUDGET * n, "kernel differs from XLA"
        assert rel <= T_RTOL, "kernel t differs from XLA"
        assert not np.asarray(res["exhausted"]).any()
        if v == 0:
            log(f"[parity] kernel memory_analysis: "
                f"{kern.memory_analysis()}")

        m = SIZES["record_rays"]
        rargs = (o[:m], d[:m], scene.index_volume, scene.pool_base, grid)
        rk = record_segments_kernel(*rargs, k_segments=8)
        rx = record_segments_xla(*rargs, k_segments=8)
        for k in ("cells", "count", "slot", "ncode", "nd", "exhausted"):
            np.testing.assert_array_equal(np.asarray(rk[k]),
                                          np.asarray(rx[k]), err_msg=k)
        log(f"[parity] view {v}: recorder on {m} rays: kernel == XLA "
            f"(cells, count, slot, ncode, nd), "
            f"{int(np.asarray(rk['count']).sum())} segments")

    rng = np.random.default_rng(0)
    rows = jnp.asarray(rng.standard_normal((16384, 4 * 512), np.float32))
    lin = jnp.asarray(rng.integers(-1, 512, (16384, 22), np.int32))
    got = jax.jit(_gather_visited)(rows, lin)
    want = jax.jit(compare_select)(rows, lin)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    log("[parity] replay gather == compare-select on [16384, 2048] rows x 22 "
        "voxels")


# ---------------------------------------------------------------------------
# Phase 3: forward
# ---------------------------------------------------------------------------

def render_waves(scene, cfg, arrays, cam_brick, key, waves: int = 2):
    """One warm-up and ``waves`` timed waves; returns (Mrays/s, film,
    exhausted rays)."""
    import jax

    from brickmap_tpu.render import pathtrace

    w, h = cfg.render.width, cfg.render.height
    film = pathtrace.film_init(w, h)
    rgb, count, req = jax.block_until_ready(pathtrace.render_wave(
        jax.random.fold_in(key, 99), scene, arrays, cam_brick, cfg, w, h,
        retry_on_overflow=False))
    exhausted = int(req["exhausted_rays"])
    film = pathtrace.film_add(film, rgb, count)
    t0 = time.perf_counter()
    outs = [pathtrace.render_wave(jax.random.fold_in(key, i), scene, arrays,
                                  cam_brick, cfg, w, h,
                                  retry_on_overflow=False)
            for i in range(waves)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    rays = sum(int(r["traced_rays"]) for _, _, r in outs)
    exhausted += sum(int(r["exhausted_rays"]) for _, _, r in outs)
    for rgb, count, _ in outs:
        film = pathtrace.film_add(film, rgb, count)
    return rays / dt / 1e6, film, exhausted


def phase_forward(grid, scene, card: str):
    import dataclasses

    import jax

    from brickmap_tpu.config import BrickmapConfig, RenderConfig
    from brickmap_tpu.render import pathtrace
    from brickmap_tpu.utils.image import write_png

    w, h = SIZES["frame"]
    cfg = BrickmapConfig(grid=grid, render=RenderConfig(width=w, height=h))
    arrays, cam_brick, _, _ = view(grid, 0, w, h)
    st = pathtrace._primary_state(jax.random.PRNGKey(0), arrays, cfg, w, h)
    step = pathtrace._trace_stage_ladder.lower(st, scene, cam_brick,
                                               cfg).compile()
    log(f"[forward] wave trace step memory_analysis: "
        f"{step.memory_analysis()}")
    os.makedirs(OUT, exist_ok=True)
    for v in (0, 3):
        arrays, cam_brick, _, _ = view(grid, v, w, h)
        key = jax.random.PRNGKey(10 + v)
        mk, film, exh = render_waves(scene, cfg, arrays, cam_brick, key)
        xcfg = cfg.replace(render=dataclasses.replace(cfg.render,
                                                      traversal="xla"))
        mx, _, exh_x = render_waves(scene, xcfg, arrays, cam_brick, key)
        img = np.asarray(pathtrace.tonemap(film, w, h))
        write_png(os.path.join(OUT, f"smoke_view{v}.png"), img)
        log(f"[forward] view {v} {w}x{h} 3 bounces: kernel {mk:.1f} Mrays/s,"
            f" XLA traversal {mx:.2f} Mrays/s ({card})")
        assert exh == 0 and exh_x == 0, f"exhausted rays: {exh}, {exh_x}"
        assert np.isfinite(img).all()
        if v == 0:
            # Sky and ground (tests/test_render.py's check).  View 3's
            # camera sits inside the terrain (every primary ray starts in
            # a solid brick), so its image is black by construction.
            assert img[: h // 4].mean() > 0.0 and img.sum() > 0
    log(f"[forward] peak_bytes_in_use {peak_bytes()}")


# ---------------------------------------------------------------------------
# Phase 4: streaming
# ---------------------------------------------------------------------------

def phase_streaming(grid, sc):
    import jax

    from brickmap_tpu.config import BrickmapConfig, RenderConfig
    from brickmap_tpu.render import pathtrace
    from brickmap_tpu.stream import StreamingScene, pull_requests

    w, h = SIZES["stream_frame"]
    cfg = BrickmapConfig(grid=grid, render=RenderConfig(width=w, height=h))
    t0 = time.perf_counter()
    mgr = StreamingScene(sc, grid, starting_capacity=256)
    log(f"[streaming] cold start in {time.perf_counter() - t0:.1f} s")
    arrays, cam_brick, _, _ = view(grid, 0, w, h)
    resident = [0]
    exhausted = 0
    t0 = time.perf_counter()
    for i in range(8):
        rgb, count, req = jax.block_until_ready(pathtrace.render_wave(
            jax.random.PRNGKey(i), mgr.device_scene(), arrays, cam_brick,
            cfg, w, h))
        exhausted += int(req["exhausted_rays"])
        got = pull_requests(req, mgr.queue_size)
        if got:
            mgr.process_requests(got)
        resident.append(int(mgr.dump().sum()))
    log(f"[streaming] 8 waves {w}x{h} in {time.perf_counter() - t0:.1f} s: "
        f"resident bricks {resident[1:]}, {mgr.total_uploaded} uploaded, "
        f"{exhausted} exhausted")
    assert mgr.total_uploaded > 0 and resident[-1] > resident[1] > 0
    assert exhausted == 0


# ---------------------------------------------------------------------------
# Phase 5: inverse
# ---------------------------------------------------------------------------

def phase_inverse(grid, sc, scene):
    import jax
    import jax.numpy as jnp

    from brickmap_tpu.app import cli
    from brickmap_tpu.diff.sparse import (active_brick_fields,
                                          l2_loss_and_grads_sparse,
                                          record_segments)

    buf = io.StringIO()
    t0 = time.perf_counter()
    cw, ch = SIZES["cli_world"]
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["inverse", "--sparse", "--world", str(cw),
                       "--world-height", str(ch), "--rays",
                       str(SIZES["cli_rays"]), "--steps", "20"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[inverse] CLI {cw}^2x{ch}, {SIZES['cli_rays']} rays, 20 Adam "
        f"steps: loss "
        f"{out['loss_first']:.6g} -> {out['loss_final']:.6g} in "
        f"{time.perf_counter() - t0:.1f} s")
    assert rc == 0 and np.isfinite(out["loss_final"])
    assert out["loss_final"] < out["loss_first"]

    w, h = SIZES["frame"]
    _, _, o, d = view(grid, 0, w, h)
    n = w * h
    t0 = time.perf_counter()
    slots = record_segments(o, d, scene, grid, k_segments=8)["slot"]
    cellmap, occ, alb = active_brick_fields(sc, grid, slots)
    bg = jnp.zeros((n, 3), jnp.float32)
    tgt = jnp.full((n, 3), 0.4, jnp.float32)
    args = (o, d, scene, jnp.asarray(cellmap), jnp.asarray(occ * 0.8),
            jnp.asarray(alb * 0.6), bg, tgt, grid)
    log(f"[inverse] full world, view 0, {n} rays: {occ.shape[0]} active "
        f"bricks ({time.perf_counter() - t0:.1f} s set-up)")
    jax.block_until_ready(l2_loss_and_grads_sparse(*args, k_segments=8))
    (loss, (docc, dalb)), dt = timed(
        lambda: l2_loss_and_grads_sparse(*args, k_segments=8))
    log(f"[inverse] full-world sparse step: {dt * 1e3:.0f} ms "
        f"({n / dt / 1e6:.2f} Mrays/s), loss {float(loss):.6g}, "
        f"peak_bytes_in_use {peak_bytes()}")
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(docc)).all()
    assert np.isfinite(np.asarray(dalb)).all()
    assert np.abs(np.asarray(docc)).sum() > 0


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def phase_four_cards(card: str):
    import jax
    import jax.numpy as jnp

    from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig
    from brickmap_tpu.diff.sparse import (cell_pool_map,
                                          l2_loss_and_grads_sparse,
                                          pool_fields_from_bitmask)
    from brickmap_tpu.parallel.render import (inverse_train_step_sparse,
                                              make_mesh, render_wave_sharded,
                                              replicate, shard_rays)
    from brickmap_tpu.render import pathtrace
    from brickmap_tpu.render.camera import Camera

    assert len(jax.devices()) >= 4, "--four-cards needs four cards"
    mesh = make_mesh(4)
    gs, gh = SIZES["sharded_world"]
    grid = GridConfig(grid_size=gs, grid_height=gh)
    sc, scene = make_world(grid)
    w, h = SIZES["frame"]
    cfg = BrickmapConfig(grid=grid, render=RenderConfig(width=w, height=h))
    # View 0 scaled to this world would sit below its terrain: look from
    # near the top of the world, with view 0's heading, at sky and ground.
    cam = Camera.from_angles((0.125 * gs, 0.125 * gs, gh - 6.0),
                             -61863.5, -0.35)
    arrays, cam_brick, _, _ = view(grid, cam, w, h)
    scene4 = replicate(mesh, scene)

    def mean_radiance(fn, keys):
        jax.block_until_ready(fn(jax.random.PRNGKey(999)))
        t0 = time.perf_counter()
        outs = [fn(jax.random.PRNGKey(k)) for k in keys]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        rays = sum(int(r["traced_rays"]) for _, _, r in outs)
        exh = sum(int(r["exhausted_rays"]) for _, _, r in outs)
        return (float(np.mean([np.asarray(rgb).mean() for rgb, _, _ in outs])),
                rays / dt / 1e6, exh)

    m4, r4, e4 = mean_radiance(lambda k: render_wave_sharded(
        mesh, k, scene4, arrays, cam_brick, cfg, w, h), range(3))
    m1, r1, e1 = mean_radiance(lambda k: pathtrace.render_wave(
        k, scene, arrays, cam_brick, cfg, w, h), range(100, 103))
    assert m1 > 0.0, "the single-card image is black"
    rel = abs(m4 - m1) / m1
    log(f"[four-cards] render_wave_sharded {w}x{h} on 4 cards: {r4:.1f} "
        f"Mrays/s, mean radiance {m4:.6g}; one card {r1:.1f} Mrays/s, "
        f"{m1:.6g}; relative difference {rel:.3g}; {r4 / r1:.2f}x one card "
        f"({card})")
    assert e4 == 0 and e1 == 0
    assert rel < 0.02, "sharded and single-card images disagree"

    cellmap = cell_pool_map(sc, grid)
    occ, alb = pool_fields_from_bitmask(sc)
    rng = np.random.default_rng(0)
    n = SIZES["sharded_rays"]
    ox = rng.uniform(0.05 * gs, 0.95 * gs, n).astype(np.float32)
    oy = rng.uniform(0.05 * gs, 0.95 * gs, n).astype(np.float32)
    origins = np.stack([ox, oy, np.full(n, gh - 2.0, np.float32)], 1)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.7
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bg = np.zeros((n, 3), np.float32)
    tgt = np.full((n, 3), 0.4, np.float32)
    fields = (jnp.asarray(cellmap), jnp.asarray(occ * 0.6),
              jnp.asarray(alb * 0.5))
    rays = tuple(map(jnp.asarray, (origins, dirs, bg, tgt)))
    loss1, (docc1, dalb1) = l2_loss_and_grads_sparse(
        rays[0], rays[1], scene, *fields, rays[2], rays[3], grid,
        k_segments=8)
    o4, d4, bg4, tgt4 = shard_rays(mesh, rays)
    cm4, occ4, alb4 = replicate(mesh, fields)
    def step4():
        return inverse_train_step_sparse(mesh, o4, d4, scene4, cm4, occ4,
                                         alb4, bg4, tgt4, grid, k_segments=8)

    jax.block_until_ready(step4())
    (loss4, docc4, dalb4), dt = timed(step4)
    gmax = max(float(np.abs(np.asarray(docc1)).max()),
               float(np.abs(np.asarray(dalb1)).max()))
    log(f"[four-cards] inverse_train_step_sparse, {n} rays: loss "
        f"{float(loss4):.8g} vs one card {float(loss1):.8g}, step "
        f"{dt * 1e3:.0f} ms")
    # The four-card step sums per-shard partial gradients in another order
    # (per-shard scans, then an all-reduce), so float32 sums round
    # differently: loss to 1e-5 relative, gradients to 1e-3 relative plus
    # 1e-6 of the largest gradient.
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-5)
    for a, b in ((docc4, docc1), (dalb4, dalb1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-6 * gmax)
    log("[four-cards] gradients match one card")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args()

    t_start = time.perf_counter()
    dev = phase_device()
    import jax

    card = card_line().replace("\n", " | ")
    if args.four_cards:
        phase_four_cards(card)
    else:
        from brickmap_tpu.config import GridConfig

        grid = GridConfig()
        sc, scene = make_world(grid)
        phase_parity(grid, scene)
        phase_forward(grid, scene, card)
        phase_streaming(grid, sc)
        phase_inverse(grid, sc, scene)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.0f} s "
        f"on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
