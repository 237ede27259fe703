"""Scaling-efficiency harness (BASELINE: >=80% rays/s scaling efficiency at
1 chip / 1 host / N hosts; SURVEY.md section 2 P6-P8).

The reference is single-process/single-GPU — there is nothing to port; this
measures this build's data-parallel scaling so the BASELINE target is an
actual number rather than an untested claim:

* **forward**: :func:`brickmap_tpu.parallel.render.render_wave_sharded`
  sample waves on meshes of 1/2/4/.../D devices of the current process(es);
* **inverse**: :func:`...inverse_train_step_sparse` gradient steps (recorder
  per shard, grads pmean'd across the mesh).

Efficiency_d = (rays_s[d] / rays_s[1]) / d.  The same harness runs unchanged
on the virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8
— numbers are meaningless there, the plumbing is what's validated), the
cards of one host, and several processes after :func:`init_distributed`.
Each timed step ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["init_distributed", "run_scaling_benchmark"]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Several-process entry point: ``jax.distributed.initialize`` (SURVEY
    P8).

    Pass all three arguments (the coordinator as ``host:port``); nothing
    detects a cluster.  Call once per process before any other JAX API;
    afterwards ``jax.devices()`` spans every process and the existing
    ``shard_map`` paths run unchanged.
    """
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def _device_counts(max_devices: int) -> list[int]:
    d, counts = 1, []
    while d <= max_devices:
        counts.append(d)
        d *= 2
    if counts[-1] != max_devices:
        counts.append(max_devices)
    return counts


def run_scaling_benchmark(sc, cfg, width: int, height: int,
                          device_counts: list[int] | None = None,
                          waves: int = 2, inverse_rays: int = 65536,
                          k_segments: int = 8, skip_inverse: bool = False,
                          verbose: bool = True) -> dict:
    """Measure forward and sparse-inverse rays/s on growing device meshes.

    ``sc`` is a host :class:`~brickmap_tpu.scene.VoxelScene`; it and the
    pool fields are uploaded once and replicated per mesh.  Returns
    a dict with per-device-count rays/s and efficiency percentages.
    """
    import jax
    import jax.numpy as jnp

    from ..diff.sparse import cell_pool_map, pool_fields_from_bitmask
    from ..ops import sunsky as ss
    from ..parallel.render import (
        inverse_train_step_sparse,
        make_mesh,
        render_wave_sharded,
        replicate,
        shard_rays,
    )
    from ..render import pathtrace
    from ..render.camera import Camera
    from .benchmark import SUN_POSITION, TEST_ANGLES, TEST_POSITIONS

    ndev = len(jax.devices())
    if device_counts is None:
        device_counts = _device_counts(ndev)
    device_counts = [d for d in device_counts if d <= ndev]

    grid = cfg.grid
    sc_host = jax.tree.map(np.asarray, sc)
    scale = grid.grid_size / 4096.0
    cam = Camera.from_angles(
        tuple(p * scale for p in TEST_POSITIONS[0]), *TEST_ANGLES[0])
    sun = ss.sun_direction_from_position(jnp.asarray(SUN_POSITION))
    arrays = pathtrace.camera_arrays_for(cam, sun, width, height)
    cam_brick = jnp.asarray(cam.brick_position, jnp.int32)

    inv_inputs = None
    if not skip_inverse:
        cellmap_h = cell_pool_map(sc, grid)
        occ_h, alb_h = pool_fields_from_bitmask(sc)
        rng = np.random.default_rng(0)
        n = inverse_rays - inverse_rays % ndev  # divisible by every count
        m = float(grid.grid_size)
        ox = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
        oy = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
        oz = np.full(n, grid.grid_height - 2.0, np.float32)
        dirs = rng.normal(size=(n, 3)).astype(np.float32)
        dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        inv_inputs = (np.stack([ox, oy, oz], 1), dirs,
                      np.zeros((n, 3), np.float32),
                      np.full((n, 3), 0.4, np.float32),
                      cellmap_h, occ_h, alb_h)

    rows = []
    for d in device_counts:
        mesh = make_mesh(d)
        psc = replicate(mesh, sc_host)
        row = {"devices": d}

        # Forward: sample waves, pixel-sharded.
        rgb, count, req = render_wave_sharded(
            mesh, jax.random.PRNGKey(99), psc, arrays, cam_brick, cfg,
            width, height)
        jax.block_until_ready(rgb)  # warm-up / compile
        rays = 0
        t0 = time.perf_counter()
        for i in range(waves):
            rgb, count, req = render_wave_sharded(
                mesh, jax.random.PRNGKey(i), psc, arrays, cam_brick, cfg,
                width, height)
            jax.block_until_ready(rgb)
            rays += int(req["traced_rays"])
        row["forward_rays_per_s"] = rays / (time.perf_counter() - t0)

        if inv_inputs is not None:
            origins, dirs, bg, tgt, cellmap_h, occ_h, alb_h = inv_inputs
            o_s, d_s, bg_s, tgt_s = shard_rays(
                mesh, tuple(map(jnp.asarray, (origins, dirs, bg, tgt))))
            cm_r, occ_r, alb_r = replicate(
                mesh, tuple(map(jnp.asarray, (cellmap_h, occ_h, alb_h))))

            def step():
                loss, docc, dalb = inverse_train_step_sparse(
                    mesh, o_s, d_s, psc, cm_r, occ_r, alb_r, bg_s, tgt_s,
                    grid, k_segments=k_segments)
                jax.block_until_ready(docc)

            step()  # warm-up / compile
            t0 = time.perf_counter()
            for _ in range(waves):
                step()
            row["inverse_rays_per_s"] = \
                waves * origins.shape[0] / (time.perf_counter() - t0)

        rows.append(row)
        if verbose:
            import sys

            print(f"devices {d}: " + "  ".join(
                f"{k} {v:,.0f}" for k, v in row.items() if k != "devices"),
                file=sys.stderr)

    base = rows[0]
    for row in rows:
        for k in ("forward_rays_per_s", "inverse_rays_per_s"):
            if k in row:
                row[k.replace("rays_per_s", "efficiency_pct")] = round(
                    100.0 * (row[k] / base[k]) / row["devices"], 1)
    return {
        "device_counts": device_counts,
        "rows": rows,
        "resolution": [width, height],
        "inverse_rays": 0 if skip_inverse else inv_inputs[0].shape[0],
        "platform": jax.devices()[0].platform,
        "num_processes": jax.process_count(),
    }
