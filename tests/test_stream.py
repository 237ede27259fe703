"""Streaming residency: request -> upload round trip, growth, invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import GridConfig
from brickmap_tpu.ops.traverse import trace_rays
from brickmap_tpu.stream import StreamingScene

GRID = GridConfig(grid_size=128, grid_height=128)
CAM = np.zeros(3, np.int64)


@pytest.fixture(scope="module")
def truth():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    return scene_mod.scene_from_dense(dense, GRID)


def trace(dev_scene, origins, directions):
    return trace_rays(
        jnp.asarray(origins, jnp.float32), jnp.asarray(directions, jnp.float32),
        dev_scene.index_volume, dev_scene.pool_words, dev_scene.pool_base,
        jnp.asarray(CAM, jnp.int32), GRID, max_iters=512)


def test_round_trip_request_then_resident(truth):
    mgr = StreamingScene(truth, GRID)
    origins = np.array([[0.5, 64.0, 30.0]], np.float32)
    directions = np.array([[1.0, 0.0, 0.0]], np.float32)

    # Frame N: coarse hit + request (voxel.cuh:228-245 semantics).
    res = trace(mgr.device_scene(), origins, directions)
    assert bool(res["hit"][0]) and bool(res["request"][0])
    req = [tuple(np.asarray(res["request_pos"])[0])]
    assert mgr.process_requests(req) == 1

    # Frame N+1: brick resident -> fine hit at the voxel surface, no request.
    res2 = trace(mgr.device_scene(), origins, directions)
    assert bool(res2["hit"][0]) and not bool(res2["request"][0])
    assert abs(float(res2["t"][0]) - 31.5) < 1e-3


def test_progressive_residency_converges_to_truth(truth, rng):
    """Repeated render->request->upload cycles reach the full-residency image."""
    mgr = StreamingScene(truth, GRID, queue_size=64)
    n = 256
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([64, 64, 32]) - dirs * 100).astype(np.float32)

    want = trace(scene_mod.VoxelScene(
        jnp.asarray(truth.index_volume), jnp.asarray(truth.pool_words),
        jnp.asarray(truth.pool_base)), origins, dirs)

    for it in range(50):
        res = trace(mgr.device_scene(), origins, dirs)
        mask = np.asarray(res["request"])
        if not mask.any():
            break
        reqs = map(tuple, np.asarray(res["request_pos"])[mask])
        if mgr.process_requests(reqs) == 0:
            break
    res = trace(mgr.device_scene(), origins, dirs)
    np.testing.assert_array_equal(np.asarray(res["hit"]),
                                  np.asarray(want["hit"]))
    np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(want["t"]),
                               atol=1e-3)
    assert not np.asarray(res["request"]).any()


def test_pool_growth_and_dump(truth, rng):
    mgr = StreamingScene(truth, GRID, starting_capacity=4)
    # Request 40 distinct surface bricks of the box top (z brick = 5).
    reqs = [(x, y, 5) for x in range(4, 12) for y in range(4, 9)]
    done = mgr.process_requests(reqs)
    assert done == 40
    assert mgr.capacity[0] >= 40  # grew beyond the starting 4 (pow-2)
    assert mgr.dump()[0] == 40
    # All uploaded bricks readable at correct slots.
    dev = mgr.device_scene()
    iv = np.asarray(dev.index_volume)
    for x, y, z in reqs[:5]:
        w = iv[z, y, x]
        assert w & 0x80000000
        slot = int(w & 0xFFF)
        got = np.asarray(dev.pool_words)[int(np.asarray(dev.pool_base)[0]) + slot]
        tw = int(np.asarray(truth.index_volume)[z, y, x])
        texp = np.asarray(truth.pool_words)[
            int(np.asarray(truth.pool_base)[0]) + (tw & 0xFFF)]
        np.testing.assert_array_equal(got, texp)


def test_queue_cap_drops_overflow(truth):
    mgr = StreamingScene(truth, GRID, queue_size=8)
    reqs = [(x, y, 5) for x in range(4, 12) for y in range(4, 9)]  # 40 bricks
    assert mgr.process_requests(reqs) == 8
    assert mgr.total_dropped == 32
    # Retry services the rest (8 per step).
    total = 8
    for _ in range(10):
        total += mgr.process_requests(reqs)
    assert total == 40


def test_surface_only_requests_on_terrain(rng):
    """README.md:7 invariant: only surface bricks ever get requested from
    top-down views (interior bricks are occluded at request time)."""
    grid = GridConfig(grid_size=128, grid_height=128)
    truth = scene_mod.generate_terrain_scene(grid, feature_scale=64.0)
    mgr = StreamingScene(truth, grid)
    n = 400
    xs = rng.uniform(5, 123, n).astype(np.float32)
    ys = rng.uniform(5, 123, n).astype(np.float32)
    origins = np.stack([xs, ys, np.full(n, 120.0, np.float32)], 1)
    dirs = np.tile(np.array([[0.01, 0.01, -1.0]], np.float32), (n, 1))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    for _ in range(30):
        res = trace(mgr.device_scene(), origins, dirs)
        mask = np.asarray(res["request"])
        if not mask.any():
            break
        mgr.process_requests(map(tuple, np.asarray(res["request_pos"])[mask]))

    # No buried brick (all six face neighbors completely solid) can ever be
    # reached by a ray, hence never requested (README.md:7 by construction).
    iv = np.asarray(mgr.device_scene().index_volume)
    loaded = np.argwhere((iv & 0x80000000) != 0)
    assert len(loaded) > 0
    full = (np.asarray(truth.pool_words) == 0xFFFFFFFF).all(axis=1)
    truth_iv = np.asarray(truth.index_volume)
    base = np.asarray(truth.pool_base)

    def brick_full(z, y, x):
        w = truth_iv[z, y, x]
        if not (w & 0x80000000):
            return False
        s = GRID.supergrid_cell_size
        sc = (x // s + (y // s) * grid.supergrid_xy
              + (z // s) * grid.supergrid_xy ** 2)
        return bool(full[base[sc] + (int(w) & 0xFFF)])

    cz, cyx = truth_iv.shape[0], truth_iv.shape[1]
    for z, y, x in loaded:
        if (0 < z < cz - 1 and 0 < y < cyx - 1 and 0 < x < cyx - 1):
            buried = all(brick_full(*p) for p in [
                (z - 1, y, x), (z + 1, y, x), (z, y - 1, x),
                (z, y + 1, x), (z, y, x - 1), (z, y, x + 1)])
            assert not buried, f"buried brick {(x, y, z)} became resident"


def ktrace(dev_scene, origins, directions):
    """The march kernel (interpret mode) over a streaming device scene."""
    from brickmap_tpu.pallas.march import trace_rays_kernel

    return trace_rays_kernel(
        jnp.asarray(origins, jnp.float32),
        jnp.asarray(directions, jnp.float32),
        dev_scene.index_volume, dev_scene.pool_words, dev_scene.pool_base,
        jnp.asarray(CAM, jnp.int32), GRID, max_iters=512, block=32,
        interpret=True)


def test_paged_streaming_round_trip(truth):
    """The march kernel sees newly resident bricks after the upload
    scatters (kernel.cu:141-151's role) and agrees with the XLA path."""
    mgr = StreamingScene(truth, GRID)
    origins = np.array([[0.5, 64.0, 30.0]], np.float32)
    directions = np.array([[1.0, 0.0, 0.0]], np.float32)

    r1 = ktrace(mgr.device_scene(), origins, directions)
    assert bool(np.asarray(r1["hit"])[0])
    assert bool(np.asarray(r1["request"])[0])
    req = tuple(int(v) for v in np.asarray(r1["request_pos"])[0])
    assert mgr.process_requests([req]) == 1

    r2 = ktrace(mgr.device_scene(), origins, directions)
    assert bool(np.asarray(r2["hit"])[0])
    # Brick now resident: fine-voxel hit, no new request for that brick.
    xr = trace(mgr.device_scene(), origins, directions)
    np.testing.assert_array_equal(np.asarray(r2["t"]), np.asarray(xr["t"]))
    assert abs(float(np.asarray(r2["t"])[0]) - 31.5) < 1e-3
    np.testing.assert_array_equal(np.asarray(r2["request"]),
                                  np.asarray(xr["request"]))


def test_paged_streaming_many_waves(truth, rng):
    """Multi-wave streaming through the march kernel converges to the
    fully-resident image."""
    mgr = StreamingScene(truth, GRID, queue_size=64)
    n = 128
    origins = rng.uniform([0, 0, 110], [128, 128, 125], (n, 3)).astype(
        np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions[:, 2] = -np.abs(directions[:, 2]) - 0.5
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)

    for _ in range(40):
        res = ktrace(mgr.device_scene(), origins, directions)
        mask = np.asarray(res["request"])
        if not mask.any():
            break
        reqs = [tuple(int(v) for v in p)
                for p in np.asarray(res["request_pos"])[mask]]
        if mgr.process_requests(reqs) == 0:
            break

    resident = ktrace(mgr.device_scene(), origins, directions)
    full = ktrace(jax.tree.map(jnp.asarray, truth), origins, directions)
    np.testing.assert_array_equal(np.asarray(resident["hit"]),
                                  np.asarray(full["hit"]))
    np.testing.assert_allclose(np.asarray(resident["t"]),
                               np.asarray(full["t"]), atol=1e-3)


def test_streaming_parity_non_default_grid(rng):
    """Streaming on a supergrid_cell_size=8 world converges to the freshly-built-scene image — the
    request/scatter side must honor GridConfig, not assume the default."""
    grid8 = GridConfig(grid_size=64, grid_height=64, supergrid_cell_size=8)
    dense = np.zeros((64, 64, 64), bool)
    dense[8:24, 16:48, 16:48] = rng.random((16, 32, 32)) < 0.6
    truth8 = scene_mod.scene_from_dense(dense, grid8)

    n = 128
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([32, 32, 16]) - dirs * 60).astype(np.float32)

    def trace8(dev):
        return trace_rays(
            jnp.asarray(origins), jnp.asarray(dirs), dev.index_volume,
            dev.pool_words, dev.pool_base, jnp.asarray(CAM, jnp.int32),
            grid8, max_iters=512)

    want = trace8(scene_mod.VoxelScene(
        jnp.asarray(truth8.index_volume), jnp.asarray(truth8.pool_words),
        jnp.asarray(truth8.pool_base)))

    mgr = StreamingScene(truth8, grid8, queue_size=64)
    for _ in range(50):
        res = trace8(mgr.device_scene())
        mask = np.asarray(res["request"])
        if not mask.any():
            break
        if mgr.process_requests(
                map(tuple, np.asarray(res["request_pos"])[mask])) == 0:
            break
    res = trace8(mgr.device_scene())
    np.testing.assert_array_equal(np.asarray(res["hit"]),
                                  np.asarray(want["hit"]))
    np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(want["t"]),
                               atol=1e-3)
    assert not np.asarray(res["request"]).any()


def test_surface_only_invariant_reported(truth, rng):
    """After request-driven convergence, every loaded brick is a surface
    brick (the reference's locality invariant, README.md:7), and
    surface_stats reports it."""
    mgr = StreamingScene(truth, GRID, queue_size=64)
    n = 256
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([64, 64, 32]) - dirs * 100).astype(np.float32)
    for _ in range(50):
        res = trace(mgr.device_scene(), origins, dirs)
        mask = np.asarray(res["request"])
        if not mask.any():
            break
        if mgr.process_requests(
                map(tuple, np.asarray(res["request_pos"])[mask])) == 0:
            break
    s = mgr.surface_stats()
    assert s["loaded_total"] > 0
    assert s["loaded_unreachable"] == 0, s
    # The solid box has FULL bricks everywhere except its shell, so here
    # reachable == air-surface and every load is an air-surface brick.
    assert s["loaded_surface"] == s["loaded_total"]
    assert s["surface_total"] < s["nonempty_total"]  # box has an interior


def test_pull_requests_matches_full_pull(rng):
    """Device-compacted request pull == the full mask/pos host pull, and the
    overflow cap drops (not corrupts) the tail."""
    from brickmap_tpu.stream import pull_requests

    n = 8192
    mask = rng.random(n) < 0.01
    pos = rng.integers(0, 1000, (n, 3)).astype(np.int32)
    req = {"mask": jnp.asarray(mask), "pos": jnp.asarray(pos)}
    got = pull_requests(req, queue_size=1024)
    want = [tuple(int(v) for v in r) for r in pos[mask]]
    assert got == want

    # Overflow: > 4*queue_size requests -> first cap rows, in lane order.
    mask2 = np.ones(n, bool)
    req2 = {"mask": jnp.asarray(mask2), "pos": jnp.asarray(pos)}
    got2 = pull_requests(req2, queue_size=16)
    assert len(got2) == 64
    assert got2 == [tuple(int(v) for v in r) for r in pos[:64]]

    # Empty mask -> empty list.
    req3 = {"mask": jnp.zeros(n, bool), "pos": jnp.asarray(pos)}
    assert pull_requests(req3, queue_size=1024) == []
