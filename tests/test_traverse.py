"""Traversal: scalar oracle golden tests + vectorized-vs-oracle parity."""

import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import GridConfig
from brickmap_tpu.ops import dda_ref
from brickmap_tpu.ops.traverse import trace_rays

GRID = GridConfig(grid_size=128, grid_height=128)  # 16^3 bricks, 1 superchunk
CAM = np.array([0, 0, 0], np.int64)                # near LoD everywhere (d2 small)


@pytest.fixture(scope="module")
def box_scene():
    """A solid axis-aligned box occupying [32,96)x[32,96)x[16,48)."""
    dense = np.zeros((128, 128, 128), bool)  # [z, y, x]
    dense[16:48, 32:96, 32:96] = True
    return scene_mod.scene_from_dense(dense, GRID), dense


@pytest.fixture(scope="module")
def noise_scene():
    rng = np.random.default_rng(104)
    dense = rng.random((128, 128, 128)) < 0.015
    return scene_mod.scene_from_dense(dense, GRID), dense


def run_both(sc, origins, directions, cam=CAM, use_lod=True,
             grid=GRID):
    res = trace_rays(
        jnp.asarray(origins, jnp.float32), jnp.asarray(directions, jnp.float32),
        jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_words),
        jnp.asarray(sc.pool_base), jnp.asarray(cam, jnp.int32),
        grid, use_lod=use_lod)
    refs = [
        dda_ref.intersect_voxel(o, d, sc, grid, cam)
        for o, d in zip(origins, directions)
    ]
    return res, refs


def assert_match(res, refs, origins, directions, atol=2e-2):
    hits = np.asarray(res["hit"])
    ts = np.asarray(res["t"])
    ns = np.asarray(res["normal"])
    for i, r in enumerate(refs):
        assert bool(hits[i]) == r.hit, (
            f"ray {i}: o={origins[i]} d={directions[i]} "
            f"vec={bool(hits[i])} ref={r.hit}")
        if r.hit:
            assert abs(float(ts[i]) - r.distance) < atol, (
                f"ray {i}: t {float(ts[i])} vs {r.distance}")
            np.testing.assert_allclose(ns[i], r.normal, atol=1e-5,
                                       err_msg=f"ray {i} normal")


# ---------------------------------------------------------------------------
# Oracle golden tests (analytic)
# ---------------------------------------------------------------------------

def test_oracle_axis_hit(box_scene):
    sc, _ = box_scene
    r = dda_ref.intersect_voxel(
        np.array([0.5, 64.0, 30.0]), np.array([1.0, 0.0, 0.0]), sc, GRID, CAM)
    assert r.hit
    assert abs(r.distance - 31.5) < 1e-3  # box face at x=32
    np.testing.assert_allclose(r.normal, [-1, 0, 0], atol=1e-6)


def test_oracle_axis_miss(box_scene):
    sc, _ = box_scene
    r = dda_ref.intersect_voxel(
        np.array([0.5, 64.0, 100.0]), np.array([1.0, 0.0, 0.0]), sc, GRID, CAM)
    assert not r.hit


def test_oracle_from_outside_world(box_scene):
    sc, _ = box_scene
    # Enters world AABB from -x; entry normal then DDA to box.
    r = dda_ref.intersect_voxel(
        np.array([-50.0, 64.0, 30.0]), np.array([1.0, 0.0, 0.0]), sc, GRID, CAM)
    assert r.hit
    assert abs(r.distance - 82.0) < 1e-2  # 50 to world + 32 to box face
    np.testing.assert_allclose(r.normal, [-1, 0, 0], atol=1e-6)


def test_oracle_down_ray(box_scene):
    sc, _ = box_scene
    r = dda_ref.intersect_voxel(
        np.array([64.0, 64.0, 100.0]), np.array([0.0, 0.0, -1.0]),
        sc, GRID, CAM)
    assert r.hit
    assert abs(r.distance - 52.0) < 1e-3  # top of box at z=48
    np.testing.assert_allclose(r.normal, [0, 0, 1], atol=1e-6)


def test_oracle_inside_solid(box_scene):
    sc, _ = box_scene
    r = dda_ref.intersect_voxel(
        np.array([64.0, 64.0, 30.0]), np.array([1.0, 0.0, 0.0]), sc, GRID, CAM)
    assert r.hit
    assert r.distance == 0.0  # starting cell occupied


def test_oracle_far_lod_brick_granularity(box_scene):
    sc, _ = box_scene
    # Far camera -> hit at brick granularity (8^3 treated as one voxel).
    far_cam = np.array([10_000, 10_000, 10_000], np.int64)
    r = dda_ref.intersect_voxel(
        np.array([0.5, 64.0, 30.0]), np.array([1.0, 0.0, 0.0]),
        sc, GRID, far_cam)
    assert r.hit
    assert abs(r.distance - 31.5) < 1e-3  # box is brick-aligned: same face


def test_oracle_unloaded_requests():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    sc = scene_mod.scene_from_dense(dense, GRID, residency="streaming")
    r = dda_ref.intersect_voxel(
        np.array([0.5, 64.0, 30.0]), np.array([1.0, 0.0, 0.0]), sc, GRID, CAM)
    assert r.hit
    assert r.request == (4, 8, 3)  # brick coords of the entry face brick
    assert abs(r.distance - 31.5) < 1e-3  # coarse (brick-granular) hit


# ---------------------------------------------------------------------------
# Vectorized vs oracle
# ---------------------------------------------------------------------------

def test_vector_matches_oracle_box(box_scene, rng):
    sc, _ = box_scene
    n = 64
    origins = rng.uniform([-20, -20, -20], [148, 148, 148], (n, 3)).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    res, refs = run_both(sc, origins, directions)
    assert_match(res, refs, origins, directions)


def test_vector_matches_oracle_noise(noise_scene, rng):
    sc, _ = noise_scene
    n = 64
    origins = rng.uniform([0, 0, 0], [128, 128, 128], (n, 3)).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    res, refs = run_both(sc, origins, directions)
    assert_match(res, refs, origins, directions)


def test_vector_axis_aligned_and_degenerate(box_scene):
    sc, _ = box_scene
    origins = np.array([
        [0.5, 64.0, 30.0],    # +x hit
        [127.5, 64.0, 30.0],  # -x hit
        [64.0, 0.5, 30.0],    # +y hit
        [64.0, 64.0, 100.0],  # -z hit
        [0.5, 64.0, 100.0],   # +x miss above box
        [64.0, 64.0, 0.5],    # +z from below, hits box bottom
        [-10.0, 64.0, 30.0],  # from outside world
        [64.0, 64.0, 30.0],   # inside solid
    ], np.float32)
    directions = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1],
        [1, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 0],
    ], np.float32)
    res, refs = run_both(sc, origins, directions)
    assert_match(res, refs, origins, directions)


def test_vector_lod_distances(box_scene, rng):
    """Same rays under near/mid/far cameras must match oracle in each regime."""
    sc, _ = box_scene
    n = 32
    origins = rng.uniform([0, 0, 0], [128, 128, 128], (n, 3)).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    for cam in ([0, 0, 0], [400, 0, 0], [900, 0, 0]):
        cam = np.asarray(cam, np.int64)
        res, refs = run_both(sc, origins, directions, cam=cam)
        assert_match(res, refs, origins, directions)


def test_vector_requests_streaming(rng):
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    sc = scene_mod.scene_from_dense(dense, GRID, residency="streaming")
    origins = np.array([[0.5, 64.0, 30.0], [64.0, 64.0, 100.0]], np.float32)
    directions = np.array([[1, 0, 0], [0, 0, -1]], np.float32)
    res, refs = run_both(sc, origins, directions)
    req = np.asarray(res["request"])
    rp = np.asarray(res["request_pos"])
    for i, r in enumerate(refs):
        assert bool(req[i]) == (r.request is not None)
        if r.request is not None:
            assert tuple(rp[i]) == r.request


def test_ess_matches_no_ess(noise_scene, rng):
    """Empty-space skipping must not change results (hits/t/normals)."""
    sc, _ = noise_scene
    n = 128
    origins = rng.uniform([-10, -10, -10], [138, 138, 138], (n, 3)).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    args = (jnp.asarray(origins), jnp.asarray(directions),
            jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_words),
            jnp.asarray(sc.pool_base), jnp.asarray(CAM, jnp.int32))
    a = trace_rays(*args, GRID, use_ess=True)
    b = trace_rays(*args, GRID, use_ess=False)
    np.testing.assert_array_equal(np.asarray(a["hit"]), np.asarray(b["hit"]))
    np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(a["normal"]),
                               np.asarray(b["normal"]), atol=1e-5)
    # And strictly fewer loop iterations with skipping.
    assert int(a["iters"]) <= int(b["iters"])


def test_distance_field_conservative(rng):
    from brickmap_tpu.scene import chebyshev_distance_field

    occ = rng.random((24, 24, 24)) < 0.02
    occ[4, 5, 6] = True  # ensure non-empty
    dist = chebyshev_distance_field(occ)
    assert (dist[occ] == 0).all()
    zs, ys, xs = np.nonzero(occ)
    pts = np.stack([zs, ys, xs], 1)
    for z, y, x in np.argwhere(~occ)[:: max(1, (~occ).sum() // 200)]:
        d = int(dist[z, y, x])
        cheb = np.abs(pts - np.array([z, y, x])).max(axis=1).min()
        assert d == min(cheb, 511), (z, y, x, d, cheb)


def test_aabb_clip_on_slab_planes(box_scene):
    """Origins exactly on slab planes with zero direction components: 0/0
    NaNs must be ignored (np.fmin/fmax semantics, voxel.cuh:13-24)."""
    from brickmap_tpu.ops.traverse import aabb_clip

    origins = np.array([
        [0.0, 64.0, 30.0],     # on x=0 plane
        [128.0, 64.0, 30.0],   # on x=max plane
        [64.0, 0.0, 30.0],     # on y=0 plane
        [64.0, 64.0, 128.0],   # on z=max plane
        [0.0, 0.0, 30.0],      # on two planes at once
    ], np.float32)
    directions = np.array([
        [0.0, 0.0, -1.0],      # zero x component while on x plane
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0],
    ], np.float32)
    hit, tminn, clipped, nrm = aabb_clip(jnp.asarray(origins),
                                         jnp.asarray(directions), GRID)
    # Rays sliding exactly along a face produce tmin=inf in the reference's
    # fminf/fmaxf arithmetic (a miss); the vectorized path must agree with
    # the oracle on hit/miss and tmin, with no NaNs poisoning either.
    assert not np.isnan(np.asarray(tminn)).any()
    for i in range(len(origins)):
        ok, tmin = dda_ref.intersect_aabb(origins[i], directions[i],
                                          GRID.world_max)
        assert bool(np.asarray(hit)[i]) == ok, i
        if ok:
            np.testing.assert_allclose(float(np.asarray(tminn)[i]), tmin,
                                       atol=1e-5, err_msg=str(i))
