"""Triton march kernel (pallas/march.py), run in interpret mode on the CPU,
against the XLA reference traversal and the scalar oracle; its record mode
against the XLA recorder."""

import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import GridConfig
from brickmap_tpu.ops import dda_ref
from brickmap_tpu.ops.record import record_segments_xla
from brickmap_tpu.ops.traverse import trace_rays
from brickmap_tpu.pallas.march import (record_segments_kernel,
                                       trace_rays_kernel)

GRID = GridConfig(grid_size=128, grid_height=128)      # one superchunk
GRID4 = GridConfig(grid_size=256, grid_height=128)     # 2x2x1 superchunks
GRID_S8 = GridConfig(grid_size=128, grid_height=128, supergrid_cell_size=8)
CAM = np.array([0, 0, 0], np.int64)
BLOCK = 32


def _box():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    return dense


@pytest.fixture(scope="module")
def box_scene():
    return scene_mod.scene_from_dense(_box(), GRID)


@pytest.fixture(scope="module")
def noise_scene():
    rng = np.random.default_rng(105)
    return scene_mod.scene_from_dense(rng.random((128, 128, 128)) < 0.015,
                                      GRID)


@pytest.fixture(scope="module")
def multi_scene():
    """2x2x1 superchunks with an empty gap (ESS jumps across superchunks)."""
    dense = np.zeros((128, 256, 256), bool)
    dense[16:48, 16:80, 16:80] = True
    dense[40:90, 180:240, 150:250] = True
    return scene_mod.scene_from_dense(dense, GRID4)


def random_rays(rng, n, lo, hi):
    origins = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    return origins, directions


def run_kernel(sc, origins, directions, cam=CAM, grid=GRID, **kw):
    args = (jnp.asarray(origins, jnp.float32),
            jnp.asarray(directions, jnp.float32),
            jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_words),
            jnp.asarray(sc.pool_base), jnp.asarray(cam, jnp.int32))
    xla_kw = {k: v for k, v in kw.items() if k in ("max_iters", "use_lod",
                                                    "use_ess")}
    res = trace_rays_kernel(*args, grid, block=BLOCK, interpret=True, **kw)
    ref = trace_rays(*args, grid, **xla_kw)
    return res, ref


def assert_same(res, ref):
    """Kernel vs XLA reference: identical results, ray for ray."""
    for k in ("hit", "t", "normal", "request", "request_pos", "exhausted"):
        np.testing.assert_array_equal(np.asarray(res[k]), np.asarray(ref[k]),
                                      err_msg=k)


def assert_oracle(res, sc, origins, directions, cam=CAM, grid=GRID):
    hits = np.asarray(res["hit"])
    ts = np.asarray(res["t"])
    ns = np.asarray(res["normal"])
    assert not np.asarray(res["exhausted"]).any()
    for i, (o, d) in enumerate(zip(origins, directions)):
        r = dda_ref.intersect_voxel(o, d, sc, grid, cam)
        assert bool(hits[i]) == r.hit, f"ray {i}: o={o} d={d}"
        if r.hit:
            assert abs(float(ts[i]) - r.distance) < 2e-2, i
            np.testing.assert_allclose(ns[i], r.normal, atol=1e-5,
                                       err_msg=f"ray {i} normal")


def test_kernel_matches_oracle_box(box_scene, rng):
    o, d = random_rays(rng, 48, [-20, -20, -20], [148, 148, 148])
    res, ref = run_kernel(box_scene, o, d)
    assert_same(res, ref)
    assert_oracle(res, box_scene, o, d)


def test_kernel_matches_oracle_noise(noise_scene, rng):
    o, d = random_rays(rng, 48, [0, 0, 0], [128, 128, 128])
    res, ref = run_kernel(noise_scene, o, d)
    assert_same(res, ref)
    assert_oracle(res, noise_scene, o, d)


@pytest.mark.parametrize("cam", [(0, 0, 0), (400, 0, 0), (900, 0, 0)],
                         ids=["near", "mid", "far"])
def test_kernel_lod_distances(box_scene, rng, cam):
    """Near (brick DDA), mid (LoD-byte DDA) and far (brick-granular) hits."""
    cam = np.asarray(cam, np.int64)
    o, d = random_rays(rng, 24, [0, 0, 0], [128, 128, 128])
    res, ref = run_kernel(box_scene, o, d, cam=cam)
    assert_same(res, ref)
    assert_oracle(res, box_scene, o, d, cam=cam)


@pytest.mark.parametrize("use_ess", [True, False])
def test_kernel_ess_on_off(noise_scene, rng, use_ess):
    o, d = random_rays(rng, 64, [-10, -10, -10], [138, 138, 138])
    res, ref = run_kernel(noise_scene, o, d, use_ess=use_ess)
    assert_same(res, ref)
    assert_oracle(res, noise_scene, o, d)


def test_kernel_axis_aligned_and_degenerate(box_scene):
    o = np.array([
        [0.5, 64.0, 30.0], [127.5, 64.0, 30.0], [64.0, 0.5, 30.0],
        [64.0, 64.0, 100.0], [0.5, 64.0, 100.0], [64.0, 64.0, 0.5],
        [-10.0, 64.0, 30.0], [0.0, 64.0, 30.0], [0.0, 0.0, 30.0],
    ], np.float32)
    d = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1], [1, 0, 0], [0, 0, 1],
        [1, 0, 0], [0, 0, -1], [0, 0, -1],
    ], np.float32)
    res, ref = run_kernel(box_scene, o, d)
    assert_same(res, ref)
    assert_oracle(res, box_scene, o, d)


def test_kernel_origins_inside_solid_and_outside_world(box_scene):
    o = np.array([[64.0, 64.0, 30.0], [40.0, 40.0, 20.0],
                  [-50.0, 64.0, 30.0], [64.0, -300.0, 30.0],
                  [200.0, 200.0, 200.0], [64.0, 64.0, 500.0]], np.float32)
    d = np.array([[1, 0, 0], [0.3, 0.5, -0.8], [1, 0, 0], [0, 1, 0],
                  [1, 1, 1], [0, 0, -1]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    res, ref = run_kernel(box_scene, o, d)
    assert_same(res, ref)
    assert_oracle(res, box_scene, o, d)
    hits = np.asarray(res["hit"])
    assert hits[0] and hits[1] and np.asarray(res["t"])[0] == 0.0
    assert not hits[4]          # pointing away from the world


def test_kernel_requests_unloaded_bricks():
    sc = scene_mod.scene_from_dense(_box(), GRID, residency="streaming")
    o = np.array([[0.5, 64.0, 30.0], [64.0, 64.0, 100.0]], np.float32)
    d = np.array([[1, 0, 0], [0, 0, -1]], np.float32)
    res, ref = run_kernel(sc, o, d)
    assert_same(res, ref)
    for i in range(2):
        r = dda_ref.intersect_voxel(o[i], d[i], sc, GRID, CAM)
        assert bool(np.asarray(res["request"])[i]) == (r.request is not None)
        assert tuple(np.asarray(res["request_pos"])[i]) == r.request


def test_kernel_budget_exhaustion_resume_t(box_scene):
    """A starved budget is reported, not a silent miss, and ``resume_t``
    points at the entry of the (known empty-prefix) cell the ray stopped in:
    re-tracing from just before it reaches the full-budget hit."""
    o = np.array([[0.5, 64.0, 30.0], [0.5, 60.0, 20.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.9, 0.1, 0.05]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    res, ref = run_kernel(box_scene, o, d, max_iters=2, use_ess=False)
    assert_same(res, ref)
    assert np.asarray(res["exhausted"]).all()
    assert not np.asarray(res["hit"]).any()
    resume = np.asarray(res["resume_t"])
    assert (resume > 0).all()
    full, _ = run_kernel(box_scene, o, d)
    o2 = o + d * (resume - 2.0)[:, None]
    again, _ = run_kernel(box_scene, o2, d)
    np.testing.assert_array_equal(np.asarray(again["hit"]),
                                  np.asarray(full["hit"]))
    np.testing.assert_allclose(np.asarray(again["t"]) + resume - 2.0,
                               np.asarray(full["t"]), atol=1e-3)


@pytest.mark.parametrize("n", [1, 37, 100])
def test_kernel_ragged_ray_counts(noise_scene, rng, n):
    """Ray counts that are not a multiple of the block pad and unpad."""
    o, d = random_rays(rng, n, [-10, -10, -10], [138, 138, 138])
    res, ref = run_kernel(noise_scene, o, d)
    assert res["hit"].shape == (n,) and res["normal"].shape == (n, 3)
    assert_same(res, ref)


def test_kernel_multi_superchunk(multi_scene, rng):
    o, d = random_rays(rng, 64, [-20, -20, -20], [276, 276, 148])
    res, ref = run_kernel(multi_scene, o, d, grid=GRID4)
    assert_same(res, ref)
    assert_oracle(res, multi_scene, o, d, grid=GRID4)


def test_kernel_supergrid_cell_size_8(rng):
    """Non-default superchunk geometry: pool bases per 8^3-brick chunk."""
    sc = scene_mod.scene_from_dense(
        np.random.default_rng(9).random((128, 128, 128)) < 0.01, GRID_S8)
    o, d = random_rays(rng, 48, [-10, -10, -10], [138, 138, 138])
    res, ref = run_kernel(sc, o, d, grid=GRID_S8)
    assert_same(res, ref)
    assert_oracle(res, sc, o, d, grid=GRID_S8)


# ---------------------------------------------------------------------------
# Record mode vs the XLA recorder
# ---------------------------------------------------------------------------

def run_record(sc, o, d, grid=GRID, **kw):
    args = (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_base), grid)
    a = record_segments_kernel(*args, block=BLOCK, interpret=True, **kw)
    b = record_segments_xla(*args, **kw)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
    return a


@pytest.mark.parametrize("k_segments", [3, 8])
def test_record_matches_xla(noise_scene, rng, k_segments):
    o, d = random_rays(rng, 70, [-10, -10, -10], [138, 138, 138])
    segs = run_record(noise_scene, o, d, k_segments=k_segments)
    count = np.asarray(segs["count"])
    assert count.max() == k_segments            # some rays fill every slot
    cells = np.asarray(segs["cells"])
    assert ((cells >= 0).sum(axis=1) == count).all()
    assert not np.asarray(segs["exhausted"]).any()


def test_record_ess_off(multi_scene, rng):
    o, d = random_rays(rng, 40, [-20, -20, -20], [276, 276, 148])
    a = run_record(multi_scene, o, d, grid=GRID4, k_segments=6,
                   use_ess=False)
    b = run_record(multi_scene, o, d, grid=GRID4, k_segments=6)
    np.testing.assert_array_equal(np.asarray(a["cells"]),
                                  np.asarray(b["cells"]))


def test_record_slots_are_pool_rows(box_scene):
    """Recorded slots are global pool rows of loaded bricks (-1 where the
    brick is not loaded), i.e. the scene's cell -> pool-row map."""
    from brickmap_tpu.diff.sparse import cell_pool_map

    o = np.array([[0.5, 64.0, 30.0], [64.0, 64.0, 100.0]], np.float32)
    d = np.array([[1, 0, 0], [0, 0, -1]], np.float32)
    segs = run_record(box_scene, o, d, k_segments=4)
    cmap = cell_pool_map(box_scene, GRID)
    cells, slots = np.asarray(segs["cells"]), np.asarray(segs["slot"])
    valid = cells >= 0
    assert valid.any()
    want = cmap[(cells >> 20) & 0x3FF, (cells >> 10) & 0x3FF, cells & 0x3FF]
    np.testing.assert_array_equal(slots[valid], want[valid])
    stream = scene_mod.scene_from_dense(_box(), GRID, residency="streaming")
    segs = run_record(stream, o, d, k_segments=4)
    assert (np.asarray(segs["slot"]) == -1).all()
    np.testing.assert_array_equal(np.asarray(segs["cells"]), cells)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu, noise_scene, rng):
    """The compiled kernel (not the interpreter) on the card agrees with the
    XLA traversal.  Runs with BRICKMAP_TEST_GPU=1 on a GPU; skips elsewhere."""
    o, d = random_rays(rng, 4096, [-10, -10, -10], [138, 138, 138])
    args = (jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(noise_scene.index_volume),
            jnp.asarray(noise_scene.pool_words),
            jnp.asarray(noise_scene.pool_base), jnp.asarray(CAM, jnp.int32))
    res = trace_rays_kernel(*args, GRID)
    ref = trace_rays(*args, GRID)
    for k in ("hit", "normal", "request", "exhausted"):
        np.testing.assert_array_equal(np.asarray(res[k]), np.asarray(ref[k]))
    np.testing.assert_allclose(np.asarray(res["t"]), np.asarray(ref["t"]),
                               rtol=1e-5, atol=1e-5)
