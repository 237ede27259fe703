"""Sharding correctness on the virtual 8-device CPU mesh.

SURVEY.md §4: numerical parity single-device vs sharded; gradient psum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig
from brickmap_tpu.diff.render import composite_rays, l2_loss_and_grads
from brickmap_tpu.ops import sunsky as ss
from brickmap_tpu.parallel.render import (
    inverse_train_step,
    make_mesh,
    render_wave_sharded,
)
from brickmap_tpu.render import pathtrace
from brickmap_tpu.render.camera import Camera

CFG = BrickmapConfig(
    grid=GridConfig(grid_size=128, grid_height=128),
    render=RenderConfig(width=32, height=16, max_bounces=1, max_top_steps=64),
)
W, H = CFG.render.width, CFG.render.height


@pytest.fixture(scope="module")
def world():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    sc = scene_mod.scene_from_dense(dense, CFG.grid)
    jsc = scene_mod.VoxelScene(
        index_volume=jnp.asarray(sc.index_volume),
        pool_words=jnp.asarray(sc.pool_words),
        pool_base=jnp.asarray(sc.pool_base),
    )
    cam = Camera(position=(10.0, 10.0, 80.0),
                 direction=tuple(np.array([1.0, 1.0, -0.4])
                                 / np.linalg.norm([1.0, 1.0, -0.4])))
    sun = ss.sun_direction_from_position(jnp.asarray([0.05, 0.1]))
    arrays = pathtrace.camera_arrays_for(cam, sun, W, H)
    cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
    return jsc, arrays, cam_brick


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_forward_runs_and_covers_all_pixels(world):
    jsc, arrays, cam_brick = world
    mesh = make_mesh(8)
    rgb, count, req = render_wave_sharded(
        mesh, jax.random.PRNGKey(0), jsc, arrays, cam_brick, CFG, W, H)
    assert rgb.shape == (W * H, 3)
    np.testing.assert_array_equal(np.asarray(count), 1.0)
    assert np.isfinite(np.asarray(rgb)).all()
    assert np.asarray(rgb).sum() > 0


def test_sharded_forward_statistics_match_single(world):
    """Different PRNG folding => not bitwise equal; mean radiance must agree."""
    jsc, arrays, cam_brick = world
    mesh = make_mesh(8)
    acc_s = np.zeros((W * H, 3), np.float32)
    acc_1 = np.zeros((W * H, 3), np.float32)
    for s in range(6):
        rgb_s, _, _ = render_wave_sharded(
            mesh, jax.random.PRNGKey(s), jsc, arrays, cam_brick, CFG, W, H)
        rgb_1, _, _ = pathtrace.render_wave(
            jax.random.PRNGKey(100 + s), jsc, arrays, cam_brick, CFG, W, H)
        acc_s += np.asarray(rgb_s)
        acc_1 += np.asarray(rgb_1)
    m_s, m_1 = acc_s.mean(), acc_1.mean()
    assert abs(m_s - m_1) / max(m_1, 1e-9) < 0.12


def test_sharded_forward_non_divisible_resolution(world):
    """Pixel counts that do not divide the mesh pad by wrap-around instead
    of asserting: 33x16 = 528 pixels on 8 devices."""
    jsc, arrays, cam_brick = world
    w, h = 33, 16
    arrays2 = dict(arrays)  # camera arrays are resolution-independent
    mesh = make_mesh(8)
    rgb, count, req = render_wave_sharded(
        mesh, jax.random.PRNGKey(5), jsc, arrays2, cam_brick, CFG, w, h)
    assert rgb.shape == (w * h, 3)
    assert count.shape == (w * h,)
    assert req["mask"].shape == (w * h,)
    np.testing.assert_array_equal(np.asarray(count), 1.0)
    assert np.isfinite(np.asarray(rgb)).all()


def test_inverse_train_step_matches_single_device(rng):
    mesh = make_mesh(8)
    occ = rng.uniform(0.1, 0.7, (8, 8, 8)).astype(np.float32)
    alb = rng.uniform(0.2, 0.9, (8, 8, 8, 3)).astype(np.float32)
    n = 64
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([4, 4, 4]) - dirs * 14).astype(np.float32)
    bg = np.zeros((n, 3), np.float32)
    target = np.full((n, 3), 0.4, np.float32)

    loss_s, docc_s, dalb_s = inverse_train_step(
        mesh, jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ),
        jnp.asarray(alb), jnp.asarray(bg), jnp.asarray(target), max_steps=32)

    loss_1, (docc_1, dalb_1) = l2_loss_and_grads(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ),
        jnp.asarray(alb), jnp.asarray(bg), jnp.asarray(target), max_steps=32)

    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(docc_s), np.asarray(docc_1),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dalb_s), np.asarray(dalb_1),
                               rtol=1e-4, atol=1e-7)


def test_sharded_paged_wave_matches_single(march_on_cpu):
    """The march kernel under shard_map: sharded wave == single-device
    wave."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig
    from brickmap_tpu.ops import sunsky as ss
    from brickmap_tpu.parallel.render import (
        make_mesh, render_wave_sharded, replicate)
    from brickmap_tpu.render import pathtrace
    from brickmap_tpu.render.camera import Camera

    mesh8 = make_mesh(8)

    cfg = BrickmapConfig(
        grid=GridConfig(grid_size=128, grid_height=128),
        render=RenderConfig(width=32, height=16, max_bounces=1,
                            max_top_steps=64),
    )
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    sc = scene_mod.scene_from_dense(dense, cfg.grid)
    psc = jax.tree.map(jnp.asarray, sc)

    w, h = cfg.render.width, cfg.render.height
    cam = Camera(position=(10.0, 10.0, 80.0),
                 direction=(0.577, 0.577, -0.577))
    sun = ss.sun_direction_from_position(jnp.asarray([0.05, 0.1]))
    arrays = pathtrace.camera_arrays_for(cam, sun, w, h)
    cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
    key = jax.random.PRNGKey(3)

    rgb_sh, count_sh, _ = render_wave_sharded(
        mesh8, key, replicate(mesh8, psc), arrays, cam_brick, cfg, w, h)

    # Single-device reference: replicate the per-shard PRNG folding.
    d = mesh8.devices.size
    local = (w * h) // d
    parts = []
    for me in range(d):
        idx = jnp.arange(me * local, (me + 1) * local, dtype=jnp.int32)
        rgb, _, _ = pathtrace.wave_for_indices(
            jax.random.fold_in(key, me), idx, psc, arrays, cam_brick, cfg,
            w, h)
        parts.append(np.asarray(rgb))
    np.testing.assert_allclose(np.asarray(rgb_sh), np.concatenate(parts),
                               rtol=1e-5, atol=1e-6)


def test_sparse_inverse_step_sharded(rng, march_on_cpu):
    """Sparse-pool gradients under ray-DP equal the single-device gradients."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from brickmap_tpu import scene as scene_mod
    from brickmap_tpu.config import GridConfig
    from brickmap_tpu.diff.sparse import (
        cell_pool_map, l2_loss_and_grads_sparse, pool_fields_from_bitmask)
    from brickmap_tpu.parallel.render import inverse_train_step_sparse, make_mesh

    mesh8 = make_mesh(8)

    grid = GridConfig(grid_size=128, grid_height=128)
    dense = np.zeros((128, 128, 128), bool)
    dense[16:40, 40:80, 40:80] = True
    sc = scene_mod.scene_from_dense(dense, grid)
    psc = jax.tree.map(jnp.asarray, sc)
    cellmap = jnp.asarray(cell_pool_map(sc, grid))
    occ, alb = pool_fields_from_bitmask(sc)
    occ = occ * 0.6

    n = 64
    origins = np.array([[60.0, 60.0, 120.0]] * n, np.float32)
    dirs = (np.array([60, 60, 28], np.float32) - origins
            + rng.normal(scale=20, size=(n, 3)).astype(np.float32))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bg = np.zeros((n, 3), np.float32)
    tgt = np.full((n, 3), 0.4, np.float32)

    loss_s, docc_s, dalb_s = inverse_train_step_sparse(
        mesh8, jnp.asarray(origins), jnp.asarray(dirs.astype(np.float32)),
        psc, cellmap, jnp.asarray(occ), jnp.asarray(alb), jnp.asarray(bg),
        jnp.asarray(tgt), grid)
    loss_1, (docc_1, dalb_1) = l2_loss_and_grads_sparse(
        jnp.asarray(origins), jnp.asarray(dirs.astype(np.float32)), psc,
        cellmap, jnp.asarray(occ), jnp.asarray(alb), jnp.asarray(bg),
        jnp.asarray(tgt), grid)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(docc_s), np.asarray(docc_1),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dalb_s), np.asarray(dalb_1),
                               rtol=1e-4, atol=1e-7)
