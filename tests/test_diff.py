"""Differentiable renderer: hard-limit parity, finite-difference gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import GridConfig
from brickmap_tpu.diff.render import composite_rays, l2_loss_and_grads
from brickmap_tpu.ops import dda_ref


@pytest.fixture(scope="module")
def small_world():
    rng = np.random.default_rng(101)
    """16^3 grid with a solid 6^3 cube."""
    occ = np.zeros((16, 16, 16), np.float32)
    occ[5:11, 5:11, 5:11] = 1.0
    alb = np.ones((16, 16, 16, 3), np.float32) * np.array([0.8, 0.4, 0.2])
    return occ, alb


def rays_toward_center(n, rng, radius=30.0):
    center = np.array([8.0, 8.0, 8.0], np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = center - dirs * radius
    return origins, dirs


def test_hard_limit_matches_binary_hit(small_world, rng):
    """Binary occupancy: compositor weight lands entirely on the first solid
    voxel, matching a hard-surface DDA; background shows iff the oracle misses."""
    occ, alb = small_world
    grid = GridConfig(grid_size=16, grid_height=16, supergrid_cell_size=2)
    sc = scene_mod.scene_from_dense(occ.astype(bool), grid)

    origins, dirs = rays_toward_center(64, rng)
    bg = np.zeros((64, 3), np.float32)
    rgb, trans, depth = composite_rays(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ),
        jnp.asarray(alb), jnp.asarray(bg), max_steps=96)
    rgb, trans, depth = map(np.asarray, (rgb, trans, depth))

    for i in range(64):
        ref = dda_ref.intersect_voxel(origins[i], dirs[i], sc, grid,
                                      np.zeros(3, np.int64))
        if ref.hit:
            assert trans[i] < 1e-6, i
            np.testing.assert_allclose(rgb[i], [0.8, 0.4, 0.2], atol=1e-5)
            # Expected depth = mid-point of the entry voxel crossing; the DDA
            # hit distance is the entry point, so depth >= distance.
            assert depth[i] > ref.distance - 1e-3, i
        else:
            assert trans[i] > 1 - 1e-6, i
            np.testing.assert_allclose(rgb[i], 0.0, atol=1e-6)


def test_transmittance_partial(small_world, rng):
    """occ=0.5 slab: transmittance after k voxels = 0.5^k."""
    occ = np.zeros((8, 8, 8), np.float32)
    occ[:, :, 3] = 0.5  # one voxel-thick slab at x=3
    alb = np.ones((8, 8, 8, 3), np.float32)
    o = np.array([[0.5, 4.5, 4.5]], np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    bg = np.zeros((1, 3), np.float32)
    rgb, trans, _ = composite_rays(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(occ), jnp.asarray(alb),
                                   jnp.asarray(bg), max_steps=16)
    np.testing.assert_allclose(float(trans[0]), 0.5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rgb)[0], 0.5, atol=1e-6)


def test_background_compositing():
    occ = np.zeros((8, 8, 8), np.float32)
    alb = np.zeros((8, 8, 8, 3), np.float32)
    o = np.array([[-5.0, 4.0, 4.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    bg = np.array([[0.1, 0.2, 0.3]], np.float32)
    rgb, trans, _ = composite_rays(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(occ), jnp.asarray(alb),
                                   jnp.asarray(bg), max_steps=32)
    np.testing.assert_allclose(np.asarray(rgb), bg, atol=1e-6)
    np.testing.assert_allclose(float(trans[0]), 1.0)


def test_lattice_diagonal_tie_order():
    """A corner-aligned diagonal ray crosses x and y walls at EXACT ties;
    the merged walk must visit each voxel once, stepping y-then-x like the
    sequential DDA (z>y>x tie priority), not collapse/double-visit the
    diagonal voxel)."""
    from brickmap_tpu.diff.sparse import _merge_offsets

    s = np.sqrt(0.5, dtype=np.float32)
    direction = jnp.asarray([[s, s, 0.0]], jnp.float32)
    # Origin exactly on a voxel corner: every x crossing ties a y crossing.
    origin = jnp.asarray([[2.0, 3.0, 0.5]], jnp.float32)
    pos = jnp.floor(origin).astype(jnp.int32)
    rd = 1.0 / jnp.where(direction == 0, 1.0, direction)
    cb = jnp.where(direction > 0, pos + 1.0, pos.astype(jnp.float32))
    tmax = jnp.where(direction != 0.0, (cb - origin) * rd, 1e6)
    tdabs = jnp.abs(jnp.where(direction == 0.0, 0.0, rd))

    nvox, nj = 9, 8
    offs = np.asarray(_merge_offsets(tmax, tdabs, direction != 0.0,
                                     nj, nvox))[0]      # [V, 3]
    # Each merged step advances exactly ONE axis (no collapsed diagonal,
    # no repeated offsets), alternating y (priority) then x.
    steps = np.diff(offs, axis=0)
    np.testing.assert_array_equal(steps.sum(axis=1), 1)
    np.testing.assert_array_equal(offs[:, 2], 0)        # z never crossed
    expect_y = [(k + 1) // 2 for k in range(nvox)]      # y first on each tie
    expect_x = [k // 2 for k in range(nvox)]
    np.testing.assert_array_equal(offs[:, 1], expect_y)
    np.testing.assert_array_equal(offs[:, 0], expect_x)


def test_lattice_diagonal_composite_no_double_visit():
    """Soft occupancy along an exact diagonal: transmittance equals the
    product over DISTINCT visited voxels (a double visit would square one
    factor)."""
    occ = np.full((4, 8, 8), 0.5, np.float32)
    alb = np.ones((4, 8, 8, 3), np.float32)
    o = np.asarray([[0.0, 0.0, 0.5]], np.float32)
    s = np.sqrt(0.5, dtype=np.float32)
    d = np.asarray([[s, s, 0.0]], np.float32)
    bg = np.zeros((1, 3), np.float32)
    rgb, trans, _ = composite_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ), jnp.asarray(alb),
        jnp.asarray(bg), max_steps=64)
    # Sequential walk: staircase (0,0),(0,1),(1,1),(1,2),... = 15 voxels
    # inside the 8x8 slab at z=0.
    expected_voxels = 15
    np.testing.assert_allclose(float(trans[0]), 0.5 ** expected_voxels,
                               rtol=1e-4)


def test_gradients_finite_difference(rng):
    """Autodiff grads vs central finite differences on a tiny soft grid."""
    occ = rng.uniform(0.1, 0.6, (6, 6, 6)).astype(np.float32)
    alb = rng.uniform(0.2, 0.9, (6, 6, 6, 3)).astype(np.float32)
    origins, dirs = rays_toward_center(16, rng, radius=12.0)
    origins = origins + np.array([3.0 - 8.0, 3.0 - 8.0, 3.0 - 8.0]) + 8.0 - 5.0
    bg = np.full((16, 3), 0.2, np.float32)
    target = np.full((16, 3), 0.5, np.float32)

    loss, (docc, dalb) = l2_loss_and_grads(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ),
        jnp.asarray(alb), jnp.asarray(bg), jnp.asarray(target), max_steps=32)
    loss = float(loss)
    docc, dalb = np.asarray(docc), np.asarray(dalb)
    assert np.isfinite(docc).all() and np.isfinite(dalb).all()
    assert np.abs(docc).max() > 0

    def loss_np(occ_mod, alb_mod):
        l, _ = l2_loss_and_grads(
            jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ_mod),
            jnp.asarray(alb_mod), jnp.asarray(bg), jnp.asarray(target),
            max_steps=32)
        return float(l)

    # Check a handful of coordinates with the largest gradient magnitude.
    h = 1e-3
    flat = np.argsort(-np.abs(docc).ravel())[:5]
    for f in flat:
        z, y, x = np.unravel_index(f, occ.shape)
        op = occ.copy(); op[z, y, x] += h
        om = occ.copy(); om[z, y, x] -= h
        fd = (loss_np(op, alb) - loss_np(om, alb)) / (2 * h)
        assert abs(fd - docc[z, y, x]) < 5e-3 * max(1.0, abs(fd)), (
            (z, y, x), fd, docc[z, y, x])

    flat = np.argsort(-np.abs(dalb).ravel())[:5]
    for f in flat:
        z, y, x, c = np.unravel_index(f, dalb.shape)
        ap = alb.copy(); ap[z, y, x, c] += h
        am = alb.copy(); am[z, y, x, c] -= h
        fd = (loss_np(occ, ap) - loss_np(occ, am)) / (2 * h)
        assert abs(fd - dalb[z, y, x, c]) < 5e-3 * max(1.0, abs(fd))


def test_optimization_decreases_loss(rng):
    """A few SGD steps on occupancy+albedo reduce the image loss."""
    occ_true = np.zeros((8, 8, 8), np.float32)
    occ_true[2:6, 2:6, 2:6] = 1.0
    alb_true = np.ones((8, 8, 8, 3), np.float32) * 0.7
    origins, dirs = rays_toward_center(128, rng, radius=16.0)
    bg = np.zeros((128, 3), np.float32)
    target, _, _ = composite_rays(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ_true),
        jnp.asarray(alb_true), jnp.asarray(bg), max_steps=40)

    import optax

    occ = jnp.full((8, 8, 8), 0.3)
    alb = jnp.full((8, 8, 8, 3), 0.5)
    opt = optax.adam(0.05)
    state = opt.init((occ, alb))
    losses = []
    for _ in range(60):
        loss, grads = l2_loss_and_grads(
            jnp.asarray(origins), jnp.asarray(dirs), occ, alb,
            jnp.asarray(bg), target, max_steps=40)
        losses.append(float(loss))
        updates, state = opt.update(grads, state)
        occ, alb = optax.apply_updates((occ, alb), updates)
        occ = jnp.clip(occ, 0.0, 1.0)
        alb = jnp.clip(alb, 0.0, 1.0)
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
