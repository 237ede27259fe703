"""XLA brick DDA (config 1) vs the scalar oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import bits
from brickmap_tpu.ops import dda_ref
from brickmap_tpu.ops.brick import trace_single_brick


@pytest.fixture(scope="module")
def brick():
    rng = np.random.default_rng(103)
    dense = rng.random((8, 8, 8)) < 0.12  # [z, y, x]
    dense[4, 3, 2] = True
    words = np.asarray(bits.brick_words_from_dense(dense[None])[0], np.uint32)
    return dense, words


def run_oracle(words, origins, directions):
    outs = []
    for o, d in zip(origins, directions):
        hit, normal, dist = dda_ref.intersect_brick(
            np.asarray(o, np.float32), np.asarray(d, np.float32), words,
            np.zeros(3, np.float32))
        outs.append((hit, dist, normal))
    return outs


def assert_match(res, refs, directions):
    hits = np.asarray(res["hit"])
    ts = np.asarray(res["t"])
    axes = np.asarray(res["axis"])
    for i, (hit, dist, normal) in enumerate(refs):
        assert bool(hits[i]) == hit, i
        if hit:
            np.testing.assert_allclose(float(ts[i]), dist, atol=1e-4,
                                       err_msg=f"ray {i}")
            ax = int(axes[i])
            if ax >= 0:
                want = np.zeros(3)
                want[ax] = -np.sign(directions[i][ax])
                np.testing.assert_allclose(normal, want, atol=1e-6,
                                           err_msg=f"ray {i} axis {ax}")
            else:
                # entry-cell hit: oracle keeps the passed-in (zero) normal
                np.testing.assert_allclose(normal, 0.0, atol=1e-6)


def test_brick_dda_matches_oracle_random(brick, rng):
    dense, words = brick
    n = 300
    # Rays aimed at the brick from outside, advanced to the entry face + eps
    # (the caller contract: intersect_brick receives boundary origins,
    # voxel.cuh:224).
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    start = (np.array([4.0, 4.0, 4.0]) - dirs * 20.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        t1 = (0.0 - start) / dirs
        t2 = (8.0 - start) / dirs
    tenter = np.minimum(t1, t2).max(axis=1) + 1e-3
    origins = (start + dirs * tenter[:, None]).astype(np.float32)
    inside = ((origins > 0) & (origins < 8)).all(axis=1)
    origins, dirs = origins[inside][:257], dirs[inside][:257]
    res = trace_single_brick(jnp.asarray(origins), jnp.asarray(dirs),
                             jnp.asarray(words))
    refs = run_oracle(words, origins, dirs)
    assert_match(res, refs, dirs)


def test_brick_dda_axis_aligned(brick):
    dense, words = brick
    origins, dirs = [], []
    for axis in range(3):
        for sign in (1, -1):
            for a in range(8):
                for b in range(8):
                    o = [a + 0.5, b + 0.5]
                    o.insert(axis, 0.01 if sign > 0 else 7.99)
                    d = [0.0, 0.0]
                    d.insert(axis, float(sign))
                    origins.append(o)
                    dirs.append(d)
    origins = np.asarray(origins, np.float32)
    dirs = np.asarray(dirs, np.float32)
    res = trace_single_brick(jnp.asarray(origins), jnp.asarray(dirs),
                             jnp.asarray(words))
    refs = run_oracle(words, origins, dirs)
    assert_match(res, refs, dirs)


def test_brick_dda_inside_start(brick, rng):
    dense, words = brick
    n = 64
    origins = rng.uniform(0.05, 7.95, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    res = trace_single_brick(jnp.asarray(origins), jnp.asarray(dirs),
                             jnp.asarray(words))
    refs = run_oracle(words, origins, dirs)
    assert_match(res, refs, dirs)


def test_brick_dda_empty_and_full():
    empty = np.zeros(16, np.uint32)
    full = np.full(16, 0xFFFFFFFF, np.uint32)
    o = np.array([[0.01, 4.0, 4.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    r_e = trace_single_brick(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(empty))
    assert not bool(np.asarray(r_e["hit"])[0])
    r_f = trace_single_brick(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(full))
    assert bool(np.asarray(r_f["hit"])[0])
    assert float(np.asarray(r_f["t"])[0]) == 0.0  # entry-cell hit
