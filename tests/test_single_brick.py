"""Config 1 end-to-end render through the XLA brick DDA."""

import numpy as np

import jax.numpy as jnp

from brickmap_tpu import bits
from brickmap_tpu.ops import sunsky as ss
from brickmap_tpu.render.camera import Camera
from brickmap_tpu.render.single_brick import render_single_brick


def test_render_single_brick(rng):
    dense = np.zeros((8, 8, 8), bool)
    dense[2:6, 2:6, 2:6] = True  # solid 4^3 cube centered in the brick
    words = jnp.asarray(
        np.asarray(bits.brick_words_from_dense(dense[None])[0], np.uint32))
    cam = Camera(position=(-10.0, 4.0, 4.0), direction=(1.0, 0.0, 0.0))
    sun = ss.sun_direction_from_position(jnp.asarray([0.05, 0.1]))
    rgb, hit = render_single_brick(words, cam, 64, 64, sun)
    rgb, hit = np.asarray(rgb), np.asarray(hit)
    assert rgb.shape == (64, 64, 3) and np.isfinite(rgb).all()
    # The cube covers part of the view; some rays hit, some see sky.
    assert 0 < hit.sum() < hit.size
    # Hit pixels show the lit albedo hue (r > b), sky pixels don't match it.
    hit_px = rgb[hit]
    assert (hit_px[:, 0] > hit_px[:, 2]).all()
    # The cube should appear roughly centered: center pixel hits, corner not.
    assert hit[32, 32]
    assert not hit[1, 1]
