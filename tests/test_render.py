"""End-to-end render smoke + statistical tests on a small terrain world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig
from brickmap_tpu.ops import dda_ref, sunsky as ss
from brickmap_tpu.render import pathtrace
from brickmap_tpu.render.camera import Camera, primary_rays

CFG = BrickmapConfig(
    grid=GridConfig(grid_size=128, grid_height=128),
    render=RenderConfig(width=48, height=32, max_bounces=2, max_top_steps=64),
)
W, H = CFG.render.width, CFG.render.height


@pytest.fixture(scope="module")
def world():
    sc = scene_mod.generate_terrain_scene(CFG.grid, feature_scale=64.0)
    jsc = scene_mod.VoxelScene(
        index_volume=jnp.asarray(sc.index_volume),
        pool_words=jnp.asarray(sc.pool_words),
        pool_base=jnp.asarray(sc.pool_base),
    )
    cam = Camera(position=(20.0, 20.0, 100.0),
                 direction=tuple(np.array([1.0, 1.0, -0.45])
                                 / np.linalg.norm([1.0, 1.0, -0.45])))
    sun = ss.sun_direction_from_position(jnp.asarray([0.05, 0.1]))
    arrays = pathtrace.camera_arrays_for(cam, sun, W, H)
    cam_brick = jnp.asarray(cam.brick_position, jnp.int32)
    return sc, jsc, cam, arrays, cam_brick


def test_render_wave_shapes_and_finite(world):
    _, jsc, _, arrays, cam_brick = world
    rgb, count, req = pathtrace.render_wave(
        jax.random.PRNGKey(0), jsc, arrays, cam_brick, CFG, W, H)
    assert rgb.shape == (W * H, 3)
    assert np.isfinite(np.asarray(rgb)).all()
    np.testing.assert_array_equal(np.asarray(count), 1.0)
    assert not bool(np.asarray(req["mask"]).any())  # fully resident world


def test_render_has_sky_and_ground(world):
    _, jsc, _, arrays, cam_brick = world
    rgb, _, _ = pathtrace.render_wave(
        jax.random.PRNGKey(1), jsc, arrays, cam_brick, CFG, W, H)
    img = np.asarray(rgb).reshape(H, W, 3)
    top = img[: H // 4].mean()
    assert top > 0.0  # sky visible looking over the terrain
    assert img.sum() > 0


def test_primary_hit_mask_matches_oracle(world):
    """bounces=0 sanity: per-pixel hit/miss of jittered primaries must agree
    with the oracle traced on the same rays."""
    sc, jsc, cam, arrays, cam_brick = world
    key = jax.random.PRNGKey(2)
    o, d, _ = primary_rays(key, cam, W, H)
    from brickmap_tpu.ops.traverse import trace_rays

    res = trace_rays(o, d, jsc.index_volume, jsc.pool_words, jsc.pool_base,
                     cam_brick, CFG.grid, max_iters=512)
    on, dn = np.asarray(o), np.asarray(d)
    hits = np.asarray(res["hit"])
    ts = np.asarray(res["t"])
    cam_np = np.asarray(cam.brick_position, np.int64)
    for i in range(0, W * H, 37):
        r = dda_ref.intersect_voxel(on[i], dn[i], sc, CFG.grid, cam_np)
        assert r.hit == bool(hits[i]), i
        if r.hit:
            assert abs(r.distance - float(ts[i])) < 2e-2


def test_progressive_accumulation_consistency(world):
    """Two independent waves agree statistically (same estimator)."""
    _, jsc, _, arrays, cam_brick = world
    imgs = []
    for seed in (10, 11):
        acc = np.zeros((W * H, 3), np.float32)
        for s in range(4):
            rgb, _, _ = pathtrace.render_wave(
                jax.random.PRNGKey(seed * 100 + s), jsc, arrays, cam_brick,
                CFG, W, H)
            acc += np.asarray(rgb)
        imgs.append(acc / 4)
    a, b = imgs
    # Mean image intensity stable across independent sample sets.
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.1


def test_film_tonemap(world):
    _, jsc, _, arrays, cam_brick = world
    film = pathtrace.film_init(W, H)
    rgb, count, _ = pathtrace.render_wave(
        jax.random.PRNGKey(3), jsc, arrays, cam_brick, CFG, W, H)
    film = pathtrace.film_add(film, rgb, count)
    img = np.asarray(pathtrace.tonemap(film, W, H))
    assert img.shape == (H, W, 3)
    assert (img >= 0).all() and (img <= 1).all()


def test_paged_wave_matches_voxel_wave(world, request, monkeypatch):
    """The march kernel as the wave's traversal must reproduce the XLA
    path's image exactly (same RNG, ray-for-ray parity)."""
    from brickmap_tpu.ops import traverse

    _, jsc, _, arrays, cam_brick = world
    key = jax.random.PRNGKey(4)
    # The XLA side renders before the kernel is routed in.
    assert pathtrace.trace_rays is traverse.trace_rays
    rgb_v, _, req_v = pathtrace.render_wave(key, jsc, arrays, cam_brick,
                                            CFG, W, H)

    request.getfixturevalue("march_on_cpu")
    kernel, calls = pathtrace.trace_rays, []

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(pathtrace, "trace_rays", counted)
    rgb_p, _, req_p = pathtrace.render_wave(key, jsc, arrays, cam_brick,
                                            CFG, W, H)
    assert calls, "the kernel side never reached the march kernel"
    np.testing.assert_array_equal(np.asarray(rgb_p), np.asarray(rgb_v))
    np.testing.assert_array_equal(np.asarray(req_p["mask"]),
                                  np.asarray(req_v["mask"]))


def test_exhausted_rays_not_shaded_as_sky(world):
    """A budget-truncated ray must contribute NOTHING (and be counted),
    never silently shade as a sky miss."""
    import dataclasses

    sc, jsc, cam, arrays, cam_brick = world
    cfg_t = CFG.replace(render=dataclasses.replace(
        CFG.render, max_bounces=0, max_top_steps=2, max_brick_steps=0,
        max_byte_steps=0))
    key = jax.random.PRNGKey(33)
    k_pix, k_loop = jax.random.split(key)
    st = pathtrace._primary_state(k_pix, arrays, cfg_t, W, H)
    origins, dirs = st["origins"], st["dirs"]
    _, k_b = jax.random.split(k_loop)
    st = pathtrace._bounce_step(jnp.int32(0), k_b, st, jsc, cam_brick,
                                arrays["sun_direction"], cfg_t)
    rgb, count, req = pathtrace._final_shadow(st, jsc, cam_brick, cfg_t)
    assert int(req["exhausted_rays"]) > 0

    from brickmap_tpu.ops.traverse import trace_rays

    res = trace_rays(origins, dirs, jsc.index_volume, jsc.pool_words,
                     jsc.pool_base, cam_brick, cfg_t.grid, max_iters=2)
    exh = np.asarray(res["exhausted"]).astype(bool)
    assert exh.any()
    assert int(req["exhausted_rays"]) == int(exh.sum())
    np.testing.assert_array_equal(np.asarray(rgb)[exh], 0.0)


def test_exhausted_rays_paged_kernel(world, march_on_cpu):
    """Same contract through the march kernel (step budget)."""
    import dataclasses

    from brickmap_tpu.pallas.march import trace_rays_kernel

    sc, jsc, cam, arrays, cam_brick = world
    cfg_t = CFG.replace(render=dataclasses.replace(
        CFG.render, max_bounces=0, max_top_steps=2, max_brick_steps=0,
        max_byte_steps=0))
    key = jax.random.PRNGKey(34)
    k_pix, k_loop = jax.random.split(key)
    st = pathtrace._primary_state(k_pix, arrays, cfg_t, W, H)
    origins, dirs = st["origins"], st["dirs"]
    _, k_b = jax.random.split(k_loop)
    st = pathtrace._bounce_step(jnp.int32(0), k_b, st, jsc, cam_brick,
                                arrays["sun_direction"], cfg_t)
    rgb, count, req = pathtrace._final_shadow(st, jsc, cam_brick, cfg_t)
    res = trace_rays_kernel(origins, dirs, jsc.index_volume, jsc.pool_words,
                            jsc.pool_base, cam_brick, cfg_t.grid, max_iters=2,
                            block=32, interpret=True)
    exh = np.asarray(res["exhausted"]).astype(bool)
    assert exh.any()
    assert int(req["exhausted_rays"]) == int(exh.sum())
    np.testing.assert_array_equal(np.asarray(rgb)[exh], 0.0)


def test_wave_image_matches_oracle_shading(world):
    """Image-level parity vs the scalar oracle (stronger than the BASELINE
    'converged images allclose within noise': the estimator is deterministic
    given its RNG draws, so one wave must match the oracle-traced shade
    pixel-for-pixel)."""
    from brickmap_tpu.ops import sunsky as ss
    from brickmap_tpu.render.sampling import cone_sample

    sc, jsc, cam, arrays, cam_brick = world
    import dataclasses

    cfg0 = CFG.replace(render=dataclasses.replace(CFG.render, max_bounces=0))

    key = jax.random.PRNGKey(21)
    k_pix, k_loop = jax.random.split(key)
    st = pathtrace._primary_state(k_pix, arrays, cfg0, W, H)
    k_loop, k_b = jax.random.split(k_loop)
    st = pathtrace._bounce_step(jnp.int32(0), k_b, st, jsc, cam_brick,
                                arrays["sun_direction"], cfg0)
    rgb, count, _ = pathtrace._final_shadow(st, jsc, cam_brick, cfg0)
    rgb = np.asarray(rgb)

    # Replicate the wave's RNG draws to shade with the oracle.
    origins0 = np.asarray(pathtrace._primary_state(
        k_pix, arrays, cfg0, W, H)["origins"])
    dirs0 = np.asarray(pathtrace._primary_state(
        k_pix, arrays, cfg0, W, H)["dirs"])
    k_cone, _ = jax.random.split(k_b)
    sdirs = np.asarray(cone_sample(k_cone, arrays["sun_direction"],
                                   ss.cone_extent(cfg0.sky), shape=(W * H,)))
    sun_dir = np.asarray(arrays["sun_direction"])
    sunsky_v = np.asarray(ss.sunsky(jnp.asarray(dirs0),
                                    jnp.asarray(sun_dir), cfg0.sky))
    sun_v = np.asarray(ss.sun(jnp.asarray(sdirs), jnp.asarray(sun_dir),
                              cfg0.sky))

    cam_np = np.asarray(cam.brick_position, np.int64)
    eps = cfg0.grid.epsilon
    expected = np.zeros((W * H, 3), np.float32)
    for i in range(0, W * H, 7):
        r = dda_ref.intersect_voxel(origins0[i], dirs0[i], sc, cfg0.grid,
                                    cam_np)
        if not r.hit:
            expected[i] = sunsky_v[i]
            continue
        nrm = r.normal if (r.normal != 0).any() else -dirs0[i]
        hp = origins0[i] + dirs0[i] * r.distance + nrm * (2 * eps)
        cosw = float(nrm @ sdirs[i])
        if cosw <= 0:
            continue
        occ = dda_ref.intersect_voxel(hp, sdirs[i], sc, cfg0.grid, cam_np)
        if not occ.hit:
            expected[i] = sun_v[i] * cosw * 1e-5
    for i in range(0, W * H, 7):
        np.testing.assert_allclose(
            rgb[i], expected[i], atol=5e-4, rtol=2e-3,
            err_msg=f"pixel {i}: o={origins0[i]} d={dirs0[i]}")


def test_rescue_pass_zeroes_exhausted(world, march_on_cpu):
    """The staged wave re-traces budget-exhausted lanes at an escalated
    budget, resuming from the kernel's ``resume_t``: the wave result must
    report ZERO exhausted rays and match the ample-budget render (every
    ray terminates with a defined result, voxel.cuh:135-261)."""
    import dataclasses

    from brickmap_tpu.pallas.march import trace_rays_kernel

    sc, jsc, cam, arrays, cam_brick = world
    cfg_t = CFG.replace(render=dataclasses.replace(
        CFG.render, max_bounces=1, max_top_steps=4, max_brick_steps=0,
        max_byte_steps=0))
    key = jax.random.PRNGKey(35)

    # The starved budget really does exhaust lanes on the raw kernel (the
    # rescue runs INSIDE _trace_stage, so probe the kernel directly)...
    st = pathtrace._primary_state(jax.random.split(key)[0], arrays, cfg_t,
                                  W, H)
    raw = trace_rays_kernel(st["origins"], st["dirs"], jsc.index_volume,
                            jsc.pool_words, jsc.pool_base, cam_brick,
                            cfg_t.grid, max_iters=pathtrace.trace_budget(
                                cfg_t), block=32, interpret=True)
    assert int(np.asarray(raw["exhausted"]).sum()) > 0

    # ...but the wave-level rescue retraces them to completion.
    rgb, count, req = pathtrace.render_wave(key, jsc, arrays, cam_brick,
                                            cfg_t, W, H)
    assert int(req["exhausted_rays"]) == 0

    cfg_hi = CFG.replace(render=dataclasses.replace(
        CFG.render, max_bounces=1))
    rgb_hi, _, _ = pathtrace.render_wave(key, jsc, arrays, cam_brick,
                                         cfg_hi, W, H)
    np.testing.assert_allclose(np.asarray(rgb), np.asarray(rgb_hi),
                               rtol=1e-4, atol=1e-5)


def test_rescue_reports_honestly_when_starved(world, march_on_cpu,
                                              monkeypatch):
    """If even the rescue budget is exhausted, the count must survive to the
    wave result (the harness FAILS on it rather than hiding it)."""
    import dataclasses

    from brickmap_tpu.render import pathtrace as pt

    sc, jsc, cam, arrays, cam_brick = world
    cfg_t = CFG.replace(render=dataclasses.replace(
        CFG.render, max_bounces=0, max_top_steps=2, max_brick_steps=0,
        max_byte_steps=0, rescue_top_steps=2))
    monkeypatch.setattr(pt, "_rescue_cfg", lambda cfg: cfg)
    rgb, count, req = pt.render_wave(jax.random.PRNGKey(36), jsc, arrays,
                                     cam_brick, cfg_t, W, H)
    assert int(req["exhausted_rays"]) > 0
