"""Sparse differentiable renderer: record+replay vs dense compositor + FD.

Every test records through the march kernel in interpret mode (the
``march_on_cpu`` fixture routes the recorder dispatch to it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import GridConfig
from brickmap_tpu.diff.render import composite_rays
from brickmap_tpu.diff.sparse import (
    cell_pool_map,
    composite_sparse,
    l2_loss_and_grads_sparse,
    pool_fields_from_bitmask,
    record_segments,
)

GRID = GridConfig(grid_size=128, grid_height=128)


@pytest.fixture(scope="module")
def sparse_world():
    rng = np.random.default_rng(102)
    """A couple of solid blobs -> a handful of resident bricks."""
    dense = np.zeros((128, 128, 128), bool)
    dense[16:32, 32:64, 32:64] = rng.random((16, 32, 32)) < 0.35
    dense[48:56, 80:96, 40:56] = True
    sc = scene_mod.scene_from_dense(dense, GRID)
    psc = jax.tree.map(jnp.asarray, sc)      # flat device scene
    cellmap = jnp.asarray(cell_pool_map(sc, GRID))
    occ, alb = pool_fields_from_bitmask(sc)
    return dense, sc, psc, cellmap, occ, alb


def rays_toward(rng, n, target=(48, 48, 24), spread=40.0):
    origins = np.array([[64.0, 64.0, 120.0]] * n, np.float32)
    origins += rng.normal(scale=8.0, size=(n, 3)).astype(np.float32)
    aims = np.asarray(target, np.float32) + rng.normal(
        scale=spread, size=(n, 3)).astype(np.float32)
    d = aims - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


def test_record_matches_hard_traversal(sparse_world, march_on_cpu, rng):
    """Recorded segments contain the hard hit's brick cell, front-to-back.

    The recorder lists every NON-EMPTY brick the ray crosses (the compositor
    integrates voxel occupancy inside each one); the hard traversal can pass
    through a non-empty brick without striking a voxel, so the hit cell need
    not be the FIRST segment — it must appear somewhere in the list (unless
    the K budget truncated first), and nd must be non-decreasing.
    """
    from brickmap_tpu.ops.traverse import trace_rays

    dense, sc, psc, *_ = sparse_world
    origins, dirs = rays_toward(rng, 96)
    K = 8
    segs = record_segments(jnp.asarray(origins), jnp.asarray(dirs), psc,
                           GRID, k_segments=K)
    hard = trace_rays(jnp.asarray(origins), jnp.asarray(dirs),
                      jnp.asarray(sc.index_volume),
                      jnp.asarray(sc.pool_words), jnp.asarray(sc.pool_base),
                      jnp.zeros(3, jnp.int32), GRID, max_iters=512)
    count = np.asarray(segs["count"])
    cells = np.asarray(segs["cells"])
    nd = np.asarray(segs["nd"])
    hit = np.asarray(hard["hit"])
    t = np.asarray(hard["t"])
    nrm = np.asarray(hard["normal"])
    for i in np.nonzero(hit)[0]:
        assert count[i] >= 1, i
        c = int(count[i])
        # Front-to-back ordering of entry distances.
        assert (np.diff(nd[i, :c]) >= -1e-4).all(), (i, nd[i, :c])
        # o + d*t in float32 at t~100 carries ~1e-2 of position noise, which
        # can flip the cell across a brick face: accept the cell on either
        # side of the hit face.
        p = origins[i] + dirs[i] * t[i]
        cands = {tuple(np.floor((p - nrm[i] * e) / 8.0).astype(int))
                 for e in (1e-3, 5e-2, -5e-2)}
        got = {(int(w) & 0x3FF, (int(w) >> 10) & 0x3FF,
                (int(w) >> 20) & 0x3FF) for w in cells[i, :c]}
        assert c == K or (got & cands), (i, sorted(got), sorted(cands))


def test_sparse_matches_dense_compositor(sparse_world, march_on_cpu, rng):
    """Binarized sparse composite == dense-grid composite (hard limit)."""
    dense, sc, psc, cellmap, occ, alb = sparse_world
    # Distinct albedo per voxel so ordering errors show up in color.
    rng2 = np.random.default_rng(5)
    alb = rng2.uniform(0.2, 1.0, alb.shape).astype(np.float32)

    # Dense-grid fields equivalent to the sparse ones.
    occ_dense = dense.astype(np.float32) * 0.7
    alb_dense = np.zeros((128, 128, 128, 3), np.float32)
    cm = np.asarray(cell_pool_map(sc, GRID))
    zz, yy, xx = np.nonzero(dense)
    slots = cm[zz // 8, yy // 8, xx // 8]
    lins = (xx % 8) + (yy % 8) * 8 + (zz % 8) * 64
    alb_dense[zz, yy, xx] = alb[slots, lins]
    occ_soft = occ * 0.7

    origins, dirs = rays_toward(rng, 128)
    bg = np.tile(np.array([[0.1, 0.2, 0.3]], np.float32), (128, 1))

    segs = record_segments(jnp.asarray(origins), jnp.asarray(dirs), psc,
                           GRID, k_segments=16)
    assert not (np.asarray(segs["count"]) >= 16).any()  # no truncation here
    rgb_s, trans_s = composite_sparse(
        segs["o_cells"], jnp.asarray(dirs), segs, cellmap,
        jnp.asarray(occ_soft), jnp.asarray(alb), jnp.asarray(bg), GRID,
        k_segments=16)
    rgb_d, trans_d, _ = composite_rays(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ_dense),
        jnp.asarray(alb_dense), jnp.asarray(bg), max_steps=400)
    np.testing.assert_allclose(np.asarray(trans_s), np.asarray(trans_d),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(rgb_s), np.asarray(rgb_d),
                               atol=2e-3)


def test_host_chunked_grads_match_single_program(sparse_world, march_on_cpu,
                                                rng):
    """The donated-accumulator chunk loop == the single-program path.

    The 1080p frame gradient must be host-chunked (a whole-frame backward
    exhausts HBM); chunking and padding must not change loss or grads."""
    dense, sc, psc, cellmap, occ, alb = sparse_world
    occ = occ * 0.7
    alb = alb * 0.5

    n = 700  # deliberately not a multiple of the chunk size below
    origins, dirs = rays_toward(rng, n)
    bg = np.zeros((n, 3), np.float32)
    tgt = np.full((n, 3), 0.3, np.float32)
    args = (jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap,
            jnp.asarray(occ), jnp.asarray(alb), jnp.asarray(bg),
            jnp.asarray(tgt), GRID)

    l1, (go1, ga1) = l2_loss_and_grads_sparse(*args, k_segments=6,
                                              row_replay=False)
    l2, (go2, ga2) = l2_loss_and_grads_sparse(*args, k_segments=6,
                                              host_chunk=256,
                                              row_replay=False)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(go1), np.asarray(go2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ga1), np.asarray(ga2), atol=1e-6)


def test_row_replay_matches_voxel_replay(sparse_world, march_on_cpu, rng):
    """Brick-row-granular replay == voxel-granular replay (loss and grads).

    The row path gathers and scatters one row per (ray, segment) instead
    of one per visited voxel; the math must be identical."""
    dense, sc, psc, cellmap, occ, alb = sparse_world
    occ = occ * 0.7
    rng2 = np.random.default_rng(3)
    alb = rng2.uniform(0.1, 1.0, alb.shape).astype(np.float32)

    n = 700  # not a multiple of the scan slice size
    origins, dirs = rays_toward(rng, n)
    bg = rng2.uniform(0, 1, (n, 3)).astype(np.float32)
    tgt = np.full((n, 3), 0.3, np.float32)
    args = (jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap,
            jnp.asarray(occ), jnp.asarray(alb), jnp.asarray(bg),
            jnp.asarray(tgt), GRID)

    lv, (gov, gav) = l2_loss_and_grads_sparse(*args, k_segments=6,
                                              row_replay=False)
    lr, (gor, gar) = l2_loss_and_grads_sparse(*args, k_segments=6,
                                              host_chunk=256,
                                              row_replay=True)
    np.testing.assert_allclose(float(lv), float(lr), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gov), np.asarray(gor), atol=1e-6)
    np.testing.assert_allclose(np.asarray(gav), np.asarray(gar), atol=1e-6)

    # Cached record/sorts (the optimizer-loop path): fill on first call,
    # reuse on the second with DIFFERENT field values — identical to fresh.
    # The cache keys on ray/target array IDENTITY, so bind them once (as a
    # real optimizer loop does).
    o_j, d_j = jnp.asarray(origins), jnp.asarray(dirs)
    bg_j, tgt_j = jnp.asarray(bg), jnp.asarray(tgt)
    cache: dict = {}
    l2_loss_and_grads_sparse(o_j, d_j, psc, cellmap, jnp.asarray(occ),
                             jnp.asarray(alb), bg_j, tgt_j, GRID,
                             k_segments=6,
                             host_chunk=256, seg_cache=cache)
    assert "geo" in cache
    geo_id = id(cache["geo"])
    occ2 = jnp.asarray(occ * 0.9)
    lc, (goc, gac) = l2_loss_and_grads_sparse(
        o_j, d_j, psc, cellmap, occ2,
        jnp.asarray(alb), bg_j, tgt_j, GRID,
        k_segments=6, host_chunk=256, seg_cache=cache)
    assert id(cache["geo"]) == geo_id            # cache actually reused
    lf, (gof, gaf) = l2_loss_and_grads_sparse(
        jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap, occ2,
        jnp.asarray(alb), jnp.asarray(bg), jnp.asarray(tgt), GRID,
        k_segments=6, host_chunk=256)
    np.testing.assert_allclose(float(lc), float(lf), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(goc), np.asarray(gof), atol=1e-6)
    np.testing.assert_allclose(np.asarray(gac), np.asarray(gaf), atol=1e-6)

    # A warm cache keyed to OTHER rays/targets must refresh, not silently
    # serve the stale geometry: different targets through the
    # same dict give the same answer as a fresh call.
    tgt2 = jnp.asarray(np.full((n, 3), 0.8, np.float32))
    ls, (gos, gas) = l2_loss_and_grads_sparse(
        o_j, d_j, psc, cellmap, occ2, jnp.asarray(alb), bg_j, tgt2, GRID,
        k_segments=6, host_chunk=256, seg_cache=cache)
    lfresh, (gofr, gafr) = l2_loss_and_grads_sparse(
        o_j, d_j, psc, cellmap, occ2, jnp.asarray(alb), bg_j, tgt2, GRID,
        k_segments=6, host_chunk=256)
    np.testing.assert_allclose(float(ls), float(lfresh), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gos), np.asarray(gofr), atol=1e-6)
    np.testing.assert_allclose(np.asarray(gas), np.asarray(gafr), atol=1e-6)


def test_all_miss_frame_loss(sparse_world, march_on_cpu):
    """A frame where every ray misses must still report the sky SSE (the
    n_live == 0 branch must not drop rays [0, n_run) and return 0.0)."""
    dense, sc, psc, cellmap, occ, alb = sparse_world
    n = 300
    rng2 = np.random.default_rng(11)
    # Rays starting above the world pointing straight up: all miss.
    origins = np.array([[64.0, 64.0, 200.0]] * n, np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    bg = rng2.uniform(0, 1, (n, 3)).astype(np.float32)
    tgt = rng2.uniform(0, 1, (n, 3)).astype(np.float32)
    expected = float(np.sum((bg - tgt) ** 2) / (n * 3))

    loss, (go, ga) = l2_loss_and_grads_sparse(
        jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap,
        jnp.asarray(occ * 0.7), jnp.asarray(alb), jnp.asarray(bg),
        jnp.asarray(tgt), GRID, k_segments=6,
        host_chunk=256, row_replay=True)
    np.testing.assert_allclose(float(loss), expected, rtol=1e-5)
    assert float(jnp.max(jnp.abs(go))) == 0.0
    assert float(jnp.max(jnp.abs(ga))) == 0.0


def test_sparse_gradients_fd(sparse_world, march_on_cpu, rng):
    """Finite-difference check of d(loss)/d(occupancy, albedo)."""
    dense, sc, psc, cellmap, occ, alb = sparse_world
    occ = occ * 0.6
    rng2 = np.random.default_rng(9)
    alb = rng2.uniform(0.2, 1.0, alb.shape).astype(np.float32)

    origins, dirs = rays_toward(rng, 48)
    bg = np.zeros((48, 3), np.float32)
    tgt = np.full((48, 3), 0.4, np.float32)

    def loss_np(occ_v, alb_v):
        loss, _ = l2_loss_and_grads_sparse(
            jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap,
            jnp.asarray(occ_v), jnp.asarray(alb_v), jnp.asarray(bg),
            jnp.asarray(tgt), GRID, k_segments=8)
        return float(loss)

    loss, (docc, dalb) = l2_loss_and_grads_sparse(
        jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap,
        jnp.asarray(occ), jnp.asarray(alb), jnp.asarray(bg),
        jnp.asarray(tgt), GRID, k_segments=8)
    docc = np.asarray(docc)
    dalb = np.asarray(dalb)
    assert np.isfinite(float(loss))
    assert np.abs(docc).sum() > 0 and np.abs(dalb).sum() > 0

    h = 1e-3
    # FD over the largest-gradient occupancy entries (visited voxels).
    flat = np.abs(docc).ravel()
    for idx in np.argsort(flat)[-4:]:
        p, l = np.unravel_index(idx, docc.shape)
        occ_p = occ.copy(); occ_p[p, l] += h
        occ_m = occ.copy(); occ_m[p, l] -= h
        fd = (loss_np(occ_p, alb) - loss_np(occ_m, alb)) / (2 * h)
        assert abs(fd - docc[p, l]) < 5e-3 * max(1.0, abs(fd)), \
            (p, l, fd, docc[p, l])

    flat = np.abs(dalb).ravel()
    for idx in np.argsort(flat)[-3:]:
        p, l, c = np.unravel_index(idx, dalb.shape)
        alb_p = alb.copy(); alb_p[p, l, c] += h
        alb_m = alb.copy(); alb_m[p, l, c] -= h
        fd = (loss_np(alb_v=alb_p, occ_v=occ) - loss_np(alb_v=alb_m,
                                                        occ_v=occ)) / (2 * h)
        assert abs(fd - dalb[p, l, c]) < 5e-3 * max(1.0, abs(fd)), \
            (p, l, c, fd, dalb[p, l, c])


def test_record_slot_tables_parity(sparse_world, march_on_cpu, rng):
    """Each recorded segment's global pool row must equal
    pool_base[superchunk] + (index_word & 0xFFF) for loaded cells and -1
    otherwise, and the kernel's record mode must match the XLA recorder."""
    from brickmap_tpu.ops.record import record_segments_xla

    dense, sc, psc, *_ = sparse_world
    origins, dirs = rays_toward(rng, 128)
    K = 8
    segs = record_segments(jnp.asarray(origins), jnp.asarray(dirs), psc,
                           GRID, k_segments=K)

    iv = np.asarray(sc.index_volume)
    base = np.asarray(sc.pool_base)
    s = GRID.supergrid_cell_size
    cells = np.asarray(segs["cells"])
    slots = np.asarray(segs["slot"])
    count = np.asarray(segs["count"])
    for i in range(cells.shape[0]):
        for k in range(int(count[i])):
            c = int(cells[i, k])
            x, y, z = c & 0x3FF, (c >> 10) & 0x3FF, (c >> 20) & 0x3FF
            w = int(iv[z, y, x])
            sc_id = (x // s) + (y // s) * GRID.supergrid_xy \
                + (z // s) * GRID.supergrid_xy ** 2
            want = base[sc_id] + (w & 0xFFF) if w & 0x8000_0000 else -1
            assert slots[i, k] == want, (i, k, x, y, z)
        assert (slots[i, int(count[i]):] == -1).all()

    ref = record_segments_xla(jnp.asarray(origins), jnp.asarray(dirs),
                              psc.index_volume, psc.pool_base, GRID,
                              k_segments=K)
    for name in ("cells", "nd", "ncode", "slot", "count"):
        np.testing.assert_array_equal(np.asarray(segs[name]),
                                      np.asarray(ref[name]), err_msg=name)


def test_traced_scan_chunking_matches_host(sparse_world, march_on_cpu, rng):
    """Traced inputs larger than host_chunk must take the bounded-memory
    scan path and match the host-chunked gradients."""
    from functools import partial as _partial

    dense, sc, psc, cellmap, occ, alb = sparse_world
    n = 256
    origins, dirs = rays_toward(rng, n)
    occ_j = jnp.asarray(occ * 0.7)
    alb_j = jnp.asarray(alb * 0.5)
    bg = jnp.zeros((n, 3), jnp.float32)
    tgt = jnp.full((n, 3), 0.3, jnp.float32)
    args = (jnp.asarray(origins), jnp.asarray(dirs), psc, cellmap,
            occ_j, alb_j, bg, tgt)

    # Reference: eager single-program path (n <= host_chunk).
    l_ref, (do_ref, da_ref) = l2_loss_and_grads_sparse(
        *args, grid=GRID, k_segments=8)

    # Traced + n > host_chunk -> the scan path.
    jitted = jax.jit(l2_loss_and_grads_sparse,
                     static_argnames=("grid", "k_segments", "host_chunk"))
    l_t, (do_t, da_t) = jitted(*args, grid=GRID, k_segments=8,
                               host_chunk=64)
    np.testing.assert_allclose(float(l_t), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(do_t), np.asarray(do_ref),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(da_t), np.asarray(da_ref),
                               rtol=1e-4, atol=1e-7)


def test_traced_row_scan_realistic_shard(sparse_world, march_on_cpu, rng):
    """The traced replay path at a 1080p-shard-sized ray count (259,200 =
    1920*1080/8): the
    bounded-memory scan must compile and run at realistic shard size, and
    its loss/grads must scale exactly with ray tiling."""
    from brickmap_tpu.diff.sparse import (_pack_field2, _row_scan_grads_jit,
                                          _finalize2)

    dense, sc, psc, cellmap, occ, alb = sparse_world
    occ = occ * 0.7
    rng2 = np.random.default_rng(21)
    alb = rng2.uniform(0.1, 1.0, alb.shape).astype(np.float32)
    field2 = _pack_field2(jnp.asarray(occ), jnp.asarray(alb))

    # Record a small batch once (the interpreted kernel is the slow part),
    # then tile the recorded geometry to shard size.
    n0 = 800
    K = 6
    origins, dirs = rays_toward(rng, n0)
    bg = rng2.uniform(0, 1, (n0, 3)).astype(np.float32)
    tgt = rng2.uniform(0, 1, (n0, 3)).astype(np.float32)
    segs = record_segments(jnp.asarray(origins), jnp.asarray(dirs), psc,
                           GRID, k_segments=K)

    base = (np.asarray(segs["o_cells"]), dirs, np.asarray(segs["cells"]),
            np.asarray(segs["nd"]), np.asarray(segs["ncode"]),
            np.asarray(segs["entry_normal"]), bg, tgt)
    b_j = [jnp.asarray(a) for a in base]
    sse0, df0 = _row_scan_grads_jit(
        b_j[0], b_j[1], b_j[2], b_j[3], b_j[4], b_j[5], cellmap, field2,
        b_j[6], b_j[7], GRID, K, chunk=800)

    n = 259_200
    reps = -(-n // n0)
    tiled = tuple(jnp.asarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n])
                  for a in (base[0], base[1], base[2], base[3], base[4],
                            base[5], base[6], base[7]))
    # Production traced-path slice size (diff/sparse.py host_chunk clamp).
    sse, dfield2 = _row_scan_grads_jit(
        tiled[0], tiled[1], tiled[2], tiled[3], tiled[4], tiled[5],
        cellmap, field2, tiled[6], tiled[7], GRID, K, chunk=8192)
    assert np.isfinite(float(sse))
    assert np.isfinite(np.asarray(dfield2)).all()
    # 324 full tiles exactly cover 259,200 = 324 * 800: scale must be exact.
    np.testing.assert_allclose(float(sse), 324.0 * float(sse0), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(dfield2), 324.0 * np.asarray(df0),
                               rtol=2e-3, atol=2e-4)
