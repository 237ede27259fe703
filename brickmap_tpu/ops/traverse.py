"""Vectorized hierarchical DDA traversal for ray batches.

The XLA reference of the reference's per-thread nested traversal
(``voxel.cuh:135-261``): all rays advance in lockstep through ONE
``lax.while_loop``; each ray carries a ``level`` state:

* level 0 — top DDA over the brick grid (voxel.cuh:192-259)
* level 1 — 2x2x2 DDA over the index word's LoD byte (voxel.cuh:26-77)
* level 2 — 8x8x8 DDA over brick occupancy bits (voxel.cuh:79-133)

The reference's commented-out "restartless" experiment (voxel.cuh:272-479) had
the same motivation; here it is the natural formulation, because a vectorized
nested loop would run every inner iteration for every lane.  Each iteration does
exactly one cell test + one step per ray, at whatever level the ray is in, with
two O(N) gathers (index word, brick word).  Every piece of loop state is a
separate [N] array, so every op is a dense elementwise op.

On a GPU the same state machine runs per ray block inside one kernel
(:mod:`brickmap_tpu.pallas.march`); this version is its reference and the
CPU path.

Numerics, tie-breaking, LoD selection, epsilon offsets, and the streaming
request path match the scalar oracle (:mod:`brickmap_tpu.ops.dda_ref`) —
property-tested against it ray-for-ray.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import (
    BRICK_DIST_SHIFT,
    BRICK_FLAG_BITS,
    BRICK_INDEX_BITS,
    BRICK_LOADED_BIT,
    BRICK_LOD_SHIFT,
    BRICK_UNLOADED_BIT,
    GridConfig,
)

BIG = 1_000_000.0

__all__ = ["trace_rays", "aabb_clip", "top_step"]


def _sel3(ax, x, y, z):
    """Component select: value of (x, y, z) at axis index ax (all [N])."""
    return jnp.where(ax == 0, x, jnp.where(ax == 1, y, z))


def _sel4(idx, a0, a1, a2, a3, a4, a5, a6, a7):
    """8-way select on the low 3 bits of idx (where-tree)."""
    lo = jnp.where((idx & 1) != 0,
                   jnp.where((idx & 2) != 0, a3, a1),
                   jnp.where((idx & 2) != 0, a2, a0))
    hi = jnp.where((idx & 1) != 0,
                   jnp.where((idx & 2) != 0, a7, a5),
                   jnp.where((idx & 2) != 0, a6, a4))
    return jnp.where((idx & 4) != 0, hi, lo)


def _sel_axis(tx, ty, tz):
    """Reference step-axis priority (voxel.cuh:249): x iff strictly smallest,
    else y iff y<=x and y<z, else z."""
    return jnp.where(tx < ty, jnp.where(tx < tz, 0, 2),
                     jnp.where(ty < tz, 1, 2)).astype(jnp.int32)


def top_step(px, py, pz, tx, ty, tz, d3, si3, td3, skip_r, use_skip,
             grid: GridConfig):
    """One top-level DDA advance: a single cell step, or an empty-space jump.

    Empty-space skipping: with skip radius R >= 1, all cells within L-inf
    distance R of the current cell are empty, so jump every axis by its
    crossing count up to the first crossing that exits the safe box (time
    t_exit = min_a (tmax_a + R*tdelta_a)).  k_a uses the same tmax/tdelta
    arithmetic as single stepping, so arrival state matches sequential DDA
    to float rounding.  Pure ``jnp`` on same-shape arrays: the XLA paths and
    the Pallas kernel (:mod:`brickmap_tpu.pallas.march`) share it.

    Returns (pxn, pyn, pzn, txn, tyn, tzn, last crossing axis, exited world).
    """
    f32, i32 = jnp.float32, jnp.int32
    dx, dy, dz = d3
    six, siy, siz = si3
    tdx, tdy, tdz = td3
    rf = skip_r.astype(f32)
    t_exit = jnp.minimum(
        jnp.minimum(jnp.where(dx != 0, tx + rf * tdx, BIG),
                    jnp.where(dy != 0, ty + rf * tdy, BIG)),
        jnp.where(dz != 0, tz + rf * tdz, BIG))

    def k_axis(d, t, td):
        k = jnp.where(
            d != 0.0,
            jnp.floor((t_exit - t) / jnp.where(td == 0, 1.0, td))
            .astype(i32) + 1,
            0)
        return jnp.clip(k, 0, skip_r + 1)

    t_axis = _sel_axis(tx, ty, tz)
    kx1 = jnp.where(t_axis == 0, 1, 0)
    ky1 = jnp.where(t_axis == 1, 1, 0)
    kz1 = jnp.where(t_axis == 2, 1, 0)
    kx = jnp.where(use_skip, k_axis(dx, tx, tdx), kx1)
    ky = jnp.where(use_skip, k_axis(dy, ty, tdy), ky1)
    kz = jnp.where(use_skip, k_axis(dz, tz, tdz), kz1)
    # FP guard: a degenerate skip that moves nowhere falls back to 1 step.
    stuck = use_skip & (kx + ky + kz == 0)
    kx = jnp.where(stuck, kx1, kx)
    ky = jnp.where(stuck, ky1, ky)
    kz = jnp.where(stuck, kz1, kz)

    pxn = px + six * kx
    pyn = py + siy * ky
    pzn = pz + siz * kz
    txn = tx + kx.astype(f32) * tdx
    tyn = ty + ky.astype(f32) * tdy
    tzn = tz + kz.astype(f32) * tdz
    # Last crossing axis = latest crossing time among stepped axes.
    # Tie-break is z-priority; sequential stepping would land on x for
    # exactly-tied crossings (axis-diagonal rays on integer coordinates),
    # an FP-measure-zero deviation affecting only the hit normal.
    neg = jnp.float32(-BIG)
    tlx = jnp.where(kx > 0, txn - tdx, neg)
    tly = jnp.where(ky > 0, tyn - tdy, neg)
    tlz = jnp.where(kz > 0, tzn - tdz, neg)
    t_axis = jnp.where(
        tlx > tly,
        jnp.where(tlx > tlz, 0, 2),
        jnp.where(tly > tlz, 1, 2)).astype(i32)
    # Out-of-bounds: with jumps the landing cell can overshoot the exact
    # boundary cell, so test crossing rather than equality.
    cx_max, cy_max, cz_max = grid.cells, grid.cells, grid.cells_height
    exited = (((dx > 0) & (pxn >= cx_max)) | ((dx < 0) & (pxn < 0))
              | ((dy > 0) & (pyn >= cy_max)) | ((dy < 0) & (pyn < 0))
              | ((dz > 0) & (pzn >= cz_max)) | ((dz < 0) & (pzn < 0)))
    return pxn, pyn, pzn, txn, tyn, tzn, t_axis, exited


def aabb_clip(origin, direction, grid: GridConfig):
    """Slab clip + analytic entry-face normal (voxel.cuh:13-24, 142-155).

    Returns (hit, tminn, clipped_origin [N,3], entry_normal [N,3]); origins
    advanced to the entry point and nudged inside by epsilon when starting
    outside.
    """
    box_max = jnp.asarray(grid.world_max, jnp.float32)
    t1 = (0.0 - origin) / direction
    t2 = (box_max[None, :] - origin) / direction
    # fmin/fmax ignore NaN (origin exactly on a slab plane with direction 0
    # yields 0/0): matches the oracle's np.fmin/np.fmax (dda_ref.py:79-80) and
    # the CUDA fminf/fmaxf semantics (voxel.cuh:13-24).
    tmin3 = jnp.fmin(t1, t2)
    tmax3 = jnp.fmax(t1, t2)
    tminn = jnp.maximum(
        jnp.maximum(tmin3[:, 0], 0.0), jnp.maximum(tmin3[:, 1], tmin3[:, 2])
    ).astype(jnp.float32)
    hit = jnp.min(tmax3, axis=1) > tminn

    outside = tminn > 0
    adv = origin + direction * tminn[:, None]
    gs, gh = float(grid.grid_size), float(grid.grid_height)
    scale = jnp.asarray([gh / gs, gh / gs, 1.0], jnp.float32)
    center = jnp.asarray([gs / 2, gs / 2, gh / 2], jnp.float32)
    to_center = jnp.abs(center - adv) * scale
    signs = jnp.sign(adv - center)
    to_center = to_center / jnp.max(to_center, axis=1, keepdims=True)
    entry_normal = signs * jnp.trunc(to_center + 1e-6)
    entry_normal = jnp.where(outside[:, None], entry_normal, 0.0)

    clipped = jnp.where(
        outside[:, None], adv - entry_normal * grid.epsilon, origin
    )
    return hit, tminn, clipped, entry_normal


@partial(jax.jit, static_argnames=("grid", "max_iters", "use_lod", "use_ess"))
def trace_rays(origin, direction, index_volume, pool_words, pool_base,
               camera_brick_pos, grid: GridConfig, max_iters: int = 4096,
               use_lod: bool = True, use_ess: bool = True):
    """Trace a batch of rays through the two-level sparse grid.

    Args:
      origin, direction: float32 [N, 3] world-space rays (direction need not be
        normalized — same contract as the reference).
      index_volume: uint32 [CZ, CY, CX] packed index words.
      pool_words: uint32 [P, cell_members] linear brick pool.
      pool_base: int32 [num_superchunks] segment base offsets.
      camera_brick_pos: int32 [3] camera position // brick_size (LoD origin).
      max_iters: static bound on total per-ray iterations.
      use_lod: if False, distance-based LoD is disabled (always finest).

    Returns a dict: hit [N] bool, t [N] f32 (world units), normal [N, 3] f32,
    request [N] bool + request_pos [N, 3] i32 (bricks needing residency),
    iters [] i32 (loop iterations executed).
    """
    n = origin.shape[0]
    f32, i32 = jnp.float32, jnp.int32
    eps = jnp.float32(grid.epsilon)
    bsz = grid.brick_size
    cx_max, cy_max, cz_max = grid.cells, grid.cells, grid.cells_height
    s = grid.supergrid_cell_size

    ok, tminn, clipped, entry_normal = aabb_clip(origin, direction, grid)

    # ---- componentized constants -------------------------------------------
    ox = clipped[:, 0] / bsz
    oy = clipped[:, 1] / bsz
    oz = clipped[:, 2] / bsz
    dx = direction[:, 0].astype(f32)
    dy = direction[:, 1].astype(f32)
    dz = direction[:, 2].astype(f32)

    def setup(d):
        stepf = jnp.sign(d)
        rd = jnp.where(d == 0.0, 0.0, 1.0 / d).astype(f32)
        return stepf, stepf.astype(i32), rd, stepf * rd

    sfx, six, rdx, tdx = setup(dx)
    sfy, siy, rdy, tdy = setup(dy)
    sfz, siz, rdz, tdz = setup(dz)

    def dda_init(o, d, rd):
        p = jnp.trunc(o).astype(i32)
        cb = jnp.where(d > 0, p.astype(f32) + 1.0, p.astype(f32))
        t = jnp.where(d != 0.0, (cb - o) * rd, jnp.float32(BIG))
        return p, t

    px, tx = dda_init(ox, dx, rdx)
    py, ty = dda_init(oy, dy, rdy)
    pz, tz = dda_init(oz, dz, rdz)
    outx = jnp.where(dx > 0, cx_max, -1)
    outy = jnp.where(dy > 0, cy_max, -1)
    outz = jnp.where(dz > 0, cz_max, -1)

    inside = ((px >= 0) & (px < cx_max) & (py >= 0) & (py < cy_max)
              & (pz >= 0) & (pz < cz_max))
    active0 = ok & inside

    camx, camy, camz = (jnp.asarray(camera_brick_pos, i32)[k] for k in range(3))

    iv_flat = index_volume.reshape(-1)

    enx, eny, enz = (entry_normal[:, k].astype(f32) for k in range(3))

    zero_f = jnp.zeros(n, f32)
    zero_i = jnp.zeros(n, i32)

    state = dict(
        it=jnp.int32(0),
        active=active0, level=zero_i,
        px=px, py=py, pz=pz, tx=tx, ty=ty, tz=tz,
        axis0=jnp.full(n, -1, i32),
        nx=enx, ny=eny, nz=enz,          # current normal candidate
        nd=zero_f,
        sx=zero_i, sy=zero_i, sz=zero_i,
        stx=jnp.full(n, BIG, f32), sty=jnp.full(n, BIG, f32),
        stz=jnp.full(n, BIG, f32),
        axs=jnp.full(n, -1, i32),
        bw=tuple(jnp.zeros(n, jnp.uint32) for _ in range(16)),
        lodbyte=zero_i,
        hit=jnp.zeros(n, bool), t=zero_f,
        onx=zero_f, ony=zero_f, onz=zero_f,
        request=jnp.zeros(n, bool),
        rqx=zero_i, rqy=zero_i, rqz=zero_i,
    )

    def cond(st):
        return jnp.logical_and(st["it"] < max_iters, jnp.any(st["active"]))

    def body(st):
        active = st["active"]
        level = st["level"]
        px, py, pz = st["px"], st["py"], st["pz"]
        tx, ty, tz = st["tx"], st["ty"], st["tz"]
        axis0 = st["axis0"]

        # ---- top-level cell fetch -------------------------------------
        pcx = jnp.clip(px, 0, cx_max - 1)
        pcy = jnp.clip(py, 0, cy_max - 1)
        pcz = jnp.clip(pz, 0, cz_max - 1)
        word = jnp.take(iv_flat, (pcz * cy_max + pcy) * cx_max + pcx, axis=0)
        is_top = (level == 0) & active
        # Occupied iff a residency flag is set (the reference tests
        # `if (index)`, voxel.cuh:200; empty cells carry ESS distance bits).
        occ0 = is_top & ((word & jnp.uint32(BRICK_FLAG_BITS)) != 0)
        # Chebyshev skip radius for empty cells (scene.chebyshev_distance_field).
        skip_r = jnp.maximum(
            ((word >> BRICK_DIST_SHIFT) & jnp.uint32(0x1FF)).astype(i32) - 1, 0)

        # Crossing t + face normal of the current top cell (voxel.cuh:200-206).
        entered = axis0 >= 0
        t_ax = _sel3(axis0, tx, ty, tz)
        td_ax = _sel3(axis0, tdx, tdy, tdz)
        nd_new = jnp.where(entered, t_ax - td_ax, 0.0)
        sf_ax = _sel3(axis0, sfx, sfy, sfz)
        ntx = jnp.where(entered, jnp.where(axis0 == 0, -sf_ax, 0.0), st["nx"])
        nty = jnp.where(entered, jnp.where(axis0 == 1, -sf_ax, 0.0), st["ny"])
        ntz = jnp.where(entered, jnp.where(axis0 == 2, -sf_ax, 0.0), st["nz"])

        # LoD by squared camera distance in brick units (voxel.cuh:208-215).
        dxc, dyc, dzc = camx - px, camy - py, camz - pz
        d2 = dxc * dxc + dyc * dyc + dzc * dzc
        if use_lod:
            far = d2 > grid.lod_distance_8
            mid = (~far) & (d2 > grid.lod_distance_2)
        else:
            far = jnp.zeros(n, bool)
            mid = jnp.zeros(n, bool)
        near = ~far & ~mid
        loaded = (word & jnp.uint32(BRICK_LOADED_BIT)) != 0
        unloaded = (word & jnp.uint32(BRICK_UNLOADED_BIT)) != 0

        hit_far = occ0 & far
        descend_byte = occ0 & mid
        descend_brick = occ0 & near & loaded
        hit_unloaded = occ0 & near & ~loaded & unloaded
        top_advance = is_top & ~(hit_far | descend_byte | descend_brick
                                 | hit_unloaded)

        # ---- sub-level occupancy test ---------------------------------
        # Brick words were row-gathered at descend time into 16 [N] registers;
        # per-step word selection is a log2(16)-deep where-tree (cheap VPU ops)
        # instead of a per-lane HBM gather per iteration.
        is_sub = (level > 0) & active
        sx, sy, sz = st["sx"], st["sy"], st["sz"]
        stx, sty, stz = st["stx"], st["sty"], st["stz"]
        axs = st["axs"]
        lin_byte = jnp.clip(sx + sy * 2 + sz * 4, 0, 7)
        occ_byte = (st["lodbyte"] >> lin_byte) & 1
        lin_brick = jnp.clip(sx + sy * bsz + sz * bsz * bsz, 0, bsz ** 3 - 1)
        widx = lin_brick // 32
        bw = st["bw"]
        sel8 = jnp.where((widx & 8) != 0,
                         _sel4(widx, bw[8], bw[9], bw[10], bw[11], bw[12],
                               bw[13], bw[14], bw[15]),
                         _sel4(widx, bw[0], bw[1], bw[2], bw[3], bw[4],
                               bw[5], bw[6], bw[7]))
        occ_brick = (sel8 >> (lin_brick % 32).astype(jnp.uint32)) & 1
        occ_sub = jnp.where(level == 1, occ_byte != 0, occ_brick != 0) & is_sub

        sub_hit = occ_sub
        sub_advance = is_sub & ~occ_sub

        # ---- sub hit: distance/normal (voxel.cuh:58-63, 114-119) ------
        s_entered = axs >= 0
        st_ax = _sel3(axs, stx, sty, stz)
        std_ax = _sel3(axs, tdx, tdy, tdz)
        sub_t = jnp.where(s_entered, st_ax - std_ax, 0.0)
        ssf_ax = _sel3(axs, sfx, sfy, sfz)
        snx = jnp.where(s_entered, jnp.where(axs == 0, -ssf_ax, 0.0), st["nx"])
        sny = jnp.where(s_entered, jnp.where(axs == 1, -ssf_ax, 0.0), st["ny"])
        snz = jnp.where(s_entered, jnp.where(axs == 2, -ssf_ax, 0.0), st["nz"])
        sub_scale = jnp.where(level == 1, 4.0, 1.0).astype(f32)
        sub_hit_t = st["nd"] * bsz + sub_t * sub_scale + tminn

        # ---- sub step -------------------------------------------------
        s_axis = _sel_axis(stx, sty, stz)
        sub_extent = jnp.where(level == 1, 2, bsz)
        sxn = sx + jnp.where(s_axis == 0, six, 0)
        syn = sy + jnp.where(s_axis == 1, siy, 0)
        szn = sz + jnp.where(s_axis == 2, siz, 0)
        s_out_x = jnp.where(dx > 0, sub_extent, -1)
        s_out_y = jnp.where(dy > 0, sub_extent, -1)
        s_out_z = jnp.where(dz > 0, sub_extent, -1)
        s_exited = (_sel3(s_axis, sxn, syn, szn)
                    == _sel3(s_axis, s_out_x, s_out_y, s_out_z))
        stxn = stx + jnp.where(s_axis == 0, tdx, 0.0)
        styn = sty + jnp.where(s_axis == 1, tdy, 0.0)
        stzn = stz + jnp.where(s_axis == 2, tdz, 0.0)

        ascend = sub_advance & s_exited

        # ---- top step (empty cell, or sub-DDA exited) -----------------
        do_top_step = top_advance | ascend
        use_skip = top_advance & ~occ0 & (skip_r >= 1) if use_ess \
            else jnp.zeros(n, bool)
        pxn, pyn, pzn, txn, tyn, tzn, t_axis, t_exited = top_step(
            px, py, pz, tx, ty, tz, (dx, dy, dz), (six, siy, siz),
            (tdx, tdy, tdz), skip_r, use_skip, grid)
        miss = do_top_step & t_exited

        # ---- descend setup --------------------------------------------
        # Byte level: hit*(2) - normal*0.2*eps (voxel.cuh:217);
        # brick level: hit*(8) - normal*eps (voxel.cuh:224).
        descend = descend_byte | descend_brick
        d_scale = jnp.where(descend_byte, 2.0, float(bsz))
        n_eps = jnp.where(descend_byte, 0.2 * eps, eps)
        d_ext = jnp.where(descend_byte, 2, bsz)

        def descend_axis(o, d, rd, nt):
            so = (o + d * nd_new) * d_scale - nt * n_eps
            p = jnp.trunc(so).astype(i32)
            cb = jnp.where(d > 0, p.astype(f32) + 1.0, p.astype(f32))
            t = jnp.where(d != 0.0, (cb - so) * rd, jnp.float32(BIG))
            # C trunc-mod (the epsilon-nudged origin can be slightly
            # negative at the grid's zero faces; np.fmod semantics).
            pl = jnp.where(p >= 0, p - (p // d_ext) * d_ext,
                           -((-p) - ((-p) // d_ext) * d_ext))
            return pl, t

        sdx, sdtx = descend_axis(ox, dx, rdx, ntx)
        sdy, sdty = descend_axis(oy, dy, rdy, nty)
        sdz, sdtz = descend_axis(oz, dz, rdz, ntz)

        sc_id = jnp.clip(
            px // s + (py // s) * grid.supergrid_xy
            + (pz // s) * grid.supergrid_xy ** 2,
            0, grid.num_superchunks - 1)
        gslot_d = (jnp.take(pool_base, sc_id, axis=0)
                   + (word & jnp.uint32(BRICK_INDEX_BITS)).astype(i32))
        # Row-gather the descending lanes' brick payloads (64 B contiguous per
        # lane — far cheaper than per-word scalar gathers every iteration).
        # Skipped entirely on iterations where no lane descends into a brick.
        def fetch_rows(_):
            safe = jnp.where(descend_brick, gslot_d, 0)
            return jnp.take(pool_words, safe, axis=0)  # [N, 16]

        rows = jax.lax.cond(
            jnp.any(descend_brick), fetch_rows,
            lambda _: jnp.zeros((n, grid.cell_members), jnp.uint32), None)
        bw_new = tuple(
            jnp.where(descend_brick, rows[:, k], bw[k]) for k in range(16))

        # ---- merge state ----------------------------------------------
        coarse_hit = hit_far | hit_unloaded
        terminal = coarse_hit | sub_hit
        new_hit = st["hit"] | terminal
        new_t = jnp.where(coarse_hit, nd_new * bsz + tminn, st["t"])
        new_t = jnp.where(sub_hit, sub_hit_t, new_t)
        new_onx = jnp.where(coarse_hit, ntx, st["onx"])
        new_ony = jnp.where(coarse_hit, nty, st["ony"])
        new_onz = jnp.where(coarse_hit, ntz, st["onz"])
        new_onx = jnp.where(sub_hit, snx, new_onx)
        new_ony = jnp.where(sub_hit, sny, new_ony)
        new_onz = jnp.where(sub_hit, snz, new_onz)

        new_request = st["request"] | hit_unloaded
        new_rqx = jnp.where(hit_unloaded, px, st["rqx"])
        new_rqy = jnp.where(hit_unloaded, py, st["rqy"])
        new_rqz = jnp.where(hit_unloaded, pz, st["rqz"])

        new_active = active & ~terminal & ~miss
        new_level = jnp.where(descend_byte, 1,
                              jnp.where(descend_brick, 2,
                                        jnp.where(ascend, 0, level)))

        return dict(
            it=st["it"] + 1,
            active=new_active, level=new_level,
            px=jnp.where(do_top_step, pxn, px),
            py=jnp.where(do_top_step, pyn, py),
            pz=jnp.where(do_top_step, pzn, pz),
            tx=jnp.where(do_top_step, txn, tx),
            ty=jnp.where(do_top_step, tyn, ty),
            tz=jnp.where(do_top_step, tzn, tz),
            axis0=jnp.where(do_top_step, t_axis, axis0),
            nx=jnp.where(descend, ntx, st["nx"]),
            ny=jnp.where(descend, nty, st["ny"]),
            nz=jnp.where(descend, ntz, st["nz"]),
            nd=jnp.where(descend, nd_new, st["nd"]),
            sx=jnp.where(descend, sdx, jnp.where(sub_advance, sxn, sx)),
            sy=jnp.where(descend, sdy, jnp.where(sub_advance, syn, sy)),
            sz=jnp.where(descend, sdz, jnp.where(sub_advance, szn, sz)),
            stx=jnp.where(descend, sdtx, jnp.where(sub_advance, stxn, stx)),
            sty=jnp.where(descend, sdty, jnp.where(sub_advance, styn, sty)),
            stz=jnp.where(descend, sdtz, jnp.where(sub_advance, stzn, stz)),
            axs=jnp.where(descend, -1, jnp.where(sub_advance, s_axis, axs)),
            bw=bw_new,
            lodbyte=jnp.where(
                descend_byte,
                ((word >> BRICK_LOD_SHIFT) & 0xFF).astype(i32),
                st["lodbyte"]),
            hit=new_hit, t=new_t,
            onx=new_onx, ony=new_ony, onz=new_onz,
            request=new_request, rqx=new_rqx, rqy=new_rqy, rqz=new_rqz,
        )

    final = jax.lax.while_loop(cond, body, state)
    return dict(
        hit=final["hit"],
        t=final["t"],
        normal=jnp.stack([final["onx"], final["ony"], final["onz"]], axis=1),
        request=final["request"],
        request_pos=jnp.stack([final["rqx"], final["rqy"], final["rqz"]],
                              axis=1),
        iters=final["it"],
        exhausted=final["active"],
        # XLA paths never resume (re-trace from the origin); zeros keep the
        # result pytree identical to the march kernel's for shared callers.
        resume_t=jnp.zeros_like(final["t"]),
    )
