"""Per-ray-block hierarchical DDA kernel (Pallas through Triton).

The reference traverses with one CUDA thread per ray running the nested
brick-grid -> LoD byte -> 8^3 brick DDA (``voxel.cuh:135-261``).  This kernel
keeps that shape: each Triton program takes a power-of-two block of rays and
runs :func:`brickmap_tpu.ops.traverse.trace_rays`' level state machine in a
``while_loop`` inside the kernel until every ray of the block has finished.
Ray state stays in registers; index words, pool bases and brick words come
from masked gather loads straight from the flat
:class:`~brickmap_tpu.scene.VoxelScene` arrays in global memory (most of the
index volume sits in L2).  The XLA ``while_loop`` version instead streams
every state array through device memory on every iteration and makes each
lane wait for the slowest ray of the whole batch.

The arithmetic is ``trace_rays``' (ESS skip distances in index-word bits
28:20, LoD pick, streaming requests), and the empty-space jump is the shared
:func:`~brickmap_tpu.ops.traverse.top_step`.  Reciprocal directions are
computed outside the kernel so that both paths divide the same way.

``record=True`` turns the same cell march into the segment recorder of the
sparse inverse step: every occupied cell crossed is appended (packed cell,
entry distance, entry-face axis, global pool row) to the ray's K output
slots instead of being descended into, and the ray continues.  LoD does not
apply there: the compositor integrates every brick the ray touches.

Index words use bit 31, so they stay ``uint32`` and every shift is logical.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import (
    BRICK_DIST_SHIFT,
    BRICK_FLAG_BITS,
    BRICK_INDEX_BITS,
    BRICK_LOADED_BIT,
    BRICK_LOD_SHIFT,
    BRICK_UNLOADED_BIT,
    GridConfig,
)
from ..ops.record import record_budget
from ..ops.traverse import BIG, _sel3, _sel_axis, aabb_clip, top_step

__all__ = ["trace_rays_kernel", "record_segments_kernel"]


def _make_kernel(grid: GridConfig, *, max_iters: int, use_lod: bool,
                 use_ess: bool, record: bool, k_segments: int, block: int):
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    eps = float(grid.epsilon)
    bsz = grid.brick_size
    cm = grid.cell_members
    cx_max, cy_max, cz_max = grid.cells, grid.cells, grid.cells_height
    s = grid.supergrid_cell_size
    sxy = grid.supergrid_xy
    nsc = grid.num_superchunks

    def kernel(*refs):
        if record:
            (iv_ref, base_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
             dz_ref, rdx_ref, rdy_ref, rdz_ref, act_ref,
             cell_ref, nd_ref, ncode_ref, slot_ref, count_ref, exh_ref,
             iters_ref) = refs
        else:
            (cam_ref, iv_ref, pool_ref, base_ref, ox_ref, oy_ref, oz_ref,
             dx_ref, dy_ref, dz_ref, rdx_ref, rdy_ref, rdz_ref, enx_ref,
             eny_ref, enz_ref, act_ref,
             hit_ref, t_ref, nx_ref, ny_ref, nz_ref, req_ref, rqx_ref,
             rqy_ref, rqz_ref, exh_ref, resume_ref, iters_ref) = refs

        ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
        dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

        def setup(d, rd):
            sf = jnp.where(d > 0, 1.0, jnp.where(d < 0, -1.0, 0.0)).astype(f32)
            return sf, sf.astype(i32), rd, sf * rd

        sfx, six, rdx, tdx = setup(dx, rdx_ref[...])
        sfy, siy, rdy, tdy = setup(dy, rdy_ref[...])
        sfz, siz, rdz, tdz = setup(dz, rdz_ref[...])
        d3, si3, td3 = (dx, dy, dz), (six, siy, siz), (tdx, tdy, tdz)

        def dda_init(o, d, rd):
            p = jnp.trunc(o).astype(i32)
            cb = jnp.where(d > 0, p.astype(f32) + 1.0, p.astype(f32))
            t = jnp.where(d != 0.0, (cb - o) * rd, f32(BIG))
            return p, t

        px, tx = dda_init(ox, dx, rdx)
        py, ty = dda_init(oy, dy, rdy)
        pz, tz = dda_init(oz, dz, rdz)
        inside = ((px >= 0) & (px < cx_max) & (py >= 0) & (py < cy_max)
                  & (pz >= 0) & (pz < cz_max))
        active0 = (act_ref[...] != 0) & inside

        zero_f = jnp.zeros((block,), f32)
        zero_i = jnp.zeros((block,), i32)
        lanes = jax.lax.broadcasted_iota(i32, (block,), 0)

        def cell_word(st):
            """Index word of each lane's current top cell (masked gather)."""
            pcx = jnp.clip(st["px"], 0, cx_max - 1)
            pcy = jnp.clip(st["py"], 0, cy_max - 1)
            pcz = jnp.clip(st["pz"], 0, cz_max - 1)
            word = plgpu.load(iv_ref.at[(pcz * cy_max + pcy) * cx_max + pcx],
                              mask=st["active"], other=0)
            sc_id = jnp.clip(
                jax.lax.div(pcx, i32(s)) + jax.lax.div(pcy, i32(s)) * sxy
                + jax.lax.div(pcz, i32(s)) * sxy * sxy, 0, nsc - 1)
            return word, sc_id

        def entry(st):
            """Crossing t + face axis of the current top cell."""
            axis0 = st["axis0"]
            entered = axis0 >= 0
            t_ax = _sel3(axis0, st["tx"], st["ty"], st["tz"])
            td_ax = _sel3(axis0, tdx, tdy, tdz)
            return entered, jnp.where(entered, t_ax - td_ax, 0.0)

        def skip_radius(word):
            return jnp.maximum(
                ((word >> BRICK_DIST_SHIFT) & u32(0x1FF)).astype(i32) - 1, 0)

        def advance(st, step, skip_r, use_skip):
            pxn, pyn, pzn, txn, tyn, tzn, t_axis, exited = top_step(
                st["px"], st["py"], st["pz"], st["tx"], st["ty"], st["tz"],
                d3, si3, td3, skip_r, use_skip, grid)
            moved = dict(
                px=jnp.where(step, pxn, st["px"]),
                py=jnp.where(step, pyn, st["py"]),
                pz=jnp.where(step, pzn, st["pz"]),
                tx=jnp.where(step, txn, st["tx"]),
                ty=jnp.where(step, tyn, st["ty"]),
                tz=jnp.where(step, tzn, st["tz"]),
                axis0=jnp.where(step, t_axis, st["axis0"]))
            return moved, step & exited

        def cond(st):
            return jnp.logical_and(
                st["it"] < max_iters,
                jnp.max(st["active"].astype(i32)) > 0)

        march = dict(it=jnp.int32(0), active=active0, px=px, py=py, pz=pz,
                     tx=tx, ty=ty, tz=tz, axis0=jnp.full((block,), -1, i32))

        if record:
            k = k_segments
            for kk in range(k):
                cell_ref[kk, :] = jnp.full((block,), -1, i32)
                nd_ref[kk, :] = zero_f
                ncode_ref[kk, :] = jnp.full((block,), -1, i32)
                slot_ref[kk, :] = jnp.full((block,), -1, i32)

            def body(st):
                active = st["active"]
                word, sc_id = cell_word(st)
                occ = active & ((word & u32(BRICK_FLAG_BITS)) != 0)
                entered, nd_new = entry(st)
                loaded = (word & u32(BRICK_LOADED_BIT)) != 0
                gslot = plgpu.load(base_ref.at[sc_id], mask=occ & loaded,
                                   other=0) \
                    + (word & u32(BRICK_INDEX_BITS)).astype(i32)
                kidx = jnp.where(occ, st["count"], 0)
                at = (kidx, lanes)
                plgpu.store(cell_ref.at[at],
                            st["px"] | (st["py"] << 10) | (st["pz"] << 20),
                            mask=occ)
                plgpu.store(nd_ref.at[at], nd_new, mask=occ)
                plgpu.store(ncode_ref.at[at],
                            jnp.where(entered, st["axis0"], -1), mask=occ)
                plgpu.store(slot_ref.at[at], jnp.where(loaded, gslot, -1),
                            mask=occ)
                count = st["count"] + occ.astype(i32)

                # Recording does not stop the ray; the K-th segment does.
                step = active & (count < k)
                skip_r = skip_radius(word)
                use_skip = step & ~occ & (skip_r >= 1) if use_ess \
                    else jnp.zeros((block,), bool)
                moved, miss = advance(st, step, skip_r, use_skip)
                return dict(st, **moved, it=st["it"] + 1, count=count,
                            active=step & ~miss)

            st = jax.lax.while_loop(cond, body, dict(march, count=zero_i))
            count_ref[...] = st["count"]
            exh_ref[...] = st["active"].astype(i32)
            iters_ref[...] = jnp.full((block,), st["it"], i32)
            return

        camx, camy, camz = cam_ref[0], cam_ref[1], cam_ref[2]
        enx, eny, enz = enx_ref[...], eny_ref[...], enz_ref[...]

        def body(st):
            active = st["active"]
            level = st["level"]
            px, py, pz = st["px"], st["py"], st["pz"]

            # ---- top-level cell (voxel.cuh:192-259) -----------------------
            word, sc_id = cell_word(st)
            is_top = (level == 0) & active
            occ0 = is_top & ((word & u32(BRICK_FLAG_BITS)) != 0)
            skip_r = skip_radius(word)
            entered, nd_new = entry(st)
            axis0 = st["axis0"]
            sf_ax = _sel3(axis0, sfx, sfy, sfz)
            ntx = jnp.where(entered, jnp.where(axis0 == 0, -sf_ax, 0.0),
                            st["nx"])
            nty = jnp.where(entered, jnp.where(axis0 == 1, -sf_ax, 0.0),
                            st["ny"])
            ntz = jnp.where(entered, jnp.where(axis0 == 2, -sf_ax, 0.0),
                            st["nz"])

            # LoD by squared camera distance in brick units (voxel.cuh:208).
            if use_lod:
                dxc, dyc, dzc = camx - px, camy - py, camz - pz
                d2 = dxc * dxc + dyc * dyc + dzc * dzc
                far = d2 > grid.lod_distance_8
                mid = ~far & (d2 > grid.lod_distance_2)
            else:
                far = jnp.zeros((block,), bool)
                mid = far
            near = ~far & ~mid
            loaded = (word & u32(BRICK_LOADED_BIT)) != 0
            unloaded = (word & u32(BRICK_UNLOADED_BIT)) != 0

            hit_far = occ0 & far
            descend_byte = occ0 & mid
            descend_brick = occ0 & near & loaded
            hit_unloaded = occ0 & near & ~loaded & unloaded
            top_adv = is_top & ~(hit_far | descend_byte | descend_brick
                                 | hit_unloaded)

            # ---- sub-level occupancy (LoD byte or brick word) ------------
            is_sub = (level > 0) & active
            sx, sy, sz = st["sx"], st["sy"], st["sz"]
            stx, sty, stz = st["stx"], st["sty"], st["stz"]
            axs = st["axs"]
            lin_byte = jnp.clip(sx + sy * 2 + sz * 4, 0, 7)
            occ_byte = (st["lodbyte"] >> lin_byte) & 1
            lin_brick = jnp.clip(sx + sy * bsz + sz * bsz * bsz, 0,
                                 bsz ** 3 - 1)
            in_brick = is_sub & (level == 2)
            bword = plgpu.load(
                pool_ref.at[st["gslot"] * cm + (lin_brick >> 5)],
                mask=in_brick, other=0)
            occ_brick = (bword >> (lin_brick & 31).astype(u32)) & u32(1)
            occ_sub = jnp.where(level == 1, occ_byte != 0,
                                occ_brick != 0) & is_sub
            sub_advance = is_sub & ~occ_sub

            # ---- sub hit: distance / normal (voxel.cuh:58-63, 114-119) ---
            s_entered = axs >= 0
            st_ax = _sel3(axs, stx, sty, stz)
            std_ax = _sel3(axs, tdx, tdy, tdz)
            sub_t = jnp.where(s_entered, st_ax - std_ax, 0.0)
            ssf_ax = _sel3(axs, sfx, sfy, sfz)
            snx = jnp.where(s_entered, jnp.where(axs == 0, -ssf_ax, 0.0),
                            st["nx"])
            sny = jnp.where(s_entered, jnp.where(axs == 1, -ssf_ax, 0.0),
                            st["ny"])
            snz = jnp.where(s_entered, jnp.where(axs == 2, -ssf_ax, 0.0),
                            st["nz"])
            sub_scale = jnp.where(level == 1, 4.0, 1.0).astype(f32)
            sub_hit_t = st["nd"] * bsz + sub_t * sub_scale

            # ---- sub step ------------------------------------------------
            s_axis = _sel_axis(stx, sty, stz)
            sub_extent = jnp.where(level == 1, 2, bsz)
            sxn = sx + jnp.where(s_axis == 0, six, 0)
            syn = sy + jnp.where(s_axis == 1, siy, 0)
            szn = sz + jnp.where(s_axis == 2, siz, 0)
            s_exited = (_sel3(s_axis, sxn, syn, szn)
                        == _sel3(s_axis, jnp.where(dx > 0, sub_extent, -1),
                                 jnp.where(dy > 0, sub_extent, -1),
                                 jnp.where(dz > 0, sub_extent, -1)))
            stxn = stx + jnp.where(s_axis == 0, tdx, 0.0)
            styn = sty + jnp.where(s_axis == 1, tdy, 0.0)
            stzn = stz + jnp.where(s_axis == 2, tdz, 0.0)
            ascend = sub_advance & s_exited

            # ---- top step (empty cell, or sub-DDA exited) ----------------
            use_skip = top_adv & ~occ0 & (skip_r >= 1) if use_ess \
                else jnp.zeros((block,), bool)
            moved, miss = advance(st, top_adv | ascend, skip_r, use_skip)

            # ---- descend setup: hit*(2) - n*0.2eps / hit*(8) - n*eps -----
            descend = descend_byte | descend_brick
            d_scale = jnp.where(descend_byte, 2.0, float(bsz))
            n_eps = jnp.where(descend_byte, 0.2 * eps, eps)
            d_ext = jnp.where(descend_byte, 2, bsz)

            def descend_axis(o, d, rd, nt):
                so = (o + d * nd_new) * d_scale - nt * n_eps
                p = jnp.trunc(so).astype(i32)
                cb = jnp.where(d > 0, p.astype(f32) + 1.0, p.astype(f32))
                t = jnp.where(d != 0.0, (cb - so) * rd, f32(BIG))
                # C trunc-mod: the nudged origin can be epsilon-negative.
                return jax.lax.rem(p, d_ext), t

            sdx, sdtx = descend_axis(ox, dx, rdx, ntx)
            sdy, sdty = descend_axis(oy, dy, rdy, nty)
            sdz, sdtz = descend_axis(oz, dz, rdz, ntz)
            gslot_d = plgpu.load(base_ref.at[sc_id], mask=descend_brick,
                                 other=0) \
                + (word & u32(BRICK_INDEX_BITS)).astype(i32)

            # ---- merge ----------------------------------------------------
            coarse_hit = hit_far | hit_unloaded
            terminal = coarse_hit | occ_sub
            new_t = jnp.where(coarse_hit, nd_new * bsz, st["t"])
            new_t = jnp.where(occ_sub, sub_hit_t, new_t)

            def pick(coarse_v, sub_v, old):
                return jnp.where(occ_sub, sub_v,
                                 jnp.where(coarse_hit, coarse_v, old))

            def sub_upd(desc_v, step_v, old):
                return jnp.where(descend, desc_v,
                                 jnp.where(sub_advance, step_v, old))

            return dict(
                st, **moved,
                it=st["it"] + 1,
                active=active & ~terminal & ~miss,
                level=jnp.where(descend_byte, 1,
                                jnp.where(descend_brick, 2,
                                          jnp.where(ascend, 0, level))),
                nx=jnp.where(descend, ntx, st["nx"]),
                ny=jnp.where(descend, nty, st["ny"]),
                nz=jnp.where(descend, ntz, st["nz"]),
                nd=jnp.where(descend, nd_new, st["nd"]),
                sx=sub_upd(sdx, sxn, sx), sy=sub_upd(sdy, syn, sy),
                sz=sub_upd(sdz, szn, sz),
                stx=sub_upd(sdtx, stxn, stx), sty=sub_upd(sdty, styn, sty),
                stz=sub_upd(sdtz, stzn, stz),
                axs=sub_upd(-1, s_axis, axs),
                gslot=jnp.where(descend_brick, gslot_d, st["gslot"]),
                lodbyte=jnp.where(
                    descend_byte,
                    ((word >> BRICK_LOD_SHIFT) & u32(0xFF)).astype(i32),
                    st["lodbyte"]),
                hit=st["hit"] | terminal, t=new_t,
                onx=pick(ntx, snx, st["onx"]),
                ony=pick(nty, sny, st["ony"]),
                onz=pick(ntz, snz, st["onz"]),
                request=st["request"] | hit_unloaded,
                rqx=jnp.where(hit_unloaded, px, st["rqx"]),
                rqy=jnp.where(hit_unloaded, py, st["rqy"]),
                rqz=jnp.where(hit_unloaded, pz, st["rqz"]),
            )

        big = jnp.full((block,), BIG, f32)
        st = jax.lax.while_loop(cond, body, dict(
            march, level=zero_i, nx=enx, ny=eny, nz=enz, nd=zero_f,
            sx=zero_i, sy=zero_i, sz=zero_i, stx=big, sty=big, stz=big,
            axs=jnp.full((block,), -1, i32), gslot=zero_i, lodbyte=zero_i,
            hit=jnp.zeros((block,), bool), t=zero_f, onx=zero_f,
            ony=zero_f, onz=zero_f, request=jnp.zeros((block,), bool),
            rqx=zero_i, rqy=zero_i, rqz=zero_i))

        hit_ref[...] = st["hit"].astype(i32)
        t_ref[...] = st["t"]
        nx_ref[...] = st["onx"]
        ny_ref[...] = st["ony"]
        nz_ref[...] = st["onz"]
        req_ref[...] = st["request"].astype(i32)
        rqx_ref[...] = st["rqx"]
        rqy_ref[...] = st["rqy"]
        rqz_ref[...] = st["rqz"]
        exh_ref[...] = st["active"].astype(i32)
        # Entry t (cell units) of the top cell a budget-exhausted lane sits
        # in: the marched prefix is known empty, so a rescue re-trace can
        # start just before it instead of at the origin.
        _, resume = entry(st)
        resume_ref[...] = resume
        iters_ref[...] = jnp.full((block,), st["it"], i32)

    return kernel


def _ray_inputs(origin, direction, grid: GridConfig, block: int):
    """Clip rays to the world and pad per-component [N] inputs to the block.

    Returns (n, padded length, clip results, padded inputs by kind)."""
    n = origin.shape[0]
    ok, tminn, clipped, entry_normal = aabb_clip(origin, direction, grid)
    npad = -(-n // block) * block

    def comp(a, fill=0.0, dtype=jnp.float32):
        return jnp.pad(a.astype(dtype), (0, npad - n), constant_values=fill)

    o_cells = clipped / float(grid.brick_size)
    d = direction.astype(jnp.float32)
    rd = jnp.where(d == 0.0, 0.0, 1.0 / d)
    comps = dict(
        o=[comp(o_cells[:, k]) for k in range(3)],
        d=[comp(d[:, k], 1.0) for k in range(3)],
        rd=[comp(rd[:, k], 1.0) for k in range(3)],
        en=[comp(entry_normal[:, k]) for k in range(3)],
        act=comp(ok, 0, jnp.int32),
    )
    return n, npad, (tminn, o_cells, entry_normal), comps


def _call(kernel, inputs, out_shapes, block: int, npad: int, num_warps: int,
          interpret: bool, k_rows: int = 0):
    ray = pl.BlockSpec((block,), lambda i: (i,))
    whole = [pl.BlockSpec(x.shape, lambda i, nd=x.ndim: (0,) * nd)
             for x in inputs["scene"]]
    out_specs = [pl.BlockSpec((k_rows, block), lambda i: (0, i))
                 if len(sd.shape) == 2 else ray for sd in out_shapes]
    return pl.pallas_call(
        kernel,
        grid=(npad // block,),
        in_specs=whole + [ray] * len(inputs["rays"]),
        out_specs=out_specs,
        out_shape=out_shapes,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="brick_march",
    )(*inputs["scene"], *inputs["rays"])


@partial(jax.jit, static_argnames=("grid", "max_iters", "use_lod", "use_ess",
                                   "block", "num_warps", "interpret"))
def trace_rays_kernel(origin, direction, index_volume, pool_words, pool_base,
                      camera_brick_pos, grid: GridConfig,
                      max_iters: int = 4096, use_lod: bool = True,
                      use_ess: bool = True, block: int = 32,
                      num_warps: int = 1, interpret: bool = False):
    """Drop-in for :func:`~brickmap_tpu.ops.traverse.trace_rays` (same
    arguments and result dict) that runs the per-block Triton kernel.

    A block loops until its slowest ray finishes, so small blocks waste
    least: 32 rays on one warp was the fastest of the sweep in PERF.md.

    ``max_iters`` bounds each block's loop; lanes still running then report
    ``exhausted`` with ``resume_t``, the distance along the ray at which the
    cell they stopped in begins.  ``interpret`` is for tests on the CPU.
    """
    n, npad, (tminn, _, _), c = _ray_inputs(origin, direction, grid, block)
    cam = jnp.pad(jnp.asarray(camera_brick_pos, jnp.int32), (0, 1))
    kernel = _make_kernel(grid, max_iters=max_iters, use_lod=use_lod,
                          use_ess=use_ess, record=False, k_segments=0,
                          block=block)
    f32, i32 = jnp.float32, jnp.int32
    out_dtypes = (i32, f32, f32, f32, f32, i32, i32, i32, i32, i32, f32, i32)
    outs = _call(
        kernel,
        dict(scene=[cam, index_volume.reshape(-1), pool_words.reshape(-1),
                    pool_base],
             rays=[*c["o"], *c["d"], *c["rd"], *c["en"], c["act"]]),
        [jax.ShapeDtypeStruct((npad,), dt) for dt in out_dtypes],
        block, npad, num_warps, interpret)
    hit, t, nx, ny, nz, req, rqx, rqy, rqz, exh, resume, iters = (
        o[:n] for o in outs)
    hit = hit != 0
    exhausted = exh != 0
    resume_t = jnp.where(exhausted, resume * float(grid.brick_size) + tminn,
                         0.0)
    return dict(
        hit=hit,
        t=jnp.where(hit, t + tminn, 0.0),
        normal=jnp.stack([nx, ny, nz], axis=1),
        request=req != 0,
        request_pos=jnp.stack([rqx, rqy, rqz], axis=1),
        iters=jnp.max(iters),
        exhausted=exhausted,
        resume_t=jnp.maximum(resume_t, 0.0),
    )


@partial(jax.jit, static_argnames=("grid", "k_segments", "use_ess", "block",
                                   "num_warps", "interpret"))
def record_segments_kernel(origin, direction, index_volume, pool_base,
                           grid: GridConfig, k_segments: int = 16,
                           use_ess: bool = True, block: int = 32,
                           num_warps: int = 1, interpret: bool = False):
    """Each ray's first ``k_segments`` occupied cells, front to back: the
    record mode of the march kernel.  Same result dict as
    :func:`brickmap_tpu.ops.record.record_segments_xla`."""
    n, npad, (tminn, o_cells, entry_normal), c = _ray_inputs(
        origin, direction, grid, block)
    k = k_segments
    kernel = _make_kernel(grid, max_iters=record_budget(grid), use_lod=False,
                          use_ess=use_ess, record=True, k_segments=k,
                          block=block)
    f32, i32 = jnp.float32, jnp.int32
    seg = [jax.ShapeDtypeStruct((k, npad), dt) for dt in (i32, f32, i32, i32)]
    ray = [jax.ShapeDtypeStruct((npad,), i32)] * 3
    cells, nd, ncode, slot, count, exh, _ = _call(
        kernel,
        dict(scene=[index_volume.reshape(-1), pool_base],
             rays=[*c["o"], *c["d"], *c["rd"], c["act"]]),
        seg + ray, block, npad, num_warps, interpret, k_rows=k)
    return dict(
        cells=cells.T[:n], nd=nd.T[:n], ncode=ncode.T[:n], slot=slot.T[:n],
        count=count[:n], tminn=tminn, entry_normal=entry_normal,
        o_cells=o_cells, exhausted=exh[:n] != 0)
