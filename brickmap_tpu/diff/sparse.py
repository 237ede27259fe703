"""Differentiable rendering over the sparse brick pool (BASELINE config 5).

Two-phase design ("store hit segment list per ray, bounded K", SURVEY.md §7
milestone 4):

1. **Record** (non-differentiable): the traversal's cell march lists each
   ray's first K occupied cells front-to-back (:func:`record_segments`: the
   march kernel's record mode on a GPU, the XLA recorder on the CPU).
2. **Composite** (differentiable, XLA): per segment, the brick's soft
   occupancy/albedo rows are gathered from the pool fields and the <=22-voxel
   in-brick DDA alpha-composites them:

       w_i = T * occ_i,   T <- T * (1 - occ_i),   rgb += w_i * albedo_i

   Rays are chunked and each segment's replay is rematerialized
   (``jax.checkpoint``), so backward memory is one chunk x one brick row —
   no while-loop residuals.  Gradients reach exactly the voxels of resident
   bricks (the sparse model's parameter support); with binary occupancy the
   result reduces to the hard-surface renderer (parity-tested vs the dense
   compositor and the scalar oracle).

The reference has no backward pass of any kind; the geometry/order of voxel
visits matches its traversal (voxel.cuh:79-133).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GridConfig
from ..ops.record import record_segments_xla
from ..pallas.march import record_segments_kernel

__all__ = ["record_segments", "cell_pool_map", "pool_fields_from_bitmask",
           "active_brick_fields", "composite_sparse",
           "l2_loss_and_grads_sparse"]


def record_segments(origin, direction, scene, grid: GridConfig,
                    k_segments: int = 16):
    """Each ray's first ``k_segments`` occupied cells of ``scene`` (a
    :class:`~brickmap_tpu.scene.VoxelScene`), front to back.

    The implementation follows the platform the program is compiled for:
    the march kernel's record mode on a GPU, the XLA recorder
    (:func:`~brickmap_tpu.ops.record.record_segments_xla`, same results)
    on the CPU."""
    kw = dict(grid=grid, k_segments=k_segments)
    return jax.lax.platform_dependent(
        origin, direction, scene.index_volume, scene.pool_base,
        cpu=partial(record_segments_xla, **kw),
        cuda=partial(record_segments_kernel, **kw))


def _merge_offsets(tmax, tdabs, has_axis, nj: int, nvox: int):
    """Per-axis crossing counts after k merged DDA steps, k = 0..nvox-1.

    The visit sequence of a 3-axis DDA is the 3-way merge of per-axis
    arithmetic crossing-time progressions t_a(j) = tmax_a + j * tdabs_a.
    The rank of axis a's j-th crossing is j + sum over other axes b of
    "crossings of b ordered before it".  Ties are broken z-over-y-over-x —
    the sequential walk's priority (_sel_axis, voxel.cuh:249) — by counting
    a tied crossing of b as earlier exactly when b outranks a, so tied
    crossings get distinct consecutive ranks and the merged walk steps
    axis-by-axis through lattice-aligned diagonals instead of collapsing
    them (and double-visiting the diagonal voxel).  "Tied"
    is tolerance-snapped within an ABSOLUTE time window (1e-3 in brick-t
    units, where crossing periods are >= 1): the quotient
    (T - tmax_b) / db cannot be FP-exact even for exact geometric ties, and
    two crossings that close are legitimately ordered by priority either
    way.  The window must be absolute: an earlier per-axis window (1e-3 of
    each axis's own period) let a near-tie fall INSIDE one axis's window
    but OUTSIDE the other's, assigning both crossings the same rank — the
    walk then advanced two axes in one step and skipped a voxel (caught by
    test_sparse_matches_dense_compositor).

    offs_a[k] = #{j : rank_a(j) < k} is found by a vectorized binary search
    over j (rank_a is strictly increasing in j): O([C, nvox]) memory and
    ~log2(nj) closed-form rank evaluations, instead of materializing the
    [C, nj, nvox] rank-comparison tensor (~1.2e9 elements per axis at
    dense-path scale if XLA fails to fuse it).

    Args: tmax [C,3] first-crossing times, tdabs [C,3] per-axis crossing
    periods (|1/d|), has_axis [C,3] bool (False where d == 0).
    Returns offs int32 [C, nvox, 3].
    """
    c = tmax.shape[0]

    tie = 1e-3  # ABSOLUTE time window (brick-t units; periods are >= 1)

    def count(b, T, inclusive: bool):
        """#{i >= 0 : t_b(i) < T} (or <= T when ``inclusive``), clipped;
        crossings within ``tie`` of T (absolute time, so both axes of a
        near-tie agree on whether it IS a tie) count as equal-time."""
        db = jnp.where(tdabs[:, b:b + 1] == 0.0, 1.0, tdabs[:, b:b + 1])
        r = (T - tmax[:, b:b + 1]) / db
        # floor(r+e)+1 == ceil(r-e) except within the tie window e = tie/db.
        n = jnp.floor(r + tie / db).astype(jnp.int32) + 1 if inclusive \
            else jnp.ceil(r - tie / db).astype(jnp.int32)
        n = jnp.where(has_axis[:, b:b + 1], n, 0)
        return jnp.clip(n, 0, nj)

    ks = jnp.arange(nvox, dtype=jnp.int32)[None, :]
    offs_ax = []
    for a in range(3):
        others = [b for b in range(3) if b != a]

        def rank(j, a=a, others=others):
            t = tmax[:, a:a + 1] + j.astype(jnp.float32) * tdabs[:, a:a + 1]
            r = j + count(others[0], t, others[0] > a) \
                + count(others[1], t, others[1] > a)
            return jnp.where(has_axis[:, a:a + 1] & (j < nj), r,
                             jnp.int32(2 ** 30))

        lo = jnp.zeros((c, nvox), jnp.int32)
        hi = jnp.full((c, nvox), nj, jnp.int32)
        for _ in range((nj + 1).bit_length()):
            mid = (lo + hi) >> 1
            below = rank(mid) < ks
            lo = jnp.where(below, mid + 1, lo)
            hi = jnp.where(below, hi, mid)
        offs_ax.append(lo)
    return jnp.stack(offs_ax, axis=2)


def cell_pool_map(scene, grid: GridConfig) -> np.ndarray:
    """int32 [CZ, CY, CX]: brick cell -> global pool row (-1 where empty)."""
    iv = np.asarray(scene.index_volume)
    base = np.asarray(scene.pool_base)
    cz, cy, cx = iv.shape
    s = grid.supergrid_cell_size
    zz, yy, xx = np.meshgrid(np.arange(cz), np.arange(cy), np.arange(cx),
                             indexing="ij")
    sc = (xx // s) + (yy // s) * grid.supergrid_xy \
        + (zz // s) * grid.supergrid_xy ** 2
    loaded = (iv & np.uint32(0x8000_0000)) != 0
    slot = base[sc] + (iv & np.uint32(0xFFF)).astype(np.int64)
    return np.where(loaded, slot, -1).astype(np.int32)


def pool_fields_from_bitmask(scene) -> tuple[np.ndarray, np.ndarray]:
    """Initial (occupancy [P,512], albedo [P,512,3]) from the hard bitmask —
    the binarized starting point whose render equals the hard renderer."""
    return _fields_from_words(np.asarray(scene.pool_words))


def _fields_from_words(words):
    from .. import bits

    dense = np.asarray(bits.dense_from_brick_words(words))  # [P, 8,8,8] z,y,x
    # Brick-voxel linear index is x + 8y + 64z (voxel_bit_position), which is
    # exactly the raveled (z, y, x) order.
    occ = dense.reshape(words.shape[0], 512).astype(np.float32)
    alb = np.ones((words.shape[0], 512, 3), np.float32)
    return occ, alb


def active_brick_fields(scene, grid: GridConfig, slots):
    """Cell map and bitmask fields restricted to a frame's active bricks.

    A frame's gradients are exactly zero for every brick its rays never
    record, so an optimized field only needs the bricks in ``slots`` (the
    recorder's global pool rows, -1 = none); on the full world the fields
    of every brick would not fit the card.  Returns (cellmap [CZ,CY,CX]
    over the active rows, occupancy [A,512], albedo [A,512,3])."""
    slots = np.asarray(slots)
    rows = np.unique(slots[slots >= 0]).astype(np.int64)
    inv = np.full(np.asarray(scene.pool_words).shape[0], -1, np.int32)
    inv[rows] = np.arange(rows.shape[0], dtype=np.int32)
    cellmap = cell_pool_map(scene, grid)
    cellmap = np.where(cellmap >= 0, inv[np.maximum(cellmap, 0)], -1)
    occ, alb = _fields_from_words(np.asarray(scene.pool_words)[rows])
    return cellmap.astype(np.int32), occ, alb


def _segment_geom(oc, dc, cells, nds, ncodes, enorm, cellmap,
                  grid: GridConfig, k_segments: int):
    """Per-segment geometry: brick slot + the in-brick DDA's visit sequence.

    Pure geometry — the in-brick DDA path is *data-independent* (positions
    depend only on ray geometry), so every visited voxel's index is computed
    by register arithmetic, no occupancy reads.

    Returns (slots [C,K] i32 (0 where invalid), lin [C,K,nvox] i32 in-brick
    voxel ids, mask [C,K,nvox] bool step-valid).
    """
    eps = jnp.float32(grid.epsilon)
    bsz = grid.brick_size
    nvox = 3 * bsz - 2
    cellmap_flat = cellmap.reshape(-1)
    cy, cx = cellmap.shape[1], cellmap.shape[2]

    def seg_indices(k):
        cell = cells[:, k]
        nd = nds[:, k]
        ncode = ncodes[:, k]
        valid = cell >= 0
        cxp = cell & 0x3FF
        cyp = (cell >> 10) & 0x3FF
        czp = (cell >> 20) & 0x3FF
        flat = (czp * cy + cyp) * cx + cxp
        slot = jnp.take(cellmap_flat, jnp.clip(flat, 0,
                                               cellmap_flat.shape[0] - 1))
        valid = valid & (slot >= 0)
        slot = jnp.where(valid, slot, 0)

        # In-brick DDA from the nudged entry point (voxel.cuh:224).
        nrm = jnp.stack(
            [jnp.where(ncode == a, -jnp.sign(dc[:, a]), 0.0)
             for a in range(3)], 1)
        nrm = jnp.where((ncode >= 0)[:, None], nrm, enorm)
        so = (oc + dc * nd[:, None]) * bsz - nrm * eps
        pg = jnp.trunc(so).astype(jnp.int32)
        stepv = jnp.sign(dc).astype(jnp.int32)
        rd = jnp.where(dc == 0.0, 0.0, 1.0 / dc)
        # Crossing times in the global frame of `so`; only the position is
        # reduced to brick-local coordinates (C trunc-mod, voxel.cuh:93).
        cb = jnp.where(dc > 0, pg + 1.0, pg.astype(jnp.float32))
        tmax = jnp.where(dc != 0.0, (cb - so) * rd, 1e6)
        p = jnp.where(pg >= 0, pg % bsz, -((-pg) % bsz))
        tdelta = jnp.abs(rd)

        # 3-way closed-form rank merge of the per-axis crossing
        # progressions — no sequential scan (22 HBM round-trips of the
        # chunk per segment) and no row-sort (a bitonic sort is ~36 such
        # round-trips); exact ties step z-over-y-over-x like the
        # sequential walk (see _merge_offsets).
        offs = _merge_offsets(tmax, tdelta, dc != 0.0, nvox - 1, nvox)
        pk = p[:, None, :] + stepv[:, None, :] * offs       # [C, nvox, 3]
        inb = jnp.all((pk >= 0) & (pk < bsz), axis=2)
        mask = valid[:, None] & inb
        lin = jnp.clip(pk[..., 0] + pk[..., 1] * bsz
                       + pk[..., 2] * bsz * bsz, 0, bsz ** 3 - 1)
        return slot, lin, mask

    parts = [seg_indices(k) for k in range(k_segments)]
    slots = jnp.stack([s for s, _, _ in parts], axis=1)    # [C, K]
    lin = jnp.stack([l for _, l, _ in parts], axis=1)      # [C, K, nvox]
    mask = jnp.stack([m for _, _, m in parts], axis=1)
    return slots, lin, mask


def _segment_gidx(oc, dc, cells, nds, ncodes, enorm, cellmap,
                  grid: GridConfig, k_segments: int, pvox: int):
    """Flat voxel ids [C, K*nvox] + step-valid mask (voxel-granular form)."""
    bsz = grid.brick_size
    nvox = 3 * bsz - 2
    slots, lin, mask = _segment_geom(oc, dc, cells, nds, ncodes, enorm,
                                     cellmap, grid, k_segments)
    gidx = jnp.clip(slots[:, :, None] * (bsz ** 3) + lin, 0, pvox - 1)
    c = slots.shape[0]
    return gidx.reshape(c, k_segments * nvox), \
        mask.reshape(c, k_segments * nvox)


@jax.custom_vjp
def _composite_core(occ_v, alb_v, bg):
    """Front-to-back emission-absorption compositing of masked opacities.

    Forward is a plain cumulative product (no AD flows through it — the
    backward below is analytic); returns (rgb [C,3], trans [C])."""
    cp = jnp.cumprod(1.0 - occ_v, axis=1)                # [C, V]
    t_excl = jnp.concatenate(
        [jnp.ones((occ_v.shape[0], 1), jnp.float32), cp[:, :-1]], axis=1)
    w = occ_v * t_excl
    rgb = jnp.einsum("cv,cvk->ck", w, alb_v) + cp[:, -1:] * bg
    return rgb, cp[:, -1]


def _composite_core_fwd(occ_v, alb_v, bg):
    out = _composite_core(occ_v, alb_v, bg)
    return out, (occ_v, alb_v, bg)


def _composite_core_bwd(res, cots):
    """Division-free analytic backward (exact even at occ == 1).

    With s_i = albedo_i . drgb and the suffix recurrence
    S_i = occ_i s_i + (1-occ_i) S_{i+1},  S_V = bg . drgb + dtrans,
    the cotangents are d occ_i = T^excl_i (s_i - S_{i+1}) and
    d alb_i = w_i drgb.  The affine recurrence is associative
    ((a,b) o (a',b') = (a + b a', b b')), so S comes from one log-depth
    reverse scan — no per-step residuals, no 1/(1-occ) divisions."""
    occ_v, alb_v, bg = res
    drgb, dtrans = cots
    cp = jnp.cumprod(1.0 - occ_v, axis=1)
    t_excl = jnp.concatenate(
        [jnp.ones((occ_v.shape[0], 1), jnp.float32), cp[:, :-1]], axis=1)

    s = jnp.einsum("cvk,ck->cv", alb_v, drgb)
    g = jnp.einsum("ck,ck->c", bg, drgb) + dtrans        # [C]

    def compose(left, right):
        # reverse=True feeds (suffix, element); the composition applied to x
        # is f_element(f_suffix(x))... measured empirically: the RIGHT slot
        # is the earlier index, so combine as right o left.
        al, bl = left
        ar, br = right
        return ar + br * al, bl * br

    # (A_i, B_i) = f_i o f_{i+1} o ... o f_{V-1}; S_i = A_i + B_i * g.
    a_el = occ_v * s
    b_el = 1.0 - occ_v
    A, B = jax.lax.associative_scan(compose, (a_el, b_el), reverse=True,
                                    axis=1)
    s_next = jnp.concatenate(
        [A[:, 1:] + B[:, 1:] * g[:, None], g[:, None]], axis=1)  # S_{i+1}

    d_occ = t_excl * (s - s_next)
    d_alb = (occ_v * t_excl)[..., None] * drgb[:, None, :]
    d_bg = cp[:, -1:] * drgb
    return d_occ, d_alb, d_bg


_composite_core.defvjp(_composite_core_fwd, _composite_core_bwd)


def _composite_raw(occ_raw, alb_v, mask, bg):
    """Mask + clip raw gathered voxel values, then composite.

    The clip/mask chain stays under autodiff; the compositing core has an
    analytic custom VJP (above).  Returns (rgb [C,3], trans [C])."""
    occ_v = jnp.where(mask, jnp.clip(occ_raw, 0.0, 1.0), 0.0)
    return _composite_core(occ_v, alb_v, bg)


@jax.custom_vjp
def _composite_core3(occ_v, alb_r, alb_g, alb_b, bg):
    """Channel-split form of :func:`_composite_core`: albedo as three
    [C, V] planes so every array in the row replay stays 2-D.  Same math,
    same analytic backward."""
    cp = jnp.cumprod(1.0 - occ_v, axis=1)                # [C, V]
    t_excl = jnp.concatenate(
        [jnp.ones((occ_v.shape[0], 1), jnp.float32), cp[:, :-1]], axis=1)
    w = occ_v * t_excl
    rgb = jnp.stack([jnp.sum(w * a, axis=1) for a in (alb_r, alb_g, alb_b)],
                    axis=1) + cp[:, -1:] * bg
    return rgb, cp[:, -1]


def _composite_core3_fwd(occ_v, alb_r, alb_g, alb_b, bg):
    out = _composite_core3(occ_v, alb_r, alb_g, alb_b, bg)
    return out, (occ_v, alb_r, alb_g, alb_b, bg)


def _composite_core3_bwd(res, cots):
    occ_v, alb_r, alb_g, alb_b, bg = res
    drgb, dtrans = cots
    cp = jnp.cumprod(1.0 - occ_v, axis=1)
    t_excl = jnp.concatenate(
        [jnp.ones((occ_v.shape[0], 1), jnp.float32), cp[:, :-1]], axis=1)

    s = (alb_r * drgb[:, 0:1] + alb_g * drgb[:, 1:2]
         + alb_b * drgb[:, 2:3])                          # [C, V]
    g = jnp.sum(bg * drgb, axis=1) + dtrans               # [C]

    def compose(left, right):
        al, bl = left
        ar, br = right
        return ar + br * al, bl * br

    a_el = occ_v * s
    b_el = 1.0 - occ_v
    A, B = jax.lax.associative_scan(compose, (a_el, b_el), reverse=True,
                                    axis=1)
    s_next = jnp.concatenate(
        [A[:, 1:] + B[:, 1:] * g[:, None], g[:, None]], axis=1)

    d_occ = t_excl * (s - s_next)
    w = occ_v * t_excl
    d_alb = tuple(w * drgb[:, c:c + 1] for c in range(3))
    d_bg = cp[:, -1:] * drgb
    return (d_occ, *d_alb, d_bg)


_composite_core3.defvjp(_composite_core3_fwd, _composite_core3_bwd)


@partial(jax.jit, static_argnames=("grid", "k_segments", "rays_per_chunk",
                                   "row_replay"))
def composite_sparse(o_cells, direction, segs, cellmap, occupancy, albedo,
                     background, grid: GridConfig, k_segments: int = 16,
                     rays_per_chunk: int = 32768, row_replay: bool = True):
    """Alpha-composite recorded segments. Returns (rgb [N,3], trans [N]).

    Differentiable in (occupancy [P,512], albedo [P,512,3]).

    ``row_replay=True`` fetches ONE [4*512] brick row per (ray, segment)
    and gathers the visited voxels from it (see ``_row_chunk_grad``).
    ``row_replay=False`` keeps the voxel-granular gather (one flat row per
    visited voxel) as the parity oracle.
    """
    n = o_cells.shape[0]
    pvox = occupancy.shape[0] * occupancy.shape[1]
    bsz3 = grid.brick_size ** 3
    nvox = 3 * grid.brick_size - 2
    if row_replay:
        # The [C, K, 512, 4] row intermediate bounds the chunk size (4096
        # rays x K=16 is ~0.5 GB); the voxel path's [C, K*nvox] is lighter.
        rays_per_chunk = min(rays_per_chunk, 4096)

    def run_chunk(args):
        oc, dc, cells, nds, ncodes, enorm, bg = args
        c = oc.shape[0]
        if row_replay:
            slots, lin, mask = _segment_geom(oc, dc, cells, nds, ncodes,
                                             enorm, cellmap, grid,
                                             k_segments)
            field2 = _pack_field2(occupancy.reshape(-1, bsz3),
                                  albedo.reshape(-1, bsz3, 3))
            rows = jnp.take(field2, slots.reshape(-1), axis=0)
            vals = _gather_visited(
                rows, lin.reshape(c * k_segments, nvox))  # [C*K, 4*nvox]
            vals = vals.reshape(c, k_segments, 4, nvox).transpose(0, 1, 3, 2)
            occ_raw = vals[..., 0].reshape(c, k_segments * nvox)
            alb_v = vals[..., 1:].reshape(c, k_segments * nvox, 3)
            return _composite_raw(occ_raw, alb_v,
                                  mask.reshape(c, k_segments * nvox), bg)
        gidx, mask = _segment_gidx(oc, dc, cells, nds, ncodes, enorm,
                                   cellmap, grid, k_segments, pvox)
        occ_raw = jnp.take(occupancy.reshape(-1), gidx)     # [C, K*nvox]
        alb_v = jnp.take(albedo.reshape(-1, 3), gidx, axis=0)
        return _composite_raw(occ_raw, alb_v, mask, bg)

    if n <= rays_per_chunk:
        return run_chunk((o_cells, direction, segs["cells"], segs["nd"],
                          segs["ncode"], segs["entry_normal"], background))

    pad = (-n) % rays_per_chunk
    def padded(a, fill=0.0):
        if not pad:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad, *a.shape[1:]), fill, a.dtype)])

    parts = (padded(o_cells), padded(direction, 1.0),
             padded(segs["cells"], -1), padded(segs["nd"]),
             padded(segs["ncode"], -1), padded(segs["entry_normal"]),
             padded(background))
    c = parts[0].shape[0] // rays_per_chunk
    # Remat per chunk: the scan otherwise stacks [C, K*nvox(,3)] residuals.
    rgb, trans = jax.lax.map(
        jax.checkpoint(run_chunk),
        tuple(a.reshape(c, rays_per_chunk, *a.shape[1:]) for a in parts))
    return rgb.reshape(-1, 3)[:n], trans.reshape(-1)[:n]


def _chunk_grad_body(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                     sse_acc, dfield_acc, field, background, target,
                     grid: GridConfig, k_segments: int):
    """One chunk's sum-of-squared-error gradients added into accumulators.

    ``field`` packs (occupancy, albedo) as [P*512, 4] so the chunk does ONE
    row gather and ONE row scatter-add (separate occ/albedo fetches would
    double the gathered and scattered rows).
    Differentiates w.r.t. the *gathered* per-ray voxel values and
    scatter-adds the cotangents straight into the accumulator — never
    materializing a [P*512, 4]-sized gradient per chunk (a value_and_grad
    over the full field costs ~6 GB of accumulator traffic per chunk and
    OOMs HBM at whole-frame scale)."""
    pvox = field.shape[0]
    gidx, mask = _segment_gidx(o_cells, direction, cells, nd, ncode, enorm,
                               cellmap, grid, k_segments, pvox)
    fld_raw = jnp.take(field, gidx, axis=0)        # [C, K*nvox, 4]

    def sse_fn(fld):
        rgb, _ = _composite_raw(fld[..., 0], fld[..., 1:], mask, background)
        return jnp.sum((rgb - target) ** 2)

    sse, d_fld = jax.value_and_grad(sse_fn)(fld_raw)
    dfield_acc = dfield_acc.at[gidx.reshape(-1)].add(
        d_fld.reshape(-1, 4))
    return sse_acc + sse, dfield_acc


_chunk_grad_acc = partial(jax.jit, donate_argnums=(7, 8),
                          static_argnames=("grid", "k_segments"))(
    _chunk_grad_body)


# ---------------------------------------------------------------------------
# Brick-row-granular replay (the fast path)
# ---------------------------------------------------------------------------
#
# The voxel-granular replay above moves K*nvox gathered and scattered rows
# per ray.  The row path gathers each segment's whole [4*512] brick row
# once, picks the <=nvox visited voxels out of it, and scatter-adds ONE row
# of cotangents per segment: a K*nvox -> K reduction in gather and scatter
# rows, with identical math (parity-tested against the voxel path).


def _gather_visited(rows2, lin2):
    """vals [Cs, 4*nvox] (column f*nvox + j) from rows2 [Cs, 4*nv] (column
    f*nv + v) at lin2 [Cs, nvox]; an index outside [0, nv) yields 0.

    One ``take_along_axis`` per field; its transpose is the scatter-add XLA
    emits, so the gradient w.r.t. ``rows2`` needs no custom rule."""
    cs, nvox = lin2.shape
    nv = rows2.shape[1] // 4
    valid = (lin2 >= 0) & (lin2 < nv)
    idx = jnp.where(valid, lin2, 0)
    vals = jnp.take_along_axis(rows2.reshape(cs, 4, nv), idx[:, None, :],
                               axis=2)
    return jnp.where(valid[:, None, :], vals, 0.0).reshape(cs, 4 * nvox)


def _row_chunk_grad(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                    sse_acc, dfield_acc, field2, background, target,
                    grid: GridConfig, k_segments: int):
    """One chunk's SSE + gradients at brick-row granularity.

    ``field2`` is [P, 4*512] flat (columns f*512 + v); ``dfield_acc``
    matches.  Differentiates w.r.t. the *gathered rows* and scatter-adds
    one [4*512] cotangent row per segment — the accumulator never
    materializes per-chunk full-field adjoints.  The composite uses the
    channel-split core, so no array carries a minor dimension of 3.
    """
    c = o_cells.shape[0]
    k = k_segments
    nvox = 3 * grid.brick_size - 2
    slots, lin, mask = _segment_geom(o_cells, direction, cells, nd, ncode,
                                     enorm, cellmap, grid, k_segments)
    rows2 = jnp.take(field2, slots.reshape(-1), axis=0)   # [C*K, 4*512]
    # Invalid steps must extract 0 (not voxel 0's value): poison their lin.
    lin2 = jnp.where(mask, lin, -1).reshape(c * k, nvox)

    def kv(a):
        """[C*K, nvox] (k-major rows) -> [C, K*nvox] per-ray sequence."""
        return a.reshape(c, k * nvox)

    def sse_fn(rows2):
        vals = _gather_visited(rows2, lin2)              # [C*K, 4*nvox]
        occ = kv(vals[:, :nvox])
        alb = [kv(vals[:, (1 + ch) * nvox:(2 + ch) * nvox])
               for ch in range(3)]
        occ_v = jnp.where(mask.reshape(c, k * nvox),
                          jnp.clip(occ, 0.0, 1.0), 0.0)
        rgb, _ = _composite_core3(occ_v, *alb, background)
        return jnp.sum((rgb - target) ** 2)

    sse, d_rows = jax.value_and_grad(sse_fn)(rows2)
    dfield_acc = dfield_acc.at[slots.reshape(-1)].add(d_rows)
    return sse_acc + sse, dfield_acc


def _row_scan_grads(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                    field2, background, target, grid: GridConfig,
                    k_segments: int, chunk: int):
    """Whole-frame row-granular gradients: ONE program, a lax.scan over
    ``chunk``-ray slices carrying (sse, dfield) accumulators.

    Bounded memory (one slice's [chunk, K, 4*512] rows + cotangents live at
    a time) and one device dispatch regardless of frame size.
    """
    n = o_cells.shape[0]
    pad = (-n) % chunk

    def padded(a, fill):
        if not pad:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad, *a.shape[1:]), fill, a.dtype)])

    # Padded rays carry no segments and zero bg/target => zero SSE + grads.
    parts = (padded(o_cells, 0.0), padded(direction, 1.0),
             padded(cells, -1), padded(nd, 0.0), padded(ncode, -1),
             padded(enorm, 0.0), padded(background, 0.0),
             padded(target, 0.0))
    nslices = parts[0].shape[0] // chunk
    xs = tuple(a.reshape(nslices, chunk, *a.shape[1:]) for a in parts)

    # K-tier ladder: the caller sorts rays by descending segment count, so
    # most live slices are count-homogeneous and run at a fraction of the
    # full K's gather/extract/scatter traffic (mean live count ~3.7 of 8).
    keffs = [k for k in (2, 4) if k < k_segments] + [k_segments]
    thresholds = [0] + keffs[:-1]

    def body(carry, x):
        sse_acc, dfield_acc = carry
        o_c, d_c, cells_c, nd_c, ncode_c, enorm_c, bg_c, tgt_c = x

        def tier(keff: int):
            def run(carry):
                return _row_chunk_grad(
                    o_c, d_c, cells_c[:, :keff], nd_c[:, :keff],
                    ncode_c[:, :keff], enorm_c, cellmap,
                    carry[0], carry[1], field2, bg_c, tgt_c, grid, keff)
            return run

        def empty(carry):
            # No recorded segments in the slice: rgb == bg exactly, zero
            # field gradients — the replay reduces to a closed form.  The
            # caller sorts segment-less rays to the tail, so whole slices
            # of sky rays skip the gather/extract/scatter machinery.
            return carry[0] + jnp.sum((bg_c - tgt_c) ** 2), carry[1]

        # Segments are front-packed per ray, so the slice's max count picks
        # the smallest sufficient tier.
        mx = jnp.max(jnp.sum((cells_c >= 0).astype(jnp.int32), axis=1))
        idx = sum((mx > jnp.int32(t)).astype(jnp.int32) for t in thresholds)
        carry = jax.lax.switch(idx, [empty] + [tier(k) for k in keffs],
                               carry)
        return carry, None

    (sse, dfield), _ = jax.lax.scan(
        body, (jnp.zeros((), jnp.float32), jnp.zeros_like(field2)), xs)
    return sse, dfield


_row_scan_grads_jit = partial(
    jax.jit, static_argnames=("grid", "k_segments", "chunk"))(
    _row_scan_grads)


@partial(jax.jit, static_argnames=("grid",))
def _coherence_sort(origin, direction, background, target, grid: GridConfig):
    """(superchunk, direction octant) coherence sort as ONE program."""
    s16 = float(grid.brick_size * grid.supergrid_cell_size)
    q = jnp.clip((origin / s16).astype(jnp.int32), 0,
                 max(grid.supergrid_xy, grid.supergrid_z) - 1)
    sc_id = (q[:, 0] + q[:, 1] * grid.supergrid_xy
             + q[:, 2] * grid.supergrid_xy ** 2)
    octant = ((direction[:, 0] > 0).astype(jnp.int32)
              + 2 * (direction[:, 1] > 0).astype(jnp.int32)
              + 4 * (direction[:, 2] > 0).astype(jnp.int32))
    order = jnp.argsort(sc_id * 8 + octant)
    return tuple(jnp.take(a, order, axis=0)
                 for a in (origin, direction, background, target))


@jax.jit
def _count_sort(cells, o_cells, direction, nd, ncode, enorm, bg, tgt):
    """Rays sorted by DESCENDING segment count (stable; ONE program) +
    live count.

    Segment-less rays still group at the tail (the sky closed form), and
    additionally slices of the live prefix become count-homogeneous so the
    scan can run each slice at the smallest K-tier that covers it (with K=8
    and a mean count well below K, most of the gather/extract/scatter
    traffic at fixed K would be padding)."""
    has_seg = cells[:, 0] >= 0
    cnt = jnp.sum((cells >= 0).astype(jnp.int32), axis=1)
    order2 = jnp.argsort(-cnt, stable=True)

    def t(a):
        return jnp.take(a, order2, axis=0)

    return (t(o_cells), t(direction), t(cells), t(nd), t(ncode), t(enorm),
            t(bg), t(tgt)), jnp.sum(has_seg.astype(jnp.int32))


@jax.jit
def _sky_sse(bg, tgt, n_run):
    """SSE of the segment-less tail (rays [n_run:] after the count sort):
    no recorded segments means rgb == bg exactly, so the replay reduces to
    one masked reduction over static shapes (``n_run`` is a device scalar —
    no per-count recompiles)."""
    idx = jnp.arange(bg.shape[0], dtype=jnp.int32)
    err = jnp.sum((bg - tgt) ** 2, axis=1)
    return jnp.sum(jnp.where(idx >= n_run, err, 0.0))


def _scan_grad_acc(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                   field, background, target, grid: GridConfig,
                   k_segments: int, chunk: int):
    """Traced-input chunking: a lax.scan over ``chunk``-ray slices carrying
    the (sse, dfield) accumulators.

    Used when the inputs are tracers (inside ``shard_map``/``jit``) but the
    shard is too big for one program — the single-program replay at 1080p
    scale materializes [C, K*nvox, 4] intermediates of many GB.
    Host-dispatched chunking is not available under a trace, so the same
    bounded-memory loop runs as a scan."""
    n = o_cells.shape[0]
    pad = (-n) % chunk

    def padded(a, fill):
        if not pad:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad, *a.shape[1:]), fill, a.dtype)])

    # Padded rays carry no segments and zero bg/target => zero SSE + grads.
    parts = (padded(o_cells, 0.0), padded(direction, 1.0),
             padded(cells, -1), padded(nd, 0.0), padded(ncode, -1),
             padded(enorm, 0.0), padded(background, 0.0),
             padded(target, 0.0))
    c = parts[0].shape[0] // chunk
    xs = tuple(a.reshape(c, chunk, *a.shape[1:]) for a in parts)

    def body(carry, x):
        sse_acc, dfield_acc = carry
        o_c, d_c, cells_c, nd_c, ncode_c, enorm_c, bg_c, tgt_c = x
        carry = _chunk_grad_body(
            o_c, d_c, cells_c, nd_c, ncode_c, enorm_c, cellmap,
            sse_acc, dfield_acc, field, bg_c, tgt_c, grid, k_segments)
        return carry, None

    (sse, dfield), _ = jax.lax.scan(
        body, (jnp.zeros((), jnp.float32), jnp.zeros_like(field)), xs)
    return sse, dfield


@partial(jax.jit, static_argnames=("denom", "pshape"))
def _finalize(sse, dfield, denom: int, pshape: tuple):
    inv = jnp.float32(1.0 / denom)
    docc = (dfield[:, 0] * inv).reshape(pshape)
    dalb = (dfield[:, 1:] * inv).reshape(*pshape, 3)
    return sse * inv, (docc, dalb)


@jax.jit
def _pack_field(occupancy, albedo):
    """(occ [P,512], alb [P,512,3]) -> one [P*512, 4] gather row."""
    return jnp.concatenate(
        [occupancy.reshape(-1, 1), albedo.reshape(-1, 3)], axis=1)


@jax.jit
def _pack_field2(occupancy, albedo):
    """(occ [P,512], alb [P,512,3]) -> flat [P, 4*512] (columns f*512 + v).

    The row path's gather/scatter unit."""
    return jnp.concatenate(
        [occupancy] + [albedo[:, :, c] for c in range(3)], axis=1)


@partial(jax.jit, static_argnames=("denom", "pshape"))
def _finalize2(sse, dfield2, denom: int, pshape: tuple):
    inv = jnp.float32(1.0 / denom)
    nv = dfield2.shape[1] // 4
    docc = (dfield2[:, :nv] * inv).reshape(pshape)
    dalb = jnp.stack([dfield2[:, (1 + c) * nv:(2 + c) * nv] * inv
                      for c in range(3)], axis=-1).reshape(*pshape, 3)
    return sse * inv, (docc, dalb)


def l2_loss_and_grads_sparse(origin, direction, scene, cellmap, occupancy,
                             albedo, background, target, grid: GridConfig,
                             k_segments: int = 16,
                             host_chunk: int = 262144,
                             row_replay: bool = True,
                             seg_cache: dict | None = None):
    """L2 image loss + gradients w.r.t. the sparse pool fields.

    ``seg_cache``: optional dict owned by the caller.  The record phase and
    both coherence sorts depend only on (rays, scene geometry) — an
    optimization loop over the FIELDS passes the same dict every step and
    pays them once (rays/targets/scene must stay fixed; pass a fresh dict
    when they change).

    ``scene`` is the flat :class:`~brickmap_tpu.scene.VoxelScene` (its
    index volume and pool bases).  The record phase runs once
    (non-differentiable, :func:`record_segments`); the loss/grad phase
    replays the bounded-K segments.

    ``row_replay=True`` (default) replays at brick-ROW granularity: one
    gathered and one scattered row per (ray, segment) instead of per
    visited voxel (see ``_row_chunk_grad``), as a single scan program with
    bounded per-slice memory.  ``row_replay=False`` keeps the
    voxel-granular replay (the original path, retained as the parity
    oracle and for memory-constrained accumulators):

    with concrete (non-traced) inputs larger than ``host_chunk`` rays, the
    voxel path accumulates over host-dispatched chunk programs with donated
    accumulators, because a single whole-frame backward program carries
    the full [P,512]+[P,512,3] adjoints plus residuals.  Traced inputs
    (e.g. inside ``shard_map``, where shards are small) keep the
    single-program path.
    """
    n = origin.shape[0]
    pshape = occupancy.shape
    traced = isinstance(origin, jax.core.Tracer)
    # Segment cache: record + sorts + counts depend only on (rays, scene)
    # geometry, not on the fields being optimized — an optimization loop
    # passes one dict and pays them once (host path only; under a trace the
    # cache holds tracers from another program and is ignored).
    # Cache key: identity of the ray/target arrays (held strongly in the
    # dict, so CPython cannot reuse the ids for different arrays).  A caller
    # that swaps rays or targets while reusing the dict gets a refresh
    # instead of silently wrong loss/grads.
    cache_key = (id(origin), id(direction), id(background), id(target))
    key_arrays = (origin, direction, background, target)
    use_cache = (row_replay and not traced and seg_cache is not None
                 and "geo" in seg_cache
                 and seg_cache.get("key") == cache_key)
    if not use_cache:
        # Coherence sort (loss and grads are order-invariant, so no
        # unsort): rays sharing (superchunk, direction octant) walk the
        # same cells, so a kernel block's rays finish together.
        origin, direction, background, target = _coherence_sort(
            origin, direction, background, target, grid)
        segs = record_segments(origin, direction, scene, grid,
                               k_segments=k_segments)

    if row_replay:
        field2 = _pack_field2(occupancy, albedo)
        if use_cache:
            geo, n_live_dev = seg_cache["geo"], seg_cache["n_live"]
        else:
            # Segment-less rays (sky/miss; half the frame on terrain
            # views) group at the tail; stable, so the coherence sort survives
            # within each group.
            geo, n_live_dev = _count_sort(
                segs["cells"], segs["o_cells"], direction, segs["nd"],
                segs["ncode"], segs["entry_normal"], background, target)
        if traced:
            # Inside jit/shard_map the live count is dynamic: scan over all
            # slices, segment-less ones take the closed-form lax.cond
            # branch inside the scan body.
            sse, dfield2 = _row_scan_grads(
                geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], cellmap,
                field2, geo[6], geo[7], grid, k_segments,
                chunk=min(host_chunk, 8192, -(-n // 1024) * 1024))
            return _finalize2(sse, dfield2, denom=n * 3, pshape=pshape)
        # Host path: trim the scan to the live prefix outright (one scalar
        # pull).  The prefix length is bucketed so optimization loops with
        # drifting counts compile at most ~8 scan shapes; the segment-less
        # tail contributes rgb == bg exactly, folded in as ONE masked
        # reduction over static shapes.  Slice size: big slices amortize
        # per-slice fixed costs, but never pad a small input up to the cap.
        chunkv = min(host_chunk, 16384, -(-n // 1024) * 1024)
        n_live = int(n_live_dev)
        if seg_cache is not None:
            seg_cache["geo"], seg_cache["n_live"] = geo, n_live_dev
            seg_cache["key"] = cache_key
            seg_cache["key_arrays"] = key_arrays
        if n_live == 0:
            # All-miss frame: the whole frame is the segment-less tail, so
            # the sky SSE covers every ray (n_run=0), not just [n_run:].
            return _finalize2(_sky_sse(geo[6], geo[7], jnp.int32(0)),
                              jnp.zeros_like(field2),
                              denom=n * 3, pshape=pshape)
        bucket = chunkv * max(1, -(-n // (8 * chunkv)))
        n_run = min(n, -(-n_live // bucket) * bucket)
        sse_sky = _sky_sse(geo[6], geo[7], jnp.int32(n_run))
        sse, dfield2 = _row_scan_grads_jit(
            geo[0][:n_run], geo[1][:n_run], geo[2][:n_run], geo[3][:n_run],
            geo[4][:n_run], geo[5][:n_run], cellmap, field2,
            geo[6][:n_run], geo[7][:n_run], grid, k_segments,
            chunk=chunkv)
        return _finalize2(sse + sse_sky, dfield2, denom=n * 3,
                          pshape=pshape)
    field = _pack_field(occupancy, albedo)
    if traced and n > host_chunk:
        # Inside a trace (shard_map shard bigger than one program's memory
        # budget): bounded-memory scan chunking instead of silently taking
        # the single-program path.
        sse, dfield = _scan_grad_acc(
            segs["o_cells"], direction, segs["cells"], segs["nd"],
            segs["ncode"], segs["entry_normal"], cellmap, field,
            background, target, grid, k_segments,
            chunk=min(host_chunk, 65536))
        return _finalize(sse, dfield, denom=n * 3, pshape=pshape)
    if traced or n <= host_chunk:
        sse, dfield = _chunk_grad_acc(
            segs["o_cells"], direction, segs["cells"], segs["nd"],
            segs["ncode"], segs["entry_normal"], cellmap,
            jnp.zeros((), jnp.float32), jnp.zeros_like(field), field,
            background, target, grid, k_segments)
        return _finalize(sse, dfield, denom=n * 3, pshape=pshape)

    # Host-chunked accumulation.  Padded rays record no segments and carry
    # zero background/target, so they contribute exactly zero SSE and grads.
    pad = (-n) % host_chunk

    def padded(a, fill):
        if not pad:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad, *a.shape[1:]), fill, a.dtype)])

    o_cells = padded(segs["o_cells"], 0.0)
    dirs_p = padded(direction, 1.0)
    cells_p = padded(segs["cells"], -1)
    nd_p = padded(segs["nd"], 0.0)
    ncode_p = padded(segs["ncode"], -1)
    enorm_p = padded(segs["entry_normal"], 0.0)
    bg_p = padded(background, 0.0)
    tgt_p = padded(target, 0.0)
    del segs  # free the unpadded copies' device buffers

    sse_acc = jnp.zeros((), jnp.float32)
    dfield_acc = jnp.zeros_like(field)
    for start in range(0, n + pad, host_chunk):
        sl = slice(start, start + host_chunk)
        sse_acc, dfield_acc = _chunk_grad_acc(
            o_cells[sl], dirs_p[sl], cells_p[sl], nd_p[sl], ncode_p[sl],
            enorm_p[sl], cellmap, sse_acc, dfield_acc, field,
            bg_p[sl], tgt_p[sl], grid, k_segments)
    return _finalize(sse_acc, dfield_acc, denom=n * 3, pshape=pshape)
