"""Multi-chip rendering and training: ray-sharded data parallelism.

The reference is single-process/single-GPU (SURVEY.md §2 P6-P9); this module
supplies the distribution layer the north star requires:

* **Forward** (:func:`render_wave_sharded`): pixels sharded across a 1-axis
  ``rays`` mesh with ``shard_map``; the voxel scene is replicated; no
  collectives in the forward path (embarrassingly parallel).
* **Inverse** (:func:`inverse_train_step`): per-shard pixel batches, per-shard
  gradients w.r.t. the replicated occupancy/albedo grids, ``pmean``-averaged
  over NVLink (XLA hands the all-reduce to NCCL and overlaps it with the
  remaining backward compute).  Every card of a host reaches every other at
  the same rate, so the mesh is the one ``rays`` axis.

Several processes: build the mesh from ``jax.devices()`` after
``jax.distributed.initialize``; the same code paths run unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import BrickmapConfig
from ..diff.render import composite_rays
from ..render.pathtrace import wave_for_indices

__all__ = ["make_mesh", "render_wave_sharded", "inverse_train_step",
           "inverse_train_step_sparse", "replicate", "shard_rays"]


def make_mesh(num_devices: int | None = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def replicate(mesh: Mesh, tree):
    """Place a pytree fully-replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def shard_rays(mesh: Mesh, tree, axis: str = "rays"):
    """Shard leading (ray/pixel) axis of each leaf across the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


# Each sharded step is one jitted program, compiled once per (mesh, config,
# shapes): called outside ``jit``, ``shard_map`` runs its body op by op,
# which costs seconds per call even at toy sizes.
@partial(jax.jit, static_argnames=("mesh", "cfg", "width", "height", "axis"))
def render_wave_sharded(mesh: Mesh, key, scene, camera_arrays, cam_brick,
                        cfg: BrickmapConfig, width: int, height: int,
                        axis: str = "rays"):
    """One sample wave with pixels sharded across the mesh.

    Pixel i is owned by device i // ceil(N/D); each shard renders its
    contiguous pixel block with an independent PRNG fold.  When the pixel
    count does not divide the device count, the last shard wraps around and
    re-renders leading pixels (equal shard shapes; the duplicates are
    discarded before returning, so any resolution works on any mesh).
    Returns the same (rgb [N,3], count [N], requests) as the single-chip
    path, laid out with the ray axis sharded.
    """
    n = width * height
    d = mesh.devices.size
    local = -(-n // d)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P(axis),
                   {"mask": P(axis), "pos": P(axis), "traced_rays": P(),
                    "exhausted_rays": P()}),
        check_vma=False,
    )
    def shard_body(key, scene, camera_arrays, cam_brick):
        me = jax.lax.axis_index(axis)
        idx = (me * local + jnp.arange(local, dtype=jnp.int32)) % n
        k = jax.random.fold_in(key, me)
        rgb, count, req = wave_for_indices(
            k, idx, scene, camera_arrays, cam_brick, cfg, width, height)
        req = dict(req, traced_rays=jax.lax.psum(req["traced_rays"], axis),
                   exhausted_rays=jax.lax.psum(req["exhausted_rays"], axis))
        return rgb, count, req

    rgb, count, req = shard_body(key, scene, camera_arrays, cam_brick)
    if local * d != n:
        rgb, count = rgb[:n], count[:n]
        req = dict(req, mask=req["mask"][:n], pos=req["pos"][:n])
    return rgb, count, req


@partial(jax.jit, static_argnames=("mesh", "max_steps", "axis"))
def inverse_train_step(mesh: Mesh, origin, direction, occupancy, albedo,
                       background, target, max_steps: int = 192,
                       axis: str = "rays"):
    """One data-parallel gradient step for inverse rendering.

    origin/direction/background/target are sharded on their ray axis; the
    grids are replicated.  Returns (loss, grad_occupancy, grad_albedo), all
    replicated (gradients psum-averaged over the mesh).
    """

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def step(o, dirs, occ, alb, bg, tgt):
        def loss_fn(occ, alb):
            rgb, _, _ = composite_rays(o, dirs, occ, alb, bg,
                                       max_steps=max_steps)
            return jnp.mean((rgb - tgt) ** 2)

        loss, (docc, dalb) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            occ, alb)
        # Equal shard sizes: global mean = pmean of shard means; the psum of
        # grads is the overlap-with-backward collective (SURVEY.md §2 P7).
        loss = jax.lax.pmean(loss, axis)
        docc = jax.lax.pmean(docc, axis)
        dalb = jax.lax.pmean(dalb, axis)
        return loss, docc, dalb

    return step(origin, direction, occupancy, albedo, background, target)


@partial(jax.jit, static_argnames=("mesh", "grid", "k_segments", "axis"))
def inverse_train_step_sparse(mesh: Mesh, origin, direction, scene, cellmap,
                              occupancy, albedo, background, target, grid,
                              k_segments: int = 8, axis: str = "rays"):
    """Data-parallel gradient step over the SPARSE pool fields (config 5 at
    world scale): rays sharded, flat scene + pool fields replicated, grads
    pmean'd across the mesh.  The recorder runs per shard."""
    from ..diff.sparse import l2_loss_and_grads_sparse

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def step(o, dirs, sc, cm, occ, alb, bg, tgt):
        loss, (docc, dalb) = l2_loss_and_grads_sparse(
            o, dirs, sc, cm, occ, alb, bg, tgt, grid,
            k_segments=k_segments)
        return (jax.lax.pmean(loss, axis), jax.lax.pmean(docc, axis),
                jax.lax.pmean(dalb, axis))

    return step(origin, direction, scene, cellmap, occupancy, albedo,
                background, target)
