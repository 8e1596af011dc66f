"""Sharded rendering and gradient computation over a device mesh.

The renderer's equivalent of the reference's implicit parallelism (every
fragment independent, ``res/shaders/volume.frag:21-51``): image pixels
are sharded over the mesh with ``shard_map``; the voxel grid and TF table
are replicated.  Forward needs no communication at all; backward
all-reduces grid/TF gradients (``psum``, which XLA hands to NCCL on
GPUs) inside each marcher's custom VJP.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from volumetric_renderer.parallel.mesh import make_layout
from volumetric_renderer.render.api import make_marcher
from volumetric_renderer.scene.camera import ray_grid
from volumetric_renderer.utils.config import RenderSettings


def make_sharded_renderer(mesh, settings: RenderSettings, method: str = "auto",
                          *, interpret: bool = False,
                          row_layout: str = "contiguous",
                          permuted_output: bool = False):
    """Build ``f(vol, tf, camera, dmin, dmax, smin, smax) -> (H, W, 4)``
    jitted over ``mesh`` with image pixels sharded on every mesh axis.

    Ray generation happens inside the jit (replicated tiny matrix math);
    the per-device marcher sees only its own pixels, so device memory
    holds ``1/n_devices`` of the ray and image tensors per card.
    ``method`` is any of ``render.api.METHODS`` except the oracle, or
    ``"auto"``; ``interpret=True`` runs ``"march"`` on the CPU (tests).

    ``row_layout`` picks the pixel-to-device distribution (see
    :func:`~volumetric_renderer.parallel.mesh.make_layout`):
    ``"contiguous"`` bands, ``"cyclic"`` 16-row blocks round-robin, or
    ``"tile-cyclic"`` 16x16 tiles round-robin (finest load balance).
    Restoring natural pixel order then costs one tiny image shuffle at the
    end of the forward; pass ``permuted_output=True`` to skip it and
    receive the shard-order image — what the training loss does, packing
    targets instead (a free, replicated gather), keeping the forward
    collective-free.
    """
    h, w = settings.height, settings.width
    n_dev = mesh.size
    gh, gw, pack, unpack, valid = make_layout(row_layout, h, w, n_dev)
    natural_order = row_layout == "contiguous"

    # vma checking cannot evaluate *interpreted* Pallas kernel bodies (the
    # HLO interpreter mixes varying and replicated operands in the kernel's
    # internal dynamic slices), so the interpreted kernel runs under
    # check_vma=False.  The two regimes place the replicated-input gradient
    # psum differently: with vma tracking ON, the custom VJP must psum
    # explicitly (vary_axes) and shard_map inserts nothing; with it OFF,
    # shard_map's transpose psums replicated-input cotangents itself, so an
    # explicit psum would double-count (8x grads on an 8-device mesh).
    check_vma = not interpret
    marcher = make_marcher(
        method, settings, interpret=interpret,
        vary_axes=tuple(mesh.axis_names) if check_vma else ())

    axes = mesh.axis_names
    ray_spec = P(axes)          # rows sharded over every mesh axis
    rep = P()

    def marcher_shard(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        return marcher(vol, tf, origin, dirs, dmin, dmax, smin, smax)

    sharded_march = jax.shard_map(
        marcher_shard, mesh=mesh,
        in_specs=(rep, rep, rep, ray_spec, rep, rep, rep, rep),
        out_specs=ray_spec,
        check_vma=check_vma,
    )

    # The output keeps shard-order sharding only when no final
    # reordering/slice is needed; otherwise XLA picks the layout for the
    # (cheap) final shuffle.
    out_shard = (NamedSharding(mesh, ray_spec)
                 if permuted_output or (natural_order and gh == h)
                 else None)

    @functools.partial(
        jax.jit,
        in_shardings=(NamedSharding(mesh, rep),) * 2 + (None,) * 5,
        out_shardings=out_shard,
    )
    def render_fn(vol, tf, camera, dmin, dmax, smin, smax):
        origin, dirs = ray_grid(
            camera, h, w, settings.fov_y_degrees, settings.near, settings.far
        )
        origin = origin + 0.5  # world cube [-0.5,0.5]^3 -> texture space
        # pack into shard order: a static gather on replicated rays, free
        # of communication; padded positions get an inert straight-up ray
        # (its rare cube hits are masked out by `valid` on the way back)
        dirs = pack(dirs)
        if gh != h or gw != w:
            dirs = jnp.where(valid[..., None] > 0.0, dirs,
                             jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
        dirs = jax.lax.with_sharding_constraint(dirs, NamedSharding(mesh, ray_spec))
        img = sharded_march(vol, tf, origin, dirs, dmin, dmax, smin, smax)
        if permuted_output:
            return img          # (gh, gw, 4) in shard order
        return unpack(img)

    return render_fn


def render_distributed(vol, tf, camera, settings: RenderSettings, mesh,
                      *, density_min=None, density_max=None,
                      slice_min=None, slice_max=None, method: str = "auto"):
    """One-shot convenience wrapper around :func:`make_sharded_renderer`."""
    vol = jnp.asarray(vol, jnp.float32)
    if density_min is None:
        density_min = jnp.min(vol)
    if density_max is None:
        density_max = jnp.max(vol)
    if slice_min is None:
        slice_min = jnp.zeros(3, jnp.float32)
    if slice_max is None:
        slice_max = jnp.ones(3, jnp.float32)
    f = make_sharded_renderer(mesh, settings, method)
    return f(vol, jnp.asarray(tf, jnp.float32), camera,
             jnp.asarray(density_min, jnp.float32),
             jnp.asarray(density_max, jnp.float32),
             jnp.asarray(slice_min, jnp.float32),
             jnp.asarray(slice_max, jnp.float32))
