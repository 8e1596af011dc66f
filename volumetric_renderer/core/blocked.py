"""Row-block adaptive marcher: dynamic trip counts at the XLA level.

The ``lax.scan`` marchers run *every* ray through all ``num_steps``
iterations of masked work — the exact analogue of the reference shader's
fixed 360-step loop with only a bounds ``break`` (``volume.frag:29-37``).
On a typical frame most of that is waste: rays that miss the cube
entirely (the majority at 1080p), rays whose box span covers a fraction
of ``num_steps``, and (with early termination) rays that saturate.

``lax.scan`` cannot stop early, but ``lax.while_loop`` can.  This marcher
splits the image into row blocks and marches each block with a
``while_loop`` whose condition is

    k < max-steps-any-ray-in-this-block-can-be-inside
    (and, with early termination: any ray still transmissive)

so a block of background pixels costs ~zero iterations and an
early-saturating block stops at its slowest ray.  Per-iteration math is
identical to ``core.fused._forward`` — outputs match to f32 rounding.

The forward is wrapped in the same custom VJP as the fused path (the
backward re-march already knows how to skip via its own masks), so this
is a drop-in faster forward for rendering AND the ``fused`` backward's
recompute stays available for training.

Block size trades adaptivity against dispatch overhead: blocks of 64-128
rows keep per-block launch cost negligible while separating sky from
subject for typical framings.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from volumetric_renderer.core.fused import ALPHA_EPS, make_fused_marcher
from volumetric_renderer.core.sampling import (
    ray_box_intersect,
    trilinear_sample_flat,
)


def _march_block(vol, tf, origin, dirs, dmin, dmax, smin, smax, *,
                 num_steps, step_size, early_termination, termination_eps,
                 vary_axes=()):
    """While-loop march of one ray block; math mirrors fused._forward."""
    amax = 1.0 - ALPHA_EPS

    def _vary(x):
        if not vary_axes:
            return x
        have = getattr(jax.typeof(x), "vma", frozenset())
        need = tuple(a for a in vary_axes if a not in have)
        return jax.lax.pcast(x, need, to="varying") if need else x
    t_entry, t_exit, hit = ray_box_intersect(origin, dirs)
    pos0 = jnp.clip(origin + t_entry[..., None] * dirs, 1e-6, 1.0 - 1e-6)
    inv_window = jnp.where(
        dmax - dmin > 0.0, 1.0 / jnp.maximum(dmax - dmin, 1e-30), 0.0)

    span = jnp.where(hit, t_exit - t_entry, 0.0)
    # ceil(span / dt) + 1 covers the last partially-inside sample; the
    # per-step inside-mask keeps the result exact regardless
    k_exit = jnp.where(hit, span / step_size + 2.0, 0.0)
    block_steps = jnp.minimum(
        jnp.int32(num_steps),
        jnp.max(k_exit).astype(jnp.int32))

    n = tf.shape[0]

    def body(carry):
        k, rgb, tr = carry
        pos = pos0 + (k.astype(jnp.float32) * step_size) * dirs
        inside = jnp.all((pos >= 0.0) & (pos <= 1.0), axis=-1)
        sliced = jnp.all((pos < smax) & (pos > smin), axis=-1)
        active = inside & sliced & hit
        if early_termination:
            active = active & (tr > termination_eps)

        # single flat 8-index gather (see sampling.trilinear_sample_flat)
        density = trilinear_sample_flat(vol, pos)

        t = (density - dmin) * inv_window
        t = jnp.where(active, t, 0.0)  # NaN-voxel containment, see marcher
        x = t * n - 0.5
        i0t = jnp.floor(x)
        wt = x - i0t
        lo = jnp.clip(i0t.astype(jnp.int32), 0, n - 1)
        hi = jnp.clip(i0t.astype(jnp.int32) + 1, 0, n - 1)
        rgba = tf[lo] * (1.0 - wt[..., None]) + tf[hi] * wt[..., None]
        a = jnp.minimum(rgba[..., 3], amax)
        a = jnp.where(active, a, 0.0)
        rgb = rgb + (tr * a)[..., None] * rgba[..., :3]
        tr = tr * (1.0 - a)
        return k + 1, rgb, tr

    def cond(carry):
        k, rgb, tr = carry
        live = k < block_steps
        if early_termination:
            live = live & jnp.any((tr > termination_eps)
                                  & (k.astype(jnp.float32) < k_exit))
        return live

    rgb0 = _vary(jnp.zeros(dirs.shape[:-1] + (3,), jnp.float32))
    tr0 = _vary(jnp.ones(dirs.shape[:-1], jnp.float32))
    k0 = _vary(jnp.int32(0))
    _, rgb, tr = jax.lax.while_loop(cond, body, (k0, rgb0, tr0))
    alpha = jnp.where(hit, 1.0 - tr, 0.0)
    return jnp.concatenate([rgb, alpha[..., None]], axis=-1)


@functools.lru_cache(maxsize=None)
def make_blocked_marcher(num_steps: int, step_size: float,
                         early_termination: bool, termination_eps: float,
                         block_rows: int = 64, vary_axes: tuple = ()):
    """Adaptive-trip-count marcher with the fused marcher's signature and
    custom VJP (backward delegates to the fused re-march).

    ``vary_axes``: mesh axes when running manually under ``shard_map`` —
    each shard's while_loops then exit on their own schedule (per-device
    divergent trip counts are the point of pixel sharding); the fused
    backward handles the gradient psum (see ``core.fused``).
    """
    fused = make_fused_marcher(num_steps, step_size, early_termination,
                               termination_eps, vary_axes=vary_axes)
    kwargs = dict(num_steps=num_steps, step_size=step_size,
                  early_termination=early_termination,
                  termination_eps=termination_eps, vary_axes=vary_axes)

    @jax.custom_vjp
    def march(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        h = dirs.shape[0]
        nblocks = -(-h // block_rows)
        hp = nblocks * block_rows
        d = jnp.pad(dirs, ((0, hp - h), (0, 0), (0, 0)))
        d_blocked = d.reshape(nblocks, block_rows, *d.shape[1:])

        def one(dblk):
            return _march_block(vol, tf, origin, dblk, dmin, dmax,
                                smin, smax, **kwargs)

        # lax.map keeps blocks as a serial loop of independent
        # while_loops (a vmap would fuse their trip counts back together)
        out = jax.lax.map(one, d_blocked)
        return out.reshape(hp, *out.shape[2:])[:h]

    def march_fwd(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        out = march(vol, tf, origin, dirs, dmin, dmax, smin, smax)
        return out, (vol, tf, origin, dirs, dmin, dmax, smin, smax)

    def march_bwd(res, g):
        vol, tf, origin, dirs, dmin, dmax, smin, smax = res
        _, vjp = jax.vjp(fused, vol, tf, origin, dirs, dmin, dmax,
                         smin, smax)
        return vjp(g)

    march.defvjp(march_fwd, march_bwd)
    return march
