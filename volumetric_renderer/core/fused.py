"""Memory-efficient differentiable march (custom VJP).

Plain autodiff through a 512-step ``lax.scan`` would store every carry
(512 x H x W x 4 floats — ~17 GB at 1080p), which cannot fit in HBM.  This
module implements the march as a ``jax.custom_vjp`` whose backward pass
*re-marches* the rays front-to-back once, reconstructing per-step
transmittance on the fly — O(1) memory in step count, ~2x forward FLOPs.

The key identity: with per-step opacity ``a_k``, color ``c_k``,
transmittance ``T_k = prod_{j<k}(1 - a_j)``, output ``rgb = sum_k T_k a_k
c_k`` and ``alpha = 1 - T_N``, the gradient w.r.t. ``a_k`` needs the suffix
sum ``S_k = sum_{j>k} T_j a_j (g_rgb . c_j)``, which equals
``(g_rgb . rgb_out) - P_k`` where ``P_k`` is the *prefix* sum accumulated
during the forward re-march — no reverse-order sweep or stored activations
required:

    dL/dc_k = T_k a_k g_rgb
    dL/da_k = T_k (g_rgb . c_k) + (g_alpha T_N - S_k) / (1 - a_k)

To keep the division well-posed, opacities are clamped to
``a <= 1 - ALPHA_EPS`` in both forward and backward (a deviation from the
reference shader bounded by ~ALPHA_EPS * num_steps << 1e-4).

Gradients are produced for the voxel grid (8-corner scatter-add, the
transpose of trilinear gather), the TF table (2-bin scatter-add, the
transpose of the 1D linear fetch), and the density window scalars.  Camera
(origin/dirs) and slicing bounds get symbolic zeros — the slicing test is a
step function, and camera gradients are out of scope for parity with the
reference (use ``march_rays`` + plain autodiff if you need them).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from volumetric_renderer.core.sampling import (
    ray_box_intersect,
    trilinear_sample_flat,
)

ALPHA_EPS = 1e-7


def _tf_lerp_setup(tf_table, t):
    """Indices/weights of the 1D TF linear fetch (CLAMP_TO_EDGE)."""
    n = tf_table.shape[0]
    x = t * n - 0.5
    i0 = jnp.floor(x)
    w = x - i0
    i0 = i0.astype(jnp.int32)
    lo = jnp.clip(i0, 0, n - 1)
    hi = jnp.clip(i0 + 1, 0, n - 1)
    return lo, hi, w


def _trilinear_setup(vol_shape, pts):
    """Corner indices (clipped), validity masks and weights for a gather."""
    zdim, ydim, xdim = vol_shape
    dims = jnp.array([xdim, ydim, zdim], dtype=pts.dtype)
    f = pts * dims - 0.5
    i0f = jnp.floor(f)
    w = f - i0f
    i0 = i0f.astype(jnp.int32)
    corners = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = i0[..., 0] + dx
                iy = i0[..., 1] + dy
                iz = i0[..., 2] + dz
                valid = (
                    (ix >= 0) & (ix < xdim)
                    & (iy >= 0) & (iy < ydim)
                    & (iz >= 0) & (iz < zdim)
                )
                weight = (
                    (w[..., 0] if dx else 1.0 - w[..., 0])
                    * (w[..., 1] if dy else 1.0 - w[..., 1])
                    * (w[..., 2] if dz else 1.0 - w[..., 2])
                )
                corners.append((
                    jnp.clip(iz, 0, zdim - 1),
                    jnp.clip(iy, 0, ydim - 1),
                    jnp.clip(ix, 0, xdim - 1),
                    valid,
                    weight,
                ))
    return corners


@functools.lru_cache(maxsize=None)
def make_fused_marcher(num_steps: int, step_size: float,
                       early_termination: bool, termination_eps: float,
                       vary_axes: tuple = ()):
    """Build a custom-VJP marcher specialized to static march settings.

    Returned function signature:
      ``f(vol, tf_table, origin, dirs, density_min, density_max,
          slice_min, slice_max) -> rgba``
    with the exact forward semantics of ``core.marcher.march_rays`` (modulo
    the ALPHA_EPS opacity clamp).

    ``vary_axes``: mesh axis names this marcher runs manually over (inside
    ``shard_map``).  Scan carries are initialized from constants, which the
    varying-manual-axes type system treats as device-invariant; ``pcast``
    promotes them so the carry type is stable across scan iterations while
    keeping ``check_vma=True`` (and with it AD's automatic ``psum``
    insertion for replicated grid/TF gradients).
    """

    amax = 1.0 - ALPHA_EPS

    def _vary(x):
        if not vary_axes:
            return x
        have = getattr(jax.typeof(x), "vma", frozenset())
        need = tuple(a for a in vary_axes if a not in have)
        return jax.lax.pcast(x, need, to="varying") if need else x

    def _forward(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        t_entry, _, hit = ray_box_intersect(origin, dirs)
        # Clamp the entry point strictly inside the cube (same epsilon as
        # core.marcher — see the comment there).
        pos0 = jnp.clip(origin + t_entry[..., None] * dirs, 1e-6, 1.0 - 1e-6)
        # Guard the degenerate density window (constant volume) -> t = 0.
        inv_window = jnp.where(
            dmax - dmin > 0.0, 1.0 / jnp.maximum(dmax - dmin, 1e-30), 0.0
        )
        rgb0 = _vary(jnp.zeros(dirs.shape[:-1] + (3,), jnp.float32))
        tr0 = _vary(jnp.ones(dirs.shape[:-1], jnp.float32))

        def body(k, carry):
            rgb, tr = carry
            pos = pos0 + (k.astype(jnp.float32) * step_size) * dirs
            inside = jnp.all((pos >= 0.0) & (pos <= 1.0), axis=-1)
            sliced = jnp.all((pos < smax) & (pos > smin), axis=-1)
            active = inside & sliced & hit
            if early_termination:
                active = active & (tr > termination_eps)

            # single flat 8-index gather (see sampling.trilinear_sample_flat)
            density = trilinear_sample_flat(vol, pos)
            t = (density - dmin) * inv_window
            t = jnp.where(active, t, 0.0)  # NaN-voxel containment
            lo, hi, w = _tf_lerp_setup(tf, t)
            rgba = tf[lo] * (1.0 - w[..., None]) + tf[hi] * w[..., None]
            a = jnp.minimum(rgba[..., 3], amax)
            a = jnp.where(active, a, 0.0)
            rgb = rgb + (tr * a)[..., None] * rgba[..., :3]
            tr = tr * (1.0 - a)
            return (rgb, tr)

        # fori_loop: a static trip count and no per-step outputs
        (rgb, tr) = jax.lax.fori_loop(0, num_steps, body, (rgb0, tr0))
        alpha = jnp.where(hit, 1.0 - tr, 0.0)
        return jnp.concatenate([rgb, alpha[..., None]], axis=-1), tr

    @jax.custom_vjp
    def march(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        out, _ = _forward(vol, tf, origin, dirs, dmin, dmax, smin, smax)
        return out

    def march_fwd(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        out, tr_final = _forward(vol, tf, origin, dirs, dmin, dmax, smin, smax)
        res = (vol, tf, origin, dirs, dmin, dmax, smin, smax, out, tr_final)
        return out, res

    def march_bwd(res, g):
        vol, tf, origin, dirs, dmin, dmax, smin, smax, out, tr_final = res
        g_rgb = g[..., :3]
        g_alpha = g[..., 3]

        t_entry, _, hit = ray_box_intersect(origin, dirs)
        # Clamp the entry point strictly inside the cube (same epsilon as
        # core.marcher — see the comment there).
        pos0 = jnp.clip(origin + t_entry[..., None] * dirs, 1e-6, 1.0 - 1e-6)
        # Guard the degenerate density window (constant volume) -> t = 0.
        inv_window = jnp.where(
            dmax - dmin > 0.0, 1.0 / jnp.maximum(dmax - dmin, 1e-30), 0.0
        )
        # Suffix-sum seed: G = g_rgb . rgb_out per pixel; g_alpha only flows
        # for hit pixels (out alpha is hard 0 on misses).
        g_alpha = jnp.where(hit, g_alpha, 0.0)
        big_g = jnp.sum(g_rgb * out[..., :3], axis=-1)

        tr0 = _vary(jnp.ones(dirs.shape[:-1], jnp.float32))
        p0 = jnp.zeros_like(tr0)
        vol_g0 = _vary(jnp.zeros_like(vol))
        tf_g0 = _vary(jnp.zeros_like(tf))
        dmin_g0 = _vary(jnp.zeros_like(dmin))
        dmax_g0 = _vary(jnp.zeros_like(dmax))

        def body(k, carry):
            tr, p, vol_g, tf_g, dmin_g, dmax_g = carry
            pos = pos0 + (k.astype(jnp.float32) * step_size) * dirs
            inside = jnp.all((pos >= 0.0) & (pos <= 1.0), axis=-1)
            sliced = jnp.all((pos < smax) & (pos > smin), axis=-1)
            active = inside & sliced & hit
            if early_termination:
                active = active & (tr > termination_eps)

            corners = _trilinear_setup(vol.shape, pos)
            density = jnp.zeros(pos.shape[:-1], vol.dtype)
            for iz, iy, ix, valid, weight in corners:
                density = density + jnp.where(valid, vol[iz, iy, ix], 0.0) * weight
            t = (density - dmin) * inv_window
            t = jnp.where(active, t, 0.0)  # NaN-voxel containment
            lo, hi, w = _tf_lerp_setup(tf, t)
            rgba = tf[lo] * (1.0 - w[..., None]) + tf[hi] * w[..., None]
            a_raw = rgba[..., 3]
            clamped = a_raw > amax
            a = jnp.where(active, jnp.minimum(a_raw, amax), 0.0)
            c = rgba[..., :3]

            gc_dot_c = jnp.sum(g_rgb * c, axis=-1)
            p_k = tr * a * gc_dot_c            # this step's prefix element
            p_new = p + p_k
            s_k = big_g - p_new                # suffix sum over j > k
            one_minus_a = jnp.maximum(1.0 - a, ALPHA_EPS)

            dL_dc = (tr * a)[..., None] * g_rgb
            dL_da = tr * gc_dot_c + (g_alpha * tr_final - s_k) / one_minus_a
            dL_da = jnp.where(active & ~clamped, dL_da, 0.0)
            dL_dc = jnp.where(active[..., None], dL_dc, 0.0)

            # TF-table scatter (transpose of the 2-bin lerp fetch).
            g_rgba = jnp.concatenate([dL_dc, dL_da[..., None]], axis=-1)
            flat_g = g_rgba.reshape(-1, 4)
            flat_lo = lo.reshape(-1)
            flat_hi = hi.reshape(-1)
            flat_w = w.reshape(-1, 1)
            tf_g = tf_g.at[flat_lo].add(flat_g * (1.0 - flat_w))
            tf_g = tf_g.at[flat_hi].add(flat_g * flat_w)

            # Density gradient via the TF lerp: d rgba / dt = (hi - lo) * N.
            n = tf.shape[0]
            drgba_dt = (tf[hi] - tf[lo]) * n
            dL_dt = jnp.sum(g_rgba * drgba_dt, axis=-1)
            dL_dt = jnp.where(active, dL_dt, 0.0)
            dL_ddensity = dL_dt * inv_window

            # Window scalars: t = (d - dmin) * inv; dt/ddmin = inv*(t-1),
            # dt/ddmax = -t*inv.
            dmin_g = dmin_g + jnp.sum(dL_dt * (t - 1.0) * inv_window)
            dmax_g = dmax_g + jnp.sum(dL_dt * (-t) * inv_window)

            # Voxel-grid scatter (transpose of the 8-corner gather).
            for iz, iy, ix, valid, weight in corners:
                contrib = jnp.where(valid, dL_ddensity * weight, 0.0).reshape(-1)
                vol_g = vol_g.at[iz.reshape(-1), iy.reshape(-1), ix.reshape(-1)].add(contrib)

            tr = tr * (1.0 - a)
            return (tr, p_new, vol_g, tf_g, dmin_g, dmax_g)

        (tr, p, vol_g, tf_g, dmin_g, dmax_g) = jax.lax.fori_loop(
            0, num_steps, body,
            (tr0, p0, vol_g0, tf_g0, dmin_g0, dmax_g0),
        )
        if vary_axes:
            # Cotangent types must match the primal args: the grid, TF and
            # window scalars are replicated (device-invariant) inputs, so
            # their per-shard partial gradients all-reduce here — the
            # grid/TF gradient psum, fused into the bwd rule rather than
            # bolted on outside.
            vol_g, tf_g, dmin_g, dmax_g = jax.lax.psum(
                (vol_g, tf_g, dmin_g, dmax_g), vary_axes)
        zeros3 = jnp.zeros(3, jnp.float32)
        return (vol_g, tf_g, jnp.zeros_like(origin), jnp.zeros_like(dirs),
                dmin_g, dmax_g, zeros3, zeros3)

    march.defvjp(march_fwd, march_bwd)
    return march
