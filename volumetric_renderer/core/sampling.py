"""Volume sampling: trilinear interpolation with GPU sampler semantics.

Replicates the reference's ``sampler3D`` configuration
(``src/rendering/offscreen_pass.cpp:1014-1039``): VK_FILTER_LINEAR with
VK_SAMPLER_ADDRESS_MODE_CLAMP_TO_BORDER and a transparent-black border — a
fetch whose 2x2x2 neighborhood reaches outside the volume blends toward
density 0 instead of clamping to the edge texel.

Volume layout: ``vol[z, y, x]`` (x fastest), matching NRRD axis order where
axis 0 is fastest (``src/data/nrrd_file_parser.cpp:32-33``).  A normalized
texture coordinate ``u = (ux, uy, uz)`` addresses texel centers at
``(i + 0.5) / N`` per axis.
"""

from __future__ import annotations

import jax.numpy as jnp


def trilinear_sample(vol: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Sample ``vol[Z, Y, X]`` at normalized coords ``pts[..., 3] = (x, y, z)``.

    Border handling: out-of-range corner texels contribute 0 (transparent
    black border), i.e. the corner's weight is kept but its value is zeroed —
    exactly what CLAMP_TO_BORDER linear filtering computes.
    """
    zdim, ydim, xdim = vol.shape
    dims = jnp.array([xdim, ydim, zdim], dtype=pts.dtype)
    # Texel space: coordinate u covers texel centers at (i+0.5)/N.
    f = pts * dims - 0.5
    i0 = jnp.floor(f)
    w = f - i0  # per-axis lerp weight toward the +1 corner
    i0 = i0.astype(jnp.int32)

    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]

    out = jnp.zeros(pts.shape[:-1], dtype=vol.dtype)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                valid = (
                    (ix >= 0) & (ix < xdim)
                    & (iy >= 0) & (iy < ydim)
                    & (iz >= 0) & (iz < zdim)
                )
                v = vol[
                    jnp.clip(iz, 0, zdim - 1),
                    jnp.clip(iy, 0, ydim - 1),
                    jnp.clip(ix, 0, xdim - 1),
                ]
                weight = (
                    (wx if dx else 1.0 - wx)
                    * (wy if dy else 1.0 - wy)
                    * (wz if dz else 1.0 - wz)
                )
                out = out + jnp.where(valid, v, 0.0) * weight
    return out


def trilinear_sample_flat(vol: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """:func:`trilinear_sample` computed with ONE flat gather.

    Identical semantics (linear filter, CLAMP_TO_BORDER transparent
    black) with one gather of 8 indices per sample in place of 8 gathers.
    Which form XLA runs faster on the H100 is not measured.

    Border exactness: the fetch base is clamped to ``[0, dim-2]`` so all
    8 fetched cells are in-bounds, and each cell's weight is assigned by
    *coordinate match* against the true corner indices ``i0``/``i0+1`` —
    a corner outside the volume matches no fetched cell and contributes
    zero, which is precisely the transparent-black border.
    """
    zdim, ydim, xdim = vol.shape
    if min(vol.shape) < 2:
        # a 2-cell fetch base needs dim >= 2 (e.g. the reference's 1^3
        # placeholder volume, offscreen_pass.cpp:118): use the naive path
        return trilinear_sample(vol, pts)
    dims = jnp.array([xdim, ydim, zdim], dtype=pts.dtype)
    f = pts * dims - 0.5
    i0 = jnp.floor(f)
    w = f - i0
    i0 = i0.astype(jnp.int32)

    def axis_weights(i0a, wa, bca):
        # weight of fetched cells bca + {0, 1} along one axis
        lo_w = jnp.where(bca == i0a, 1.0 - wa, 0.0) + \
            jnp.where(bca == i0a + 1, wa, 0.0)
        hi_c = bca + 1
        hi_w = jnp.where(hi_c == i0a, 1.0 - wa, 0.0) + \
            jnp.where(hi_c == i0a + 1, wa, 0.0)
        return lo_w, hi_w

    bx = jnp.clip(i0[..., 0], 0, xdim - 2)
    by = jnp.clip(i0[..., 1], 0, ydim - 2)
    bz = jnp.clip(i0[..., 2], 0, zdim - 2)
    wx0, wx1 = axis_weights(i0[..., 0], w[..., 0], bx)
    wy0, wy1 = axis_weights(i0[..., 1], w[..., 1], by)
    wz0, wz1 = axis_weights(i0[..., 2], w[..., 2], bz)

    flat = vol.reshape(-1)
    base = (bz * ydim + by) * xdim + bx
    offs = jnp.array(
        [0, 1, xdim, xdim + 1,
         ydim * xdim, ydim * xdim + 1, ydim * xdim + xdim,
         ydim * xdim + xdim + 1], jnp.int32)
    # indices are in bounds by construction (base clamped to dim-2);
    # "clip" is the cheapest accepted mode (no fill mask)
    vals = jnp.take(flat, (base[..., None] + offs).reshape(-1),
                    unique_indices=False, indices_are_sorted=False,
                    mode="clip").reshape(base.shape + (8,))
    return (wz0 * (wy0 * (wx0 * vals[..., 0] + wx1 * vals[..., 1])
                   + wy1 * (wx0 * vals[..., 2] + wx1 * vals[..., 3]))
            + wz1 * (wy0 * (wx0 * vals[..., 4] + wx1 * vals[..., 5])
                     + wy1 * (wx0 * vals[..., 6] + wx1 * vals[..., 7])))


def ray_box_intersect(origin: jnp.ndarray, dirs: jnp.ndarray,
                      box_min: float = 0.0, box_max: float = 1.0):
    """Slab test of rays against the axis-aligned box ``[box_min, box_max]^3``.

    ``origin``: ``(3,)``; ``dirs``: ``(..., 3)`` unit directions.
    Returns ``(t_entry, t_exit, hit)``.

    ``hit`` additionally requires ``t_entry >= 0``: the reference draws the
    cube with back-face culling (``offscreen_pass.cpp:680``), so a camera
    *inside* the cube rasterizes nothing — such rays are misses here too.
    """
    inv = 1.0 / dirs  # inf on zero components is fine under min/max
    t0 = (box_min - origin) * inv
    t1 = (box_max - origin) * inv
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    t_entry = jnp.max(t_near, axis=-1)
    t_exit = jnp.min(t_far, axis=-1)
    hit = (t_entry <= t_exit) & (t_entry >= 0.0)
    # Miss rays can carry t = +/-inf (axis-parallel dirs); downstream
    # ``origin + t_entry * dirs`` would produce inf*0 = NaN entry points
    # whose *weights* poison gradients even under activity masking (an
    # int32 cast of NaN can land in-bounds, and 0 * NaN = NaN in the
    # scatter).  Misses park at t = 0 (pos = origin, outside the cube).
    t_entry = jnp.where(hit, t_entry, 0.0)
    t_exit = jnp.where(hit, t_exit, 0.0)
    return t_entry, t_exit, hit
