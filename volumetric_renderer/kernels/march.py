"""Ray-march kernel for NVIDIA Hopper (Pallas, Triton route).

One program marches one tile of rays front to back, the way the
reference's fragment shader marches one fragment
(``res/shaders/volume.frag:21-51``):

* the tile's ray directions are loaded once and the cube entry and exit
  are computed in the kernel;
* RGB and transmittance stay in registers across a ``while_loop`` over
  steps, which ends as soon as every ray of the tile has left the cube or
  (with early termination) fallen to ``termination_eps``;
* each sample is 8 masked gathers from the flat volume in device memory
  and 2 row lookups of the transfer-function (TF) table;
* the output is written once.

The backward re-marches each tile with the prefix-sum identity of
``core.fused`` (no stored per-step state).  Voxel gradients go to a flat
f32 buffer with ``atomic_add``.  The TF-table gradient is reduced inside
each program, as a one-hot matrix product over the tile's rays per step,
before one atomic add per program: two million rays adding straight into
256 x 4 bins would serialise on the same addresses.  The density-window
gradients are per-ray sums reduced the same way.

Semantics are exactly those of ``core.fused`` (CLAMP_TO_BORDER trilinear
for any grid shape, CLAMP_TO_EDGE TF lerp, the ``ALPHA_EPS`` opacity
clamp, strict slicing bounds, the density window, misses parked at
t = 0), for any camera, any image size (padded to the tile) and any grid
shape with fewer than 2**31 voxels.

``interpret=True`` runs the kernels through Pallas' CPU interpreter; only
tests pass it.  The interpreter applies an ``atomic_add`` whose indices
repeat within one call as a plain scatter that keeps one of the repeated
updates, so there the voxel gradient is added with an explicit
scatter-add instead (:func:`_add_at`); everything else is the same code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from volumetric_renderer.core.fused import ALPHA_EPS

_AMAX = 1.0 - ALPHA_EPS
# TF-gradient accumulator columns: 0-3 lower bin, 4-7 upper bin, rest pad
# (Triton's dot needs both operand dimensions >= 16)
_ACC_COLS = 16
# TF bins per one-hot chunk in the backward's per-step reduction
_BIN_CHUNK = 64


def _pack_params(origin, dmin, dmax, smin, smax):
    """The kernels' scalars: origin xyz, dmin, dmax, slice min/max xyz."""
    return jnp.concatenate([jnp.asarray(x, jnp.float32).reshape(-1)
                            for x in (origin, dmin, dmax, smin, smax)])


def _ray_setup(prm, d, step_size):
    """Entry point, hit mask and step bound of each ray (as
    ``core.sampling.ray_box_intersect`` + the entry clamp of
    ``core.fused``).  Returns ``(pos0, hit, k_exit)``."""
    t_near, t_far = [], []
    nan = False
    for c in range(3):
        inv = 1.0 / d[c]
        t0 = (0.0 - prm[c]) * inv
        t1 = (1.0 - prm[c]) * inv
        t_near.append(jnp.minimum(t0, t1))
        t_far.append(jnp.maximum(t0, t1))
        # XLA's min/max propagate NaN (origin on a face, axis-parallel
        # ray) into a miss; Triton's drop it, so test for it explicitly
        nan = nan | jnp.isnan(t0) | jnp.isnan(t1)
    t_entry = jnp.maximum(jnp.maximum(t_near[0], t_near[1]), t_near[2])
    t_exit = jnp.minimum(jnp.minimum(t_far[0], t_far[1]), t_far[2])
    hit = (t_entry <= t_exit) & (t_entry >= 0.0) & ~nan
    t_entry = jnp.where(hit, t_entry, 0.0)
    t_exit = jnp.where(hit, t_exit, 0.0)
    pos0 = tuple(jnp.clip(prm[c] + t_entry * d[c], 1e-6, 1.0 - 1e-6)
                 for c in range(3))
    # no sample at k >= k_exit is inside the cube (2 steps of margin over
    # the entry clamp, as core.blocked)
    k_exit = jnp.where(hit, (t_exit - t_entry) / step_size + 2.0, 0.0)
    return pos0, hit, k_exit


def _inv_window(prm):
    dmin, dmax = prm[3], prm[4]
    return jnp.where(dmax - dmin > 0.0,
                     1.0 / jnp.maximum(dmax - dmin, 1e-30), 0.0)


def _sample(k, pos0, d, hit, tr, prm, vol_ref, tf_ref, *, vol_shape,
            n_tf, num_steps, step_size, early_termination, termination_eps):
    """One march step's sample: activity, trilinear density, TF lookup.

    Returns a dict with everything the forward and backward use."""
    del num_steps  # the loop's bound, not the sample's
    zdim, ydim, xdim = vol_shape
    kf = k.astype(jnp.float32)
    pos = tuple(pos0[c] + (kf * step_size) * d[c] for c in range(3))
    active = hit
    for c in range(3):
        active = (active & (pos[c] >= 0.0) & (pos[c] <= 1.0)
                  & (pos[c] < prm[8 + c]) & (pos[c] > prm[5 + c]))
    if early_termination:
        active = active & (tr > termination_eps)

    # CLAMP_TO_BORDER trilinear: a corner outside the grid reads 0 (its
    # index is clipped in bounds and its load masked off)
    axes = []
    for p, n in zip(pos, (xdim, ydim, zdim)):
        f = p * float(n) - 0.5
        i0f = jnp.floor(f)
        w = f - i0f
        i0 = i0f.astype(jnp.int32)
        i1 = i0 + 1
        axes.append((
            (jnp.clip(i0, 0, n - 1), (i0 >= 0) & (i0 < n), 1.0 - w),
            (jnp.clip(i1, 0, n - 1), (i1 >= 0) & (i1 < n), w)))
    ax, ay, az = axes
    corners, vals = [], []
    for cz, vz, wz in az:
        for cy, vy, wy in ay:
            for cx, vx, wx in ax:
                idx = (cz * ydim + cy) * xdim + cx
                valid = vz & vy & vx
                corners.append((idx, valid, (wx * wy) * wz))
                vals.append(plgpu.load(vol_ref.at[idx], mask=active & valid,
                                       other=0.0))
    (wx0, wx1), (wy0, wy1), (wz0, wz1) = [(a[0][2], a[1][2]) for a in axes]
    density = (wz0 * (wy0 * (wx0 * vals[0] + wx1 * vals[1])
                      + wy1 * (wx0 * vals[2] + wx1 * vals[3]))
               + wz1 * (wy0 * (wx0 * vals[4] + wx1 * vals[5])
                        + wy1 * (wx0 * vals[6] + wx1 * vals[7])))

    inv_window = _inv_window(prm)
    t = (density - prm[3]) * inv_window
    t = jnp.where(active, t, 0.0)  # NaN-voxel containment
    x = t * n_tf - 0.5
    i0f = jnp.floor(x)
    w = x - i0f
    i0 = i0f.astype(jnp.int32)
    lo = jnp.clip(i0, 0, n_tf - 1)
    hi = jnp.clip(i0 + 1, 0, n_tf - 1)
    tf_lo = [plgpu.load(tf_ref.at[lo * 4 + c]) for c in range(4)]
    tf_hi = [plgpu.load(tf_ref.at[hi * 4 + c]) for c in range(4)]
    rgba = [tf_lo[c] * (1.0 - w) + tf_hi[c] * w for c in range(4)]
    return dict(active=active, corners=corners, t=t, lo=lo, hi=hi, w=w,
                tf_lo=tf_lo, tf_hi=tf_hi, rgba=rgba, inv_window=inv_window)


def _add_at(ref, idx, val, mask, interpret):
    """``ref[idx] += val`` where ``mask``, repeated indices summed: an
    atomic add on the GPU, a scatter-add in the interpreter (which has
    neither masked nor repeat-safe atomics; ``val`` is zero off the
    mask)."""
    if interpret:
        ref[...] = ref[...].at[idx].add(val)
    else:
        plgpu.atomic_add(ref, idx, val, mask=mask)


def _march_loop(step, hit, k_exit, step_fn, carry):
    """``carry = step_fn(k, carry)`` for ``k = 0, 1, ...`` while any ray of
    the tile can still contribute (inside the cube and, with early
    termination, transmissive; ``carry[0]`` is the transmittance).

    A ``fori_loop`` over all steps whose body is skipped once the tile is
    done: Triton lowers it to ``scf.for`` around ``scf.if``, where a
    general ``while_loop`` would carry every pointer and mask through the
    loop."""
    def live(k, tr):
        alive = hit & (k.astype(jnp.float32) < k_exit)
        if step["early_termination"]:
            alive = alive & (tr > step["termination_eps"])
        return jnp.max(alive.astype(jnp.int32))

    def body(k, state):
        go, carry = state

        def run(carry):
            carry = step_fn(k, carry)
            return live(k + 1, carry[0]), carry

        return jax.lax.cond(go > 0, run, lambda c: (go, c), carry)

    _, carry = jax.lax.fori_loop(0, step["num_steps"], body,
                                 (live(jnp.int32(0), carry[0]), carry))
    return carry


def _forward_kernel(p_ref, vol_ref, tf_ref, dx_ref, dy_ref, dz_ref,
                    r_ref, g_ref, b_ref, a_ref, t_ref, *, step, vol_shape,
                    n_tf):
    prm = [p_ref[i] for i in range(11)]
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    pos0, hit, k_exit = _ray_setup(prm, d, step["step_size"])
    zero = jnp.zeros_like(d[0])

    def step_fn(k, carry):
        tr, r, g, b = carry
        s = _sample(k, pos0, d, hit, tr, prm, vol_ref, tf_ref,
                    vol_shape=vol_shape, n_tf=n_tf, **step)
        a = jnp.where(s["active"], jnp.minimum(s["rgba"][3], _AMAX), 0.0)
        ta = tr * a
        r = r + ta * s["rgba"][0]
        g = g + ta * s["rgba"][1]
        b = b + ta * s["rgba"][2]
        return tr * (1.0 - a), r, g, b

    tr, r, g, b = _march_loop(step, hit, k_exit, step_fn,
                              (jnp.ones_like(zero), zero, zero, zero))
    r_ref[...] = r
    g_ref[...] = g
    b_ref[...] = b
    a_ref[...] = jnp.where(hit, 1.0 - tr, 0.0)
    t_ref[...] = tr


def _backward_kernel(p_ref, vol_ref, tf_ref, dx_ref, dy_ref, dz_ref,
                     r_ref, g_ref, b_ref, trf_ref,
                     gr_ref, gg_ref, gb_ref, ga_ref,
                     gvol_in, gtf_in, gwin_in,
                     gvol_ref, gtf_ref, gwin_ref, *, step, vol_shape, n_tf,
                     n_bins, interpret):
    del gvol_in, gtf_in, gwin_in  # aliased to the outputs (zero-filled)
    prm = [p_ref[i] for i in range(11)]
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    pos0, hit, k_exit = _ray_setup(prm, d, step["step_size"])
    g_rgb = (gr_ref[...], gg_ref[...], gb_ref[...])
    # alpha is a hard 0 on misses, so its cotangent flows on hits only
    g_alpha = jnp.where(hit, ga_ref[...], 0.0)
    tr_final = trf_ref[...]
    big_g = g_rgb[0] * r_ref[...] + g_rgb[1] * g_ref[...] \
        + g_rgb[2] * b_ref[...]
    zero = jnp.zeros_like(d[0])
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, _BIN_CHUNK), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, _ACC_COLS), 1)

    def step_fn(k, carry):
        tr, p, gdmin, gdmax, acc = carry
        s = _sample(k, pos0, d, hit, tr, prm, vol_ref, tf_ref,
                    vol_shape=vol_shape, n_tf=n_tf, **step)
        active, rgba, t = s["active"], s["rgba"], s["t"]
        clamped = rgba[3] > _AMAX
        a = jnp.where(active, jnp.minimum(rgba[3], _AMAX), 0.0)
        gc_dot_c = g_rgb[0] * rgba[0] + g_rgb[1] * rgba[1] \
            + g_rgb[2] * rgba[2]
        p = p + tr * a * gc_dot_c
        s_k = big_g - p                        # suffix sum over j > k
        one_minus_a = jnp.maximum(1.0 - a, ALPHA_EPS)
        dl_da = tr * gc_dot_c + (g_alpha * tr_final - s_k) / one_minus_a
        dl_da = jnp.where(active & ~clamped, dl_da, 0.0)
        g_rgba = [jnp.where(active, (tr * a) * g_rgb[c], 0.0)
                  for c in range(3)] + [dl_da]

        # density gradient through the TF lerp: d rgba / dt = (hi-lo) * N
        dl_dt = sum(g_rgba[c] * ((s["tf_hi"][c] - s["tf_lo"][c]) * n_tf)
                    for c in range(4))
        dl_dt = jnp.where(active, dl_dt, 0.0)
        inv_window = s["inv_window"]
        gdmin = gdmin + dl_dt * (t - 1.0) * inv_window
        gdmax = gdmax + dl_dt * (-t) * inv_window
        dl_ddensity = dl_dt * inv_window
        for idx, valid, weight in s["corners"]:
            m = active & valid
            _add_at(gvol_ref, idx, jnp.where(m, dl_ddensity * weight, 0.0),
                    m, interpret)

        # TF gradient: the lower bin takes g * (1 - w), the upper g * w.
        # Where the edge clamp makes both the same bin, both parts go to
        # the lower columns; the upper columns are shifted up one bin when
        # the table is assembled (hi == lo + 1 otherwise).
        lo, hi, w = s["lo"], s["hi"], s["w"]
        same = hi == lo
        parts = [g_rgba[c] * (1.0 - w) + jnp.where(same, g_rgba[c] * w, 0.0)
                 for c in range(4)]
        parts += [jnp.where(same, 0.0, g_rgba[c] * w) for c in range(4)]
        rhs = jnp.zeros((lo.shape[0], _ACC_COLS), jnp.float32)
        for c, v in enumerate(parts):
            rhs = jnp.where(cols == c, v[:, None], rhs)
        acc = tuple(
            a_j + pl.dot((lo[:, None] == bins + j * _BIN_CHUNK)
                         .astype(jnp.float32), rhs, trans_a=True,
                         precision=jax.lax.Precision.HIGHEST)
            for j, a_j in enumerate(acc))

        return tr * (1.0 - a), p, gdmin, gdmax, acc

    acc0 = tuple(jnp.zeros((_BIN_CHUNK, _ACC_COLS), jnp.float32)
                 for _ in range(n_bins // _BIN_CHUNK))
    _, _, gdmin, gdmax, acc = _march_loop(
        step, hit, k_exit, step_fn,
        (jnp.ones_like(zero), zero, zero, zero, acc0))
    for j, a_j in enumerate(acc):
        plgpu.atomic_add(gtf_ref, (pl.ds(j * _BIN_CHUNK, _BIN_CHUNK),
                                slice(None)), a_j)
    plgpu.atomic_add(gwin_ref, 0, jnp.sum(gdmin))
    plgpu.atomic_add(gwin_ref, 1, jnp.sum(gdmax))


def _tile_planes(x, tile, mode):
    """``(H, W, C)`` -> C flat planes in tile-major order (each tile's
    ``th * tw`` rays contiguous), padding H and W to the tile."""
    th, tw = tile
    h, w, c = x.shape
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    x = jnp.pad(x, ((0, hp - h), (0, wp - w), (0, 0)), mode=mode)
    x = x.reshape(hp // th, th, wp // tw, tw, c).transpose(4, 0, 2, 1, 3)
    return tuple(x.reshape(c, -1))


def _untile(planes, h, w, tile):
    th, tw = tile
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    x = jnp.stack(planes, axis=-1)
    x = x.reshape(hp // th, wp // tw, th, tw, len(planes))
    return x.transpose(0, 2, 1, 3, 4).reshape(hp, wp, -1)[:h, :w]


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


@functools.lru_cache(maxsize=None)
def make_march_marcher(num_steps: int, step_size: float,
                       early_termination: bool, termination_eps: float,
                       *, tile: tuple = (16, 16), vary_axes: tuple = (),
                       interpret: bool = False):
    """Build the kernel marcher for static march settings.

    Returns ``f(vol, tf_table, origin, dirs, density_min, density_max,
    slice_min, slice_max) -> rgba`` with the contract of
    ``core.fused.make_fused_marcher``: ``dirs`` is ``(H, W, 3)`` (or any
    ``(..., 3)``), the result ``dirs.shape[:-1] + (4,)``, and a custom VJP
    gives gradients for the grid, the TF table and the density window.

    ``tile``: rays per program as ``(rows, cols)``, a power of two in all;
    16 x 16 matches the pixel tiles of ``parallel.mesh.make_layout``.
    ``vary_axes``: mesh axes the marcher runs under inside a ``shard_map``
    with ``check_vma=True``; the kernels' outputs are declared varying
    over them and the replicated inputs' gradients are ``psum``'d here.
    ``interpret``: run on the CPU through Pallas' interpreter (tests).
    """
    th, tw = tile
    n_ray = th * tw
    if n_ray & (n_ray - 1):
        raise ValueError(f"tile {tile} must hold a power of two of rays")
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the ray-march kernel compiles only for the GPU; pass "
            "interpret=True to run it on the CPU, or use method='fused'")
    step = dict(num_steps=num_steps, step_size=step_size,
                early_termination=early_termination,
                termination_eps=termination_eps)
    vma = frozenset(vary_axes) if vary_axes else None
    params = dict(num_warps=4, num_stages=1)
    ray_spec = pl.BlockSpec((n_ray,), lambda i: (i,))
    whole = pl.no_block_spec     # the whole array, indexed in the kernel

    def _vary(x):
        if not vary_axes:
            return x
        have = getattr(jax.typeof(x), "vma", frozenset())
        need = tuple(a for a in vary_axes if a not in have)
        return jax.lax.pcast(x, need, to="varying") if need else x

    def _inputs(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        if vol.size >= 2 ** 31:
            raise ValueError(f"grid of {vol.size} voxels: the kernel "
                             "indexes voxels with int32")
        lead = dirs.shape[:-1]
        dirs3 = dirs.reshape((1, -1, 3) if len(lead) != 2 else dirs.shape)
        planes = _tile_planes(dirs3.astype(jnp.float32), tile, "edge")
        p = _pack_params(origin, dmin, dmax, smin, smax)
        return (lead, dirs3.shape[:2], p,
                jnp.asarray(vol, jnp.float32).reshape(-1),
                jnp.asarray(tf, jnp.float32).reshape(-1), planes)

    def _forward(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        lead, (h, w), p, vol_flat, tf_flat, dplanes = _inputs(
            vol, tf, origin, dirs, dmin, dmax, smin, smax)
        n = dplanes[0].shape[0]
        kernel = functools.partial(_forward_kernel, step=step,
                                   vol_shape=tuple(vol.shape),
                                   n_tf=tf.shape[0])
        outs = pl.pallas_call(
            kernel,
            grid=(n // n_ray,),
            in_specs=[whole, whole, whole, ray_spec, ray_spec, ray_spec],
            out_specs=[ray_spec] * 5,
            out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32, vma=vma)] * 5,
            backend="triton",
            compiler_params=plgpu.CompilerParams(**params),
            interpret=interpret,
            name="march_forward",
        )(p, vol_flat, tf_flat, *dplanes)
        rgba = _untile(outs[:4], h, w, tile).reshape(lead + (4,))
        return rgba, outs

    def _backward(vol, tf, origin, dirs, dmin, dmax, smin, smax, planes, g):
        lead, (h, w), p, vol_flat, tf_flat, dplanes = _inputs(
            vol, tf, origin, dirs, dmin, dmax, smin, smax)
        n = dplanes[0].shape[0]
        n_tf = tf.shape[0]
        n_bins = max(_BIN_CHUNK, _next_pow2(n_tf))
        gplanes = _tile_planes(
            g.reshape((h, w, 4)).astype(jnp.float32), tile, "constant")
        r, gg, b, _, trf = planes
        kernel = functools.partial(
            _backward_kernel, step=step, vol_shape=tuple(vol.shape),
            n_tf=n_tf, n_bins=n_bins, interpret=interpret)
        zeros = [_vary(jnp.zeros(s, jnp.float32))
                 for s in (vol_flat.shape, (n_bins, _ACC_COLS), (2,))]
        out_shape = [jax.ShapeDtypeStruct(z.shape, jnp.float32, vma=vma)
                     for z in zeros]
        gvol, gacc, gwin = pl.pallas_call(
            kernel,
            grid=(n // n_ray,),
            in_specs=[whole, whole, whole] + [ray_spec] * 11
            + [whole] * 3,
            out_specs=[whole] * 3,
            out_shape=out_shape,
            input_output_aliases={14: 0, 15: 1, 16: 2},
            backend="triton",
            compiler_params=plgpu.CompilerParams(**params),
            interpret=interpret,
            name="march_backward",
        )(p, vol_flat, tf_flat, *dplanes, r, gg, b, trf, *gplanes, *zeros)
        # assemble the table: lower-bin columns in place, upper-bin
        # columns one bin up
        gtf = gacc[:n_tf, :4] + jnp.pad(gacc[:n_tf - 1, 4:8],
                                        ((1, 0), (0, 0)))
        return gvol.reshape(vol.shape), gtf, gwin[0], gwin[1]

    @jax.custom_vjp
    def march(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        return _forward(vol, tf, origin, dirs, dmin, dmax, smin, smax)[0]

    def march_fwd(vol, tf, origin, dirs, dmin, dmax, smin, smax):
        out, planes = _forward(vol, tf, origin, dirs, dmin, dmax, smin, smax)
        return out, (vol, tf, origin, dirs, dmin, dmax, smin, smax, planes)

    def march_bwd(res, g):
        vol, tf, origin, dirs, dmin, dmax, smin, smax, planes = res
        vol_g, tf_g, dmin_g, dmax_g = _backward(
            vol, tf, origin, dirs, dmin, dmax, smin, smax, planes, g)
        if vary_axes:
            # per-shard partial gradients of replicated inputs all-reduce
            # here (check_vma=True inserts no psum of its own)
            vol_g, tf_g, dmin_g, dmax_g = jax.lax.psum(
                (vol_g, tf_g, dmin_g, dmax_g), vary_axes)
        zeros3 = jnp.zeros(3, jnp.float32)
        return (vol_g, tf_g, jnp.zeros_like(origin), jnp.zeros_like(dirs),
                dmin_g.reshape(jnp.shape(dmin)), dmax_g.reshape(jnp.shape(dmax)),
                zeros3, zeros3)

    march.defvjp(march_fwd, march_bwd)
    return march
