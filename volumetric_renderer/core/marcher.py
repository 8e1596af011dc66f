"""Pure-JAX reference ray-marcher — the framework's correctness oracle.

A faithful ``jnp`` re-statement of the reference fragment shader
``res/shaders/volume.frag:21-51``:

  * ray per pixel from the camera through the pixel center
    (``volume.frag:23``; the shader gets the cube entry point for free from
    rasterization — here it comes from an analytic slab test),
  * fixed-step march, ``steps = int(ray_dist / step_size)``
    (``volume.frag:29-31``),
  * break on leaving ``[0,1]^3`` — strict inequalities, a sample exactly on
    the face still contributes (``volume.frag:33-37``),
  * per-sample slicing window test, strict inequalities
    (``volume.frag:39-40``),
  * density -> normalized ``t = (d - min) / (max - min)``
    (``volume.frag:41-42``),
  * 1D transfer-function fetch (``volume.frag:43``),
  * front-to-back compositing with transmittance carried in alpha:
    ``rgb += T * a_s * rgb_s; T *= 1 - a_s``; final ``alpha = 1 - T``
    (``volume.frag:44-50``),
  * plus optional early-ray termination on transmittance ~ 0, which the
    reference lacks (its only exit is the bounds break).

This module is deliberately simple ``fori_loop`` code: it runs on any
backend, differentiates by plain autodiff, and is the ground truth that
the production kernel (``kernels/march.py``) must match to < 1e-4.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from volumetric_renderer.core.sampling import ray_box_intersect, trilinear_sample
from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer.transfer.texture import sample_tf
from volumetric_renderer.utils.config import RenderSettings


def march_rays(
    vol: jnp.ndarray,
    tf_table: jnp.ndarray,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    *,
    density_min: jnp.ndarray,
    density_max: jnp.ndarray,
    slice_min: jnp.ndarray,
    slice_max: jnp.ndarray,
    num_steps: int,
    step_size: float,
    early_termination: bool = False,
    termination_eps: float = 1.0 / 255.0,
) -> jnp.ndarray:
    """March a batch of rays; returns RGBA of shape ``dirs.shape[:-1] + (4,)``.

    ``origin`` is the camera position in *texture* space (world + 0.5);
    ``dirs`` are unit world directions (translation-invariant, so identical
    in texture space).  RGB is the accumulated front-to-back sum; alpha is
    opacity ``1 - T``.  Pixels whose rays miss the cube are ``(0, 0, 0, 0)``
    (no fragment in the reference).
    """
    t_entry, _, hit = ray_box_intersect(origin, dirs)
    # The exact entry point is ON the cube face; float rounding can land it
    # epsilon outside (masking the first sample via the bounds test) or
    # exactly on a face (masking it via the strict slicing test,
    # volume.frag:39-40).  Clamp strictly inside; the golden marcher uses
    # the same epsilon.
    pos0 = jnp.clip(origin + t_entry[..., None] * dirs, 1e-6, 1.0 - 1e-6)

    # dtype follows the rays so the oracle doubles as a float64 ground
    # truth for numerics studies (jax_enable_x64 + f64 inputs).
    rgb0 = jnp.zeros(dirs.shape[:-1] + (3,), dtype=dirs.dtype)
    trans0 = jnp.ones(dirs.shape[:-1], dtype=dirs.dtype)

    # Degenerate window (constant volume: min == max) would divide by zero;
    # the reference shader has the same hazard (volume.frag:42).  Guard it:
    # a constant volume normalizes to t = 0 everywhere.
    inv_window = jnp.where(
        density_max - density_min > 0.0,
        1.0 / jnp.maximum(density_max - density_min, 1e-30),
        0.0,
    )

    def body(k, carry):
        rgb, trans = carry
        pos = pos0 + (k.astype(dirs.dtype) * step_size) * dirs
        # Bounds break (volume.frag:33-37). The box is convex so positions
        # never re-enter: a pure mask is equivalent to the shader's `break`.
        inside = jnp.all((pos >= 0.0) & (pos <= 1.0), axis=-1)
        # Slicing window, strict comparisons (volume.frag:39-40).
        sliced = jnp.all((pos < slice_max) & (pos > slice_min), axis=-1)
        active = inside & sliced & hit
        if early_termination:
            active = active & (trans > termination_eps)

        density = trilinear_sample(vol, pos)
        t = (density - density_min) * inv_window
        # The reference skips masked samples before fetching
        # (volume.frag:39-40 `continue`s); here the fetch is unconditional,
        # so zero t for masked lanes to keep non-finite voxel values from
        # leaking through `0 * NaN` in the composite.
        t = jnp.where(active, t, 0.0)
        rgba = sample_tf(tf_table, t)
        a = jnp.where(active, rgba[..., 3], 0.0)
        rgb = rgb + (trans * a)[..., None] * rgba[..., :3]
        trans = trans * (1.0 - a)
        return (rgb, trans)

    # fori_loop: a static trip count and no per-step outputs
    (rgb, trans) = jax.lax.fori_loop(
        0, num_steps, body, (rgb0, trans0)
    )
    alpha = jnp.where(hit, 1.0 - trans, 0.0)
    return jnp.concatenate([rgb, alpha[..., None]], axis=-1)


def render_oracle(
    vol: jnp.ndarray,
    tf_table: jnp.ndarray,
    camera: OrbitCamera,
    settings: RenderSettings,
    *,
    density_min: Optional[jnp.ndarray] = None,
    density_max: Optional[jnp.ndarray] = None,
    slice_min: Optional[jnp.ndarray] = None,
    slice_max: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Render an ``(H, W, 4)`` image with the pure-JAX oracle marcher.

    Defaults mirror the reference UBO defaults
    (``offscreen_pass.h:29-37``): slicing window [0,1]^3; the density window
    defaults to the volume's min/max as set on import
    (``offscreen_pass.cpp:265-266``).
    """
    if density_min is None:
        density_min = jnp.min(vol)
    if density_max is None:
        density_max = jnp.max(vol)
    if slice_min is None:
        slice_min = jnp.zeros(3, jnp.float32)
    if slice_max is None:
        slice_max = jnp.ones(3, jnp.float32)

    origin_world, dirs = ray_grid(
        camera, settings.height, settings.width,
        settings.fov_y_degrees, settings.near, settings.far,
    )
    # The shader marches in texture coords ([0,1]^3 cube); the world cube is
    # [-0.5, 0.5]^3 (offscreen_pass.cpp:55-90), so tex = world + 0.5.
    origin_tex = origin_world + 0.5
    return march_rays(
        vol, tf_table, origin_tex, dirs,
        density_min=jnp.asarray(density_min, jnp.float32),
        density_max=jnp.asarray(density_max, jnp.float32),
        slice_min=jnp.asarray(slice_min, jnp.float32),
        slice_max=jnp.asarray(slice_max, jnp.float32),
        num_steps=settings.num_steps,
        step_size=settings.step_size,
        early_termination=settings.early_termination,
        termination_eps=settings.termination_eps,
    )
