"""Public render API.

The functional equivalent of the reference's render loop
(``OffscreenPass::record`` -> ``volume.frag``): one call renders one frame.
The interactive mutation entry points (``volume_dataset_changed``,
``transfer_function_changed``, ``slicing_changed``,
``framebuffer_size_changed`` — ``src/rendering/offscreen_pass.h:46-54``)
collapse into plain function arguments: pass a different volume / TF table /
slicing window / ``RenderSettings`` and you have "mutated" the renderer.

Methods:
  * ``"oracle"`` — pure ``fori_loop`` marcher, plain autodiff.  Ground truth.
  * ``"fused"``  — same math behind a custom VJP whose backward re-marches
    (O(1) memory in step count).  The production method on the CPU.
  * ``"blocked"`` — fused math with per-row-block adaptive trip counts
    (``while_loop``): background blocks skip the march entirely, saturated
    blocks stop early.
  * ``"march"`` — the ray-march kernel for the GPU (``kernels/march.py``,
    Pallas through Triton): one program per ray tile, ray state in
    registers, an early exit per tile, and a kernel backward.  It compiles
    only for the GPU; ``interpret=True`` runs it on the CPU for tests.
  * ``"auto"`` (default) — :func:`production_method` for the backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from volumetric_renderer.core.fused import make_fused_marcher
from volumetric_renderer.core.marcher import march_rays
from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer.utils.config import RenderSettings

METHODS = ("oracle", "fused", "blocked", "march")

# the production marcher of each backend, chosen by measurement on the
# card (PERF.md, Findings)
_PRODUCTION = {"gpu": "march", "cpu": "fused"}


def production_method(backend: str | None = None) -> str:
    """The marcher ``method="auto"`` runs on ``backend`` (default: JAX's
    default backend).  The one place a backend picks a method."""
    backend = backend or jax.default_backend()
    if backend not in _PRODUCTION:
        raise ValueError(f"no production marcher for backend {backend!r}")
    return _PRODUCTION[backend]


def make_marcher(method: str, settings: RenderSettings, *,
                 vary_axes: tuple = (), interpret: bool = False):
    """The marcher ``f(vol, tf, origin, dirs, dmin, dmax, smin, smax) ->
    rgba`` behind ``method`` (``"auto"`` resolved per backend), for
    ``render`` and the sharded renderer alike.  ``vary_axes`` names the
    mesh axes when it runs inside a ``shard_map``; ``interpret`` runs the
    kernel method through Pallas' CPU interpreter (tests only)."""
    if method == "auto":
        method = production_method()
    march_kw = (settings.num_steps, settings.step_size,
                settings.early_termination, settings.termination_eps)
    if method == "fused":
        return make_fused_marcher(*march_kw, vary_axes=vary_axes)
    if method == "blocked":
        from volumetric_renderer.core.blocked import make_blocked_marcher

        return make_blocked_marcher(*march_kw, vary_axes=vary_axes)
    if method == "march":
        from volumetric_renderer.kernels.march import make_march_marcher

        return make_march_marcher(*march_kw, vary_axes=vary_axes,
                                  interpret=interpret)
    raise ValueError(f"unknown method {method!r}; expected one of "
                     f"{('auto',) + METHODS}")


def _prep(vol, camera, settings, density_min, density_max, slice_min, slice_max):
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
    return (
        origin_world + 0.5,  # world cube [-0.5,0.5]^3 -> texture space
        dirs,
        jnp.asarray(density_min, jnp.float32),
        jnp.asarray(density_max, jnp.float32),
        jnp.asarray(slice_min, jnp.float32),
        jnp.asarray(slice_max, jnp.float32),
    )


def render(
    vol: jnp.ndarray,
    tf_table: jnp.ndarray,
    camera: OrbitCamera,
    settings: RenderSettings = RenderSettings(),
    *,
    density_min=None,
    density_max=None,
    slice_min=None,
    slice_max=None,
    method: str = "auto",
    interpret: bool = False,
    tf_srgb: bool = False,
) -> jnp.ndarray:
    """Render one ``(H, W, 4)`` RGBA frame.

    ``vol``: float32 ``(Z, Y, X)`` density grid.  ``tf_table``: float32
    ``(N, 4)`` RGBA transfer function (see ``transfer``).  RGB is the
    front-to-back accumulation, alpha is opacity; composite over a
    background with :func:`composite_over`.

    ``method`` is one of :data:`METHODS` or ``"auto"`` (see the module
    docstring); ``interpret=True`` runs ``"march"`` on the CPU (tests).

    ``tf_srgb=True`` treats the TF table's RGB as sRGB-encoded and decodes
    it before lookup — byte-for-byte the reference's ``R8G8B8A8_SRGB`` TF
    sampler (``offscreen_pass.cpp:1076``), which linearizes texels ahead
    of the linear filter.  The default (False) is this framework's
    linear-throughout convention (SURVEY §7.4.6).
    """
    if tf_srgb:
        from volumetric_renderer.utils.color import linearize_tf_table

        tf_table = linearize_tf_table(tf_table)
    origin, dirs, dmin, dmax, smin, smax = _prep(
        vol, camera, settings, density_min, density_max, slice_min, slice_max
    )
    if method == "oracle":
        return march_rays(
            vol, tf_table, origin, dirs,
            density_min=dmin, density_max=dmax,
            slice_min=smin, slice_max=smax,
            num_steps=settings.num_steps, step_size=settings.step_size,
            early_termination=settings.early_termination,
            termination_eps=settings.termination_eps,
        )
    marcher = make_marcher(method, settings, interpret=interpret)
    return marcher(vol, tf_table, origin, dirs, dmin, dmax, smin, smax)


def composite_over(rgba: jnp.ndarray, background, reference_blend: bool = False):
    """Composite a rendered frame over an RGB background.

    The renderer's RGB output is premultiplied-by-construction (each sample
    adds ``T * a * c``), so the correct operator is
    ``rgb + bg * (1 - alpha)``.  The reference instead configures standard
    (non-premultiplied) alpha blending over its 0.11-gray clear color
    (``offscreen_pass.cpp:171``, blend state ``offscreen_pass.cpp:715-726``),
    i.e. ``rgb * alpha + bg * (1 - alpha)`` — double-weighting the volume
    color by alpha.  Pass ``reference_blend=True`` to reproduce that quirk.
    """
    bg = jnp.asarray(background, jnp.float32)
    a = rgba[..., 3:4]
    if reference_blend:
        return rgba[..., :3] * a + bg * (1.0 - a)
    return rgba[..., :3] + bg * (1.0 - a)


def adjust_display(rgb: jnp.ndarray, brightness: float = 0.0,
                   contrast: float = 0.0):
    """Display-space brightness/contrast post-process.

    The reference shows Brightness/Contrast sliders in its Display panel
    but never pushes them to the renderer — they are UI-only dead state
    (static locals, ``src/ui/main_window.cpp:191-205``).  Here they work:
    ``out = (rgb - 0.5) * (1 + contrast) + 0.5 + brightness``, clipped to
    [0, 1], applied after :func:`composite_over`.
    """
    out = (rgb - 0.5) * (1.0 + contrast) + 0.5 + brightness
    return jnp.clip(out, 0.0, 1.0)


def render_loss_and_grads(
    vol, tf_table, camera, target,
    settings: RenderSettings = RenderSettings(),
    *,
    loss: str = "l2",
    method: str = "auto",
    **kw,
):
    """Convenience: pixel loss against ``target`` plus grads w.r.t.
    ``(vol, tf_table)``.  Used by the TF-fit and grid-inversion apps."""
    import jax

    def loss_fn(v, tf):
        img = render(v, tf, camera, settings, method=method, **kw)
        diff = img[..., :3] - target[..., :3]
        if loss == "l2":
            return 0.5 * jnp.mean(diff * diff)
        if loss == "l1":
            return jnp.mean(jnp.abs(diff))
        raise ValueError(f"unknown loss {loss!r}")

    (value, grads) = jax.value_and_grad(loss_fn, argnums=(0, 1))(vol, tf_table)
    return value, grads
