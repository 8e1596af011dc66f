"""Sanitizer-equivalent layer (SURVEY §5).

The reference's only runtime checking is the Vulkan validation layer in
debug builds (``src/rendering/vulkan_context.cpp:20-28``) plus structural
race-freedom (single thread, ``wait_till_idle`` before resource swaps,
``offscreen_pass.cpp:242,260,282``).  The equivalents here:

* :func:`checked_render` — a ``jax.experimental.checkify`` wrapper over
  the XLA render paths that traps NaN/Inf production inside the march
  (the moral equivalent of running under the validation layer).
* Determinism in place of a race detector: the renderer is a pure
  function of its inputs, so two runs must be *bitwise* identical —
  asserted by :func:`assert_deterministic` and the test suite.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import checkify


@functools.lru_cache(maxsize=None)
def _checked_fn(settings, method):
    from volumetric_renderer.render.api import render

    def f(vol, tf_table, camera, dmin, dmax, smin, smax):
        return render(vol, tf_table, camera, settings,
                      density_min=dmin, density_max=dmax,
                      slice_min=smin, slice_max=smax, method=method)

    return checkify.checkify(f, errors=checkify.float_checks)


def checked_render(vol, tf_table, camera, settings, *, density_min=None,
                   density_max=None, slice_min=None, slice_max=None,
                   method: str = "fused"):
    """Render with NaN/Inf checks enabled.

    Returns ``(err, rgba)``; call ``err.throw()`` to raise on the first
    non-finite value produced anywhere in the march.  XLA methods only
    (oracle/fused/blocked) — checkify cannot instrument a Pallas kernel
    body; use the parity tests to validate the march kernel instead.
    """
    if method not in ("oracle", "fused", "blocked"):
        raise ValueError("checked_render instruments XLA paths only "
                         "(oracle/fused/blocked)")
    vol = jnp.asarray(vol, jnp.float32)
    dmin = jnp.asarray(jnp.min(vol) if density_min is None else density_min,
                       jnp.float32)
    dmax = jnp.asarray(jnp.max(vol) if density_max is None else density_max,
                       jnp.float32)
    smin = (jnp.zeros(3, jnp.float32) if slice_min is None
            else jnp.asarray(slice_min, jnp.float32))
    smax = (jnp.ones(3, jnp.float32) if slice_max is None
            else jnp.asarray(slice_max, jnp.float32))
    f = _checked_fn(settings, method)
    return f(vol, jnp.asarray(tf_table, jnp.float32), camera,
             dmin, dmax, smin, smax)


def assert_deterministic(fn, *args, runs: int = 2):
    """Run ``fn(*args)`` ``runs`` times and assert bitwise-equal outputs.

    The replacement for a race detector on a platform without data races:
    any nondeterminism would indicate unsynchronized reduction order or
    uninitialized memory.  Returns the first output.
    """
    first = jax.tree.map(lambda x: jnp.asarray(x), fn(*args))
    first_np = jax.tree.map(lambda x: x.copy(), jax.device_get(first))
    for _ in range(runs - 1):
        again = jax.device_get(fn(*args))
        # per-position comparison: a != b is True at NaN positions even for
        # bitwise-identical arrays, so exempt positions where BOTH are NaN
        mismatch = jax.tree.map(
            lambda a, b: bool(((a != b) & ~((a != a) & (b != b))).any()),
            first_np, again)
        if any(jax.tree.leaves(mismatch)):
            raise AssertionError("nondeterministic output across runs")
    return first
