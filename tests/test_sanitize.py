"""Sanitizer-equivalent layer (SURVEY §5): checkify NaN trapping,
NaN-masking semantics, determinism, and the sRGB TF parity option
(SURVEY §7.4.6 / offscreen_pass.cpp:1076)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from volumetric_renderer.data.volume import Volume
from volumetric_renderer.render.api import render
from volumetric_renderer.scene.camera import OrbitCamera
from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.utils.color import (
    linear_to_srgb,
    linearize_tf_table,
    srgb_to_linear,
)
from volumetric_renderer.utils.config import RenderSettings
from volumetric_renderer.utils.sanitize import (
    assert_deterministic,
    checked_render,
)

SETTINGS = RenderSettings(height=24, width=24, step_size=1.8 / 24,
                          early_termination=False)


@pytest.fixture(scope="module")
def scene():
    vol = Volume.synthetic_sphere(16).as_jax()
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(16))
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    return vol, tf, cam


@pytest.mark.slow
def test_checked_render_clean(scene):
    vol, tf, cam = scene
    err, img = checked_render(vol, tf, cam, SETTINGS,
                              density_min=0.0, density_max=1.0)
    err.throw()  # no error on a clean scene
    ref = render(vol, tf, cam, SETTINGS, density_min=0.0, density_max=1.0)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))


def test_checked_render_traps_nan_volume(scene):
    vol, tf, cam = scene
    bad = vol.at[8, 8, 8].set(jnp.nan)
    err, _ = checked_render(bad, tf, cam, SETTINGS,
                            density_min=0.0, density_max=1.0)
    with pytest.raises(Exception, match="nan"):
        err.throw()


def test_checked_render_rejects_pallas(scene):
    vol, tf, cam = scene
    with pytest.raises(ValueError, match="XLA paths"):
        checked_render(vol, tf, cam, SETTINGS, method="march")


def test_nan_voxels_masked_by_slicing(scene):
    """NaN voxels excluded by the slicing window must not contaminate the
    image: the slicing test zeroes opacity via jnp.where, which blocks
    NaN propagation (the masked-compositing contract)."""
    vol, tf, cam = scene
    bad = vol.at[:4].set(jnp.nan)  # poison low-z slab (z < 0.25)
    img = render(bad, tf, cam, SETTINGS, density_min=0.0, density_max=1.0,
                 slice_min=jnp.array([0.0, 0.0, 0.35]),
                 slice_max=jnp.ones(3))
    assert np.isfinite(np.asarray(img)).all()


def test_render_deterministic(scene):
    vol, tf, cam = scene
    fn = jax.jit(lambda v, t: render(v, t, cam, SETTINGS,
                                     density_min=0.0, density_max=1.0))
    assert_deterministic(fn, vol, tf, runs=3)


def test_assert_deterministic_catches_mutation(scene):
    vol, tf, cam = scene
    state = {"n": 0}

    def flaky(v):
        state["n"] += 1
        return v + jnp.float32(state["n"])

    with pytest.raises(AssertionError, match="nondeterministic"):
        assert_deterministic(flaky, vol)


# -- sRGB transfer-function parity (reference sampler semantics) ----------

def test_srgb_roundtrip():
    x = jnp.linspace(0.0, 1.0, 257)
    np.testing.assert_allclose(np.asarray(linear_to_srgb(srgb_to_linear(x))),
                               np.asarray(x), atol=1e-6)
    # continuity at the piecewise boundary
    lo, hi = srgb_to_linear(jnp.float32(0.040449)), srgb_to_linear(
        jnp.float32(0.040451))
    assert abs(float(hi) - float(lo)) < 1e-5


def test_render_tf_srgb_matches_manual_decode(scene):
    """tf_srgb=True == decoding each texel with the sRGB EOTF (the
    independent NumPy formula below) before the standard lerp lookup —
    texel-before-filter order, as the reference's R8G8B8A8_SRGB sampler."""
    vol, tf, cam = scene

    t = np.asarray(tf, np.float64)
    rgb = t[:, :3]
    decoded = np.where(rgb <= 0.04045, rgb / 12.92,
                       ((rgb + 0.055) / 1.055) ** 2.4)
    manual = jnp.asarray(np.concatenate([decoded, t[:, 3:]], axis=1),
                         jnp.float32)

    got = render(vol, tf, cam, SETTINGS, density_min=0.0, density_max=1.0,
                 tf_srgb=True)
    ref = render(vol, manual, cam, SETTINGS, density_min=0.0,
                 density_max=1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)
    # alpha channel is NOT decoded
    np.testing.assert_array_equal(
        np.asarray(linearize_tf_table(tf))[:, 3], np.asarray(tf)[:, 3])
