"""All render methods must agree (oracle is ground truth)."""

import numpy as np
import jax.numpy as jnp
import pytest

from volumetric_renderer.data.volume import Volume
from volumetric_renderer.render.api import (
    adjust_display, make_marcher, production_method, render,
)
from volumetric_renderer.scene.camera import OrbitCamera
from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.utils.config import RenderSettings


@pytest.fixture(scope="module")
def scene():
    vol = Volume.synthetic_sphere(16).as_jax()
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(32))
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    s = RenderSettings(height=24, width=24, step_size=0.1)
    oracle = np.asarray(render(vol, tf, cam, s, method="oracle"))
    return vol, tf, cam, s, oracle


@pytest.mark.parametrize("method", ["fused", "blocked"])
def test_method_matches_oracle(scene, method):
    vol, tf, cam, s, oracle = scene
    got = np.asarray(render(vol, tf, cam, s, method=method))
    np.testing.assert_allclose(got, oracle, atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["march"])
def test_slab_matches_oracle(scene, method):
    # interpreter mode on CPU; compiled parity: the gpu-marked tests
    vol, tf, cam, s, oracle = scene
    got = np.asarray(render(vol, tf, cam, s, method=method, interpret=True))
    np.testing.assert_allclose(got, oracle, atol=1e-5)


def test_unknown_method_raises(scene):
    vol, tf, cam, s, _ = scene
    with pytest.raises(ValueError):
        render(vol, tf, cam, s, method="nope")


def test_adjust_display():
    rgb = jnp.full((2, 2, 3), 0.5)
    out = adjust_display(rgb, brightness=0.2, contrast=0.0)
    np.testing.assert_allclose(np.asarray(out), 0.7, atol=1e-6)
    out = adjust_display(rgb, brightness=0.0, contrast=1.0)
    np.testing.assert_allclose(np.asarray(out), 0.5, atol=1e-6)  # pivot
    out = adjust_display(jnp.ones((1, 3)), brightness=0.5)
    assert float(out.max()) == 1.0  # clipped


def test_production_method_per_backend():
    """The one backend decision: the kernel on a GPU, fused on the CPU,
    and an error (never a quiet fallback) anywhere else."""
    assert production_method("gpu") == "march"
    assert production_method("cpu") == "fused"
    assert production_method() == "fused"          # this suite's backend
    with pytest.raises(ValueError, match="no production marcher"):
        production_method("rocm")


def test_auto_is_the_production_method(scene):
    vol, tf, cam, s, _ = scene
    assert make_marcher("auto", s) is make_marcher("fused", s)
    np.testing.assert_array_equal(
        np.asarray(render(vol, tf, cam, s, method="auto")),
        np.asarray(render(vol, tf, cam, s, method="fused")))


def test_kernel_method_raises_without_a_gpu(scene):
    vol, tf, cam, s, _ = scene
    with pytest.raises(ValueError, match="compiles only for the GPU"):
        render(vol, tf, cam, s, method="march")


def test_kernel_method_interpreted_matches_oracle(scene):
    vol, tf, cam, s, oracle = scene
    got = np.asarray(render(vol, tf, cam, s, method="march", interpret=True))
    np.testing.assert_allclose(got, oracle, atol=1e-5)
