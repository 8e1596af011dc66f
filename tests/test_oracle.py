"""Oracle marcher vs the independent NumPy transliteration of volume.frag.

Small shapes keep the scalar-loop golden marcher fast; a full BASELINE
config-1 comparison (64^3 sphere, 256x256, 128 steps) runs under
``-m slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from reference_marcher import RefCamera, ref_render, sample3d_border

from volumetric_renderer.core.marcher import render_oracle
from volumetric_renderer.core.sampling import ray_box_intersect, trilinear_sample
from volumetric_renderer.data.volume import Volume
from volumetric_renderer.scene.camera import OrbitCamera
from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.utils.config import RenderSettings


def make_scene(n=16, drags=((40.0, 25.0),), radius=3.0):
    vol = Volume.synthetic_sphere(n).data
    tf = Gradient.grayscale_ramp().discretize(64)
    ref_cam = RefCamera()
    cam = OrbitCamera.create()
    for d in drags:
        ref_cam.rotate(np.array(d))
        cam = cam.rotate(np.array(d, np.float32))
    ref_cam.zoom(3.0 - radius)
    cam = cam.zoom(3.0 - radius)
    return vol, tf, ref_cam, cam


def test_trilinear_matches_sampler_emulation():
    rng = np.random.default_rng(1)
    vol = rng.uniform(size=(5, 6, 7)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, size=(300, 3)).astype(np.float32)
    got = np.asarray(trilinear_sample(jnp.asarray(vol), jnp.asarray(pts)))
    want = np.array([sample3d_border(vol.astype(np.float64), p) for p in pts])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ray_box():
    o = jnp.array([0.5, -2.0, 0.5])
    d = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]])
    t_in, t_out, hit = ray_box_intersect(o, d)
    assert bool(hit[0]) and not bool(hit[1]) and not bool(hit[2])
    assert float(t_in[0]) == pytest.approx(2.0)
    assert float(t_out[0]) == pytest.approx(3.0)
    # camera inside the box -> miss (back-face culling semantics)
    _, _, hit_in = ray_box_intersect(
        jnp.array([0.5, 0.5, 0.5]), jnp.array([[1.0, 0.0, 0.0]])
    )
    assert not bool(hit_in[0])


@pytest.mark.parametrize("drags", [((0.0, 0.0),), ((40.0, 25.0),), ((200.0, -60.0), (15.0, 10.0))])
def test_oracle_matches_reference_small(drags):
    vol, tf, ref_cam, cam = make_scene(16, drags)
    s = RenderSettings(
        height=24, width=32, step_size=0.02, ray_dist=1.8,
        early_termination=False,
    )
    want = ref_render(vol, tf, ref_cam, s.height, s.width,
                      step_size=s.step_size, ray_dist=s.ray_dist)
    got = np.asarray(render_oracle(jnp.asarray(vol), jnp.asarray(tf), cam, s))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_oracle_slicing_and_window_match_reference():
    vol, tf, ref_cam, cam = make_scene(12)
    s = RenderSettings(height=16, width=16, step_size=0.03,
                       early_termination=False)
    smin, smax = (0.1, 0.2, 0.0), (0.9, 0.8, 0.7)
    want = ref_render(
        vol, tf, ref_cam, s.height, s.width,
        step_size=s.step_size, slice_min=smin, slice_max=smax,
        density_min=0.1, density_max=0.8,
    )
    got = np.asarray(render_oracle(
        jnp.asarray(vol), jnp.asarray(tf), cam, s,
        slice_min=jnp.array(smin), slice_max=jnp.array(smax),
        density_min=0.1, density_max=0.8,
    ))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_early_termination_close_to_exact():
    vol, tf, ref_cam, cam = make_scene(16)
    tf_opaque = tf.copy()
    tf_opaque[:, 3] = np.linspace(0.0, 0.9, tf.shape[0])  # saturating rays
    s_exact = RenderSettings(height=16, width=16, step_size=0.01,
                             early_termination=False)
    s_term = s_exact.replace(early_termination=True, termination_eps=1e-4)
    a = np.asarray(render_oracle(jnp.asarray(vol), jnp.asarray(tf_opaque), cam, s_exact))
    b = np.asarray(render_oracle(jnp.asarray(vol), jnp.asarray(tf_opaque), cam, s_term))
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_miss_pixels_are_zero():
    vol, tf, _, cam = make_scene(8)
    s = RenderSettings(height=8, width=8, step_size=0.05)
    img = np.asarray(render_oracle(jnp.asarray(vol), jnp.asarray(tf), cam, s))
    # corner pixels miss the cube at radius 3 with 40deg fov
    assert np.all(img[0, 0] == 0.0)
    assert np.all(img[-1, -1] == 0.0)


@pytest.mark.slow
def test_baseline_config1_full():
    """BASELINE config 1: 64^3 sphere, 256x256, 128 steps, grayscale ramp."""
    vol, tf, ref_cam, cam = make_scene(64, ((30.0, 20.0),))
    s = RenderSettings(height=256, width=256, step_size=1.8 / 128,
                       early_termination=False)
    assert s.num_steps == 128
    want = ref_render(vol, tf, ref_cam, 256, 256, step_size=s.step_size)
    got = np.asarray(render_oracle(jnp.asarray(vol), jnp.asarray(tf), cam, s))
    diff = np.abs(got - want).max(axis=-1)
    # Silhouette pixels can gain/lose one compositing step when a sample
    # lands within float32-epsilon of the exit face — an inherent boundary
    # degeneracy of fixed-step marching, not a math error.  Require the
    # image to match everywhere except a vanishing set of such pixels.
    assert np.mean(diff) < 1e-5
    assert np.sum(diff > 5e-4) <= 8  # < 0.02% of 65536 pixels
    assert float(diff.max()) < 2e-2  # and flips are single-sample-sized
