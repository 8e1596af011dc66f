"""Row-block adaptive marcher vs fused (identical per-step math)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumetric_renderer.core.blocked import make_blocked_marcher
from volumetric_renderer.core.fused import make_fused_marcher
from volumetric_renderer.data.volume import Volume
from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer.transfer.gradient import Gradient

NUM_STEPS, STEP = 48, 0.035


def scene(h=40, w=24):
    vol = Volume.synthetic_sphere(12).as_jax()
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(32))
    tf = tf.at[:, 3].set(jnp.linspace(0.0, 0.9, 32))
    cam = OrbitCamera.from_angles(yaw_deg=33.0, pitch_deg=21.0)
    origin, dirs = ray_grid(cam, h, w)
    args = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))
    return vol, tf, origin + 0.5, dirs, args


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("block_rows", [8, 64])
def test_blocked_matches_fused(early, block_rows):
    vol, tf, origin, dirs, args = scene()
    fused = make_fused_marcher(NUM_STEPS, STEP, early, 1.0 / 255.0)
    blocked = make_blocked_marcher(NUM_STEPS, STEP, early, 1.0 / 255.0,
                                   block_rows=block_rows)
    want = np.asarray(fused(vol, tf, origin, dirs, *args))
    got = np.asarray(blocked(vol, tf, origin, dirs, *args))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.slow
def test_blocked_under_jit_and_grad():
    vol, tf, origin, dirs, args = scene()
    blocked = make_blocked_marcher(NUM_STEPS, STEP, False, 1.0 / 255.0,
                                   block_rows=16)
    fused = make_fused_marcher(NUM_STEPS, STEP, False, 1.0 / 255.0)

    out = jax.jit(blocked)(vol, tf, origin, dirs, *args)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(fused(vol, tf, origin, dirs, *args)),
                               atol=1e-6)

    def lb(v, t):
        return jnp.sum(jnp.sin(3.0 * blocked(v, t, origin, dirs, *args)))

    def lf(v, t):
        return jnp.sum(jnp.sin(3.0 * fused(v, t, origin, dirs, *args)))

    gb = jax.grad(lb, argnums=(0, 1))(vol, tf)
    gf = jax.grad(lf, argnums=(0, 1))(vol, tf)
    for a, b in zip(gb, gf):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=2e-6)


def test_blocked_all_miss_is_cheap_and_black():
    # camera inside the cube -> every ray misses (back-face culling
    # semantics); output must be all zeros
    vol, tf, _, _, args = scene()
    cam = OrbitCamera.from_angles(yaw_deg=0.0, pitch_deg=0.0, radius=0.2)
    origin, dirs = ray_grid(cam, 16, 16)
    blocked = make_blocked_marcher(NUM_STEPS, STEP, True, 1.0 / 255.0)
    out = np.asarray(blocked(vol, tf, origin + 0.5, dirs, *args))
    assert np.all(out == 0.0)
