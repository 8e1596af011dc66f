"""models/ and ops/ public-surface tests."""

import jax.numpy as jnp
import numpy as np

from volumetric_renderer import models, ops


def test_sphere_and_shells():
    v = models.sphere(16)
    assert v.dimensions == (16, 16, 16)
    assert 0.0 <= v.vmin <= v.vmax <= 1.0
    s = models.shells(16)
    assert s.data.shape == (16, 16, 16)


def test_head_phantom_structure():
    v = models.head_phantom(32)
    d = v.data
    assert d.shape == (32, 32, 32)
    # skull shell is denser than brain interior
    assert d.max() > 0.8
    c = d[16, 16, 16]
    assert 0.0 <= c < 0.8
    # deterministic for a fixed seed
    v2 = models.head_phantom(32)
    np.testing.assert_array_equal(d, v2.data)


def test_ops_composite_step():
    rgb = jnp.zeros((2, 3))
    tr = jnp.ones(2)
    rgb, tr = ops.composite_step(rgb, tr, jnp.ones((2, 3)), jnp.full(2, 0.5))
    np.testing.assert_allclose(np.asarray(rgb), 0.5)
    np.testing.assert_allclose(np.asarray(tr), 0.5)
    # second step accumulates with reduced transmittance
    rgb, tr = ops.composite_step(rgb, tr, jnp.ones((2, 3)), jnp.full(2, 0.5))
    np.testing.assert_allclose(np.asarray(rgb), 0.75)
    np.testing.assert_allclose(np.asarray(tr), 0.25)


def test_ops_reexports_work():
    vol = jnp.ones((4, 4, 4))
    pts = jnp.full((5, 3), 0.5)
    np.testing.assert_allclose(np.asarray(ops.trilinear_sample(vol, pts)), 1.0)
    t_entry, t_exit, hit = ops.ray_box_intersect(
        jnp.array([0.5, 0.5, -1.0]), jnp.array([[0.0, 0.0, 1.0]]))
    assert bool(hit[0])
    np.testing.assert_allclose(float(t_entry[0]), 1.0)
