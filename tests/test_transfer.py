"""Transfer-function model and differentiable texture lookup tests
(vs ``src/ui/components/gradient.cpp`` semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reference_marcher import sample1d_edge

from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.transfer.texture import sample_tf
from volumetric_renderer.utils.color import pack_rgba8, unpack_rgba8


def test_default_gradient_black_to_white():
    g = Gradient()
    np.testing.assert_allclose(g.sample(0.0), [0, 0, 0, 1], atol=1e-7)
    np.testing.assert_allclose(g.sample(1.0), [1, 1, 1, 1], atol=1e-7)
    np.testing.assert_allclose(g.sample(0.5), [0.5, 0.5, 0.5, 1], atol=1e-7)


def test_sample_clamps_and_lerps():
    g = Gradient(
        color_markers=[(0.0, (1, 0, 0)), (0.5, (0, 1, 0)), (1.0, (0, 0, 1))],
        alpha_markers=[(0.0, 0.0), (1.0, 1.0)],
    )
    np.testing.assert_allclose(g.sample(-5.0), [1, 0, 0, 0], atol=1e-7)
    np.testing.assert_allclose(g.sample(5.0), [0, 0, 1, 1], atol=1e-7)
    np.testing.assert_allclose(g.sample(0.25), [0.5, 0.5, 0, 0.25], atol=1e-7)


def test_discretize_texel_centers():
    g = Gradient()  # ramp
    table = g.discretize(4)
    locs = (np.arange(4) + 0.5) / 4
    np.testing.assert_allclose(table[:, 0], locs, atol=1e-6)
    assert table.shape == (4, 4)


def test_discretize_packed_roundtrip():
    g = Gradient(
        color_markers=[(0.0, (0.2, 0.4, 0.6)), (1.0, (0.9, 0.1, 0.3))],
        alpha_markers=[(0.0, 0.7), (1.0, 0.2)],
    )
    packed = g.discretize_packed(16)
    unpacked = unpack_rgba8(packed)
    np.testing.assert_allclose(unpacked, g.discretize(16), atol=1.0 / 255.0)
    # IM_COL32 byte order: R low byte
    assert pack_rgba8(np.array([1.0, 0, 0, 0]))[()] == 0xFF


def test_marker_editing_endpoints_locked():
    g = Gradient()
    idx = g.add_color_marker(0.5, (1, 0, 0))
    assert idx == 1
    assert not g.remove_color_marker(0)
    assert not g.remove_color_marker(len(g.color_markers) - 1)
    assert g.remove_color_marker(idx)
    # add clamps location into [0,1] and keeps endpoints first/last
    g.add_alpha_marker(-3.0, 0.5)
    assert g.alpha_markers[0][0] == 0.0


def test_sample_tf_matches_sampler_emulation():
    rng = np.random.default_rng(0)
    table = rng.uniform(size=(256, 4)).astype(np.float32)
    ts = np.concatenate(
        [rng.uniform(-0.3, 1.3, size=500), [0.0, 1.0, -1.0, 2.0, 0.5]]
    ).astype(np.float32)
    got = np.asarray(sample_tf(jnp.asarray(table), jnp.asarray(ts)))
    want = np.stack([sample1d_edge(table.astype(np.float64), t) for t in ts])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sample_tf_gradient_flows():
    table = jnp.ones((8, 4), jnp.float32) * 0.5

    def f(tab):
        return jnp.sum(sample_tf(tab, jnp.array([0.3, 0.7], jnp.float32)))

    g = jax.grad(f)(table)
    assert float(jnp.sum(g)) == pytest.approx(8.0, rel=1e-5)
    assert float(jnp.sum(jnp.abs(g))) > 0


def test_marker_move_drag_semantics():
    # mirrors gradient.cpp:565-592: clamp, sort-order shuffle, endpoints
    # locked and never displaced
    g = Gradient()
    i_a = g.add_color_marker(0.3, (1, 0, 0))
    i_b = g.add_color_marker(0.6, (0, 1, 0))
    assert (i_a, i_b) == (1, 2)
    # drag A past B: shuffles up exactly one slot
    ni = g.move_color_marker(i_a, 0.7)
    assert ni == 2
    assert g.color_markers[1][0] == 0.6          # B slid down
    assert g.color_markers[2][0] == 0.7
    np.testing.assert_array_equal(g.color_markers[2][1], [1, 0, 0])
    # drag past the end: clamps to 1.0 but parks at len-2, endpoint intact
    ni = g.move_color_marker(ni, 5.0)
    assert ni == len(g.color_markers) - 2
    assert g.color_markers[ni][0] == 1.0
    assert g.color_markers[-1][0] == 1.0         # locked endpoint still last
    # endpoints refuse to move (state.dragging never arms for them)
    assert g.move_color_marker(0, 0.5) == 0
    assert g.color_markers[0][0] == 0.0
    last = len(g.alpha_markers) - 1
    assert g.move_alpha_marker(last, 0.2) == last
    assert g.alpha_markers[last][0] == 1.0


def test_marker_set_value_in_place():
    g = Gradient()
    i = g.add_alpha_marker(0.4, 0.9)
    g.set_alpha_marker(i, 0.25)
    assert g.alpha_markers[i] == (0.4, 0.25)
    # endpoints re-colorable (only drag/delete are locked in the editor)
    g.set_color_marker(0, (0.5, 0.5, 0.5))
    assert g.color_markers[0][0] == 0.0
    np.testing.assert_allclose(g.color_markers[0][1], [0.5, 0.5, 0.5])
    # the edit flows into discretize
    t = g.discretize(8)
    np.testing.assert_allclose(t[0, :3], [0.5, 0.5, 0.5], atol=0.1)
