"""The GPU ray-march kernel (``kernels/march.py``) against the oracle.

On the CPU the kernel runs in Pallas' interpret mode: the same kernel
body, lowered to XLA instead of Triton.  Forward outputs must match the
oracle marcher (``core.marcher.march_rays``) and the kernel backward must
match the fused XLA backward (``core.fused``), for every camera, image
size, grid shape and march option the production path accepts.

The interpreter adds voxel gradients with a scatter-add where the GPU
uses atomics (``kernels.march._add_at``); the rest of the kernel is the
same code in both.

Tests marked ``gpu`` compile the kernel for the card and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumetric_renderer.core.fused import make_fused_marcher
from volumetric_renderer.core.marcher import march_rays
from volumetric_renderer.data.volume import Volume
from volumetric_renderer.kernels.march import (
    _tile_planes, _untile, make_march_marcher,
)
from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer.transfer.gradient import Gradient

STEPS, STEP, EPS = 40, 0.05, 1.0 / 255.0
WINDOW = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))


def tf_table(n=32, alpha_max=0.6):
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(n))
    return tf.at[:, 3].set(jnp.linspace(0.0, alpha_max, n))


def rays(h=10, w=13, yaw=33.0, pitch=21.0, radius=3.0):
    cam = OrbitCamera.from_angles(yaw_deg=yaw, pitch_deg=pitch,
                                  radius=radius)
    origin, dirs = ray_grid(cam, h, w)
    return origin + 0.5, dirs


def oracle(vol, tf, origin, dirs, window=WINDOW, et=False, steps=STEPS):
    dmin, dmax, smin, smax = window
    return march_rays(vol, tf, origin, dirs, density_min=dmin,
                      density_max=dmax, slice_min=smin, slice_max=smax,
                      num_steps=steps, step_size=STEP, early_termination=et,
                      termination_eps=EPS)


def kernel(et=False, tile=(4, 4), steps=STEPS):
    return make_march_marcher(steps, STEP, et, EPS, tile=tile,
                              interpret=True)


def check_forward(vol, tf, origin, dirs, window=WINDOW, et=False,
                  tile=(4, 4), steps=STEPS):
    got = kernel(et, tile, steps)(vol, tf, origin, dirs, *window)
    want = oracle(vol, tf, origin, dirs, window, et, steps)
    assert got.shape == dirs.shape[:-1] + (4,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-6)
    return got


@pytest.mark.parametrize("et", [False, True])
def test_forward_matches_oracle(et):
    vol = Volume.synthetic_sphere(12).as_jax()
    # opaque TF so early termination really cuts rays
    check_forward(vol, tf_table(alpha_max=1.0), *rays(), et=et)


def test_forward_slicing_window():
    vol = Volume.synthetic_sphere(12).as_jax()
    window = (jnp.float32(0.1), jnp.float32(0.9),
              jnp.asarray([0.2, 0.0, 0.1]), jnp.asarray([0.9, 0.7, 1.0]))
    check_forward(vol, tf_table(), *rays(), window=window)


def test_forward_camera_inside_cube_is_all_miss():
    vol = Volume.synthetic_sphere(12).as_jax()
    out = check_forward(vol, tf_table(), *rays(radius=0.3))
    np.testing.assert_array_equal(np.asarray(out), 0.0)


def test_forward_axis_parallel_rays():
    """Rays with exact zero direction components, hitting and missing;
    the slab test's inf and 0 * inf = NaN must park misses at t = 0."""
    vol = Volume.synthetic_sphere(8).as_jax()
    origin = jnp.asarray([0.5, 0.37, -1.5])
    dirs = jnp.asarray([[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                         [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]])
    out = check_forward(vol, tf_table(), origin, dirs)
    assert float(out[0, 0, 3]) > 0.0                  # straight through
    np.testing.assert_array_equal(np.asarray(out[0, 1:]), 0.0)


def test_forward_origin_on_face_parallel_ray_is_miss():
    vol = Volume.synthetic_sphere(8).as_jax()
    origin = jnp.asarray([0.0, 0.5, -1.0])           # on the x = 0 plane
    dirs = jnp.asarray([[[0.0, 0.0, 1.0]]])
    out = check_forward(vol, tf_table(), origin, dirs)
    np.testing.assert_array_equal(np.asarray(out), 0.0)


def test_forward_non_cubic_grid():
    zs, ys, xs = np.meshgrid(*(np.linspace(-1, 1, n) for n in (6, 9, 14)),
                             indexing="ij")
    vol = jnp.asarray(np.clip(1.0 - np.sqrt(xs**2 + ys**2 + zs**2), 0, 1),
                      jnp.float32)
    check_forward(vol, tf_table(), *rays(yaw=70.0, pitch=-30.0))


@pytest.mark.parametrize("hw,tile", [((7, 9), (4, 4)), ((5, 3), (8, 2))])
def test_forward_image_not_a_tile_multiple(hw, tile):
    vol = Volume.synthetic_sphere(10).as_jax()
    check_forward(vol, tf_table(), *rays(*hw), tile=tile)


def test_forward_unit_volume():
    """The reference's 1^3 placeholder volume: both trilinear corners of
    every axis clip to cell 0, the border weight blends toward 0."""
    vol = jnp.full((1, 1, 1), 0.8, jnp.float32)
    check_forward(vol, tf_table(), *rays(6, 6))


def test_forward_degenerate_density_window():
    vol = jnp.full((6, 6, 6), 0.5, jnp.float32)
    window = (jnp.float32(0.5), jnp.float32(0.5), jnp.zeros(3), jnp.ones(3))
    check_forward(vol, tf_table(), *rays(6, 6), window=window)


def test_forward_tf_resolution_not_a_power_of_two():
    vol = Volume.synthetic_sphere(10).as_jax()
    check_forward(vol, tf_table(n=100), *rays(8, 8))


def test_forward_flat_ray_batch():
    vol = Volume.synthetic_sphere(10).as_jax()
    origin, dirs = rays(4, 5)
    check_forward(vol, tf_table(), origin, dirs.reshape(20, 3))


def test_forward_same_for_every_tile_shape():
    vol = Volume.synthetic_sphere(10).as_jax()
    origin, dirs = rays(8, 8)
    outs = [np.asarray(kernel(True, tile)(vol, tf_table(alpha_max=1.0),
                                          origin, dirs, *WINDOW))
            for tile in ((1, 1), (2, 8), (8, 8))]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_forward_under_jit():
    vol = Volume.synthetic_sphere(10).as_jax()
    tf = tf_table()
    origin, dirs = rays(6, 6)
    m = kernel()
    got = jax.jit(lambda v, t: m(v, t, origin, dirs, *WINDOW))(vol, tf)
    np.testing.assert_allclose(np.asarray(got), np.asarray(
        oracle(vol, tf, origin, dirs)), atol=2e-6)


def grads(marcher, vol, tf, origin, dirs, window):
    dmin, dmax, smin, smax = window

    def loss(v, t, lo, hi):
        img = marcher(v, t, origin, dirs, lo, hi, smin, smax)
        return jnp.sum(jnp.sin(3.0 * img))       # nonuniform cotangents

    return jax.grad(loss, argnums=(0, 1, 2, 3))(vol, tf, dmin, dmax)


def assert_grads_close(got, want, names):
    for g, w, name in zip(got, want, names):
        g, w = np.asarray(g), np.asarray(w)
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(g - w).max() <= 1e-5 * scale, name


@pytest.mark.parametrize("et", [False, True])
def test_backward_matches_fused_vjp(et):
    vol = Volume.synthetic_sphere(10).as_jax()
    tf = tf_table(alpha_max=1.0 if et else 0.6)
    origin, dirs = rays(6, 7)
    window = (jnp.float32(0.05), jnp.float32(0.95), jnp.zeros(3),
              jnp.ones(3))
    got = grads(kernel(et, (4, 4)), vol, tf, origin, dirs, window)
    want = grads(make_fused_marcher(STEPS, STEP, et, EPS), vol, tf, origin,
                 dirs, window)
    assert_grads_close(got, want, ["vol", "tf", "dmin", "dmax"])


@pytest.mark.parametrize("tile", [(1, 1), (8, 8)])
def test_backward_any_tile(tile):
    """Per-program TF and window reductions over 1 to 64 rays."""
    vol = Volume.synthetic_sphere(10).as_jax()
    tf = tf_table()
    origin, dirs = rays(8, 8)
    got = grads(kernel(False, tile), vol, tf, origin, dirs, WINDOW)
    want = grads(make_fused_marcher(STEPS, STEP, False, EPS), vol, tf,
                 origin, dirs, WINDOW)
    assert_grads_close(got, want, ["vol", "tf", "dmin", "dmax"])


def test_backward_tf_edge_clamps():
    """A density window narrower than the data drives t outside [0, 1],
    where the TF fetch clamps both lerp bins onto one edge texel; a TF
    size that is not a power of two pads the one-hot bins."""
    vol = Volume.synthetic_sphere(10).as_jax()
    tf = tf_table(n=24)
    origin, dirs = rays(5, 5)
    window = (jnp.float32(0.3), jnp.float32(0.6), jnp.zeros(3), jnp.ones(3))
    got = grads(kernel(False, (2, 4)), vol, tf, origin, dirs, window)
    want = grads(make_fused_marcher(STEPS, STEP, False, EPS), vol, tf,
                 origin, dirs, window)
    assert_grads_close(got, want, ["vol", "tf", "dmin", "dmax"])


def test_tile_planes_roundtrip():
    x = jnp.arange(7 * 5 * 3, dtype=jnp.float32).reshape(7, 5, 3)
    planes = _tile_planes(x, (4, 2), "edge")
    assert len(planes) == 3 and planes[0].shape == (8 * 6,)
    # each tile's rays are contiguous: the first tile is rows 0-3, cols 0-1
    np.testing.assert_array_equal(np.asarray(planes[0][:8]),
                                  np.asarray(x[:4, :2, 0]).ravel())
    np.testing.assert_array_equal(np.asarray(_untile(planes, 7, 5, (4, 2))),
                                  np.asarray(x))


def test_kernel_refuses_a_backend_it_cannot_compile_for():
    with pytest.raises(ValueError, match="GPU"):
        make_march_marcher(STEPS, STEP, False, EPS)


def test_kernel_rejects_tiles_not_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        make_march_marcher(STEPS, STEP, False, EPS, tile=(3, 4),
                           interpret=True)


# --- compiled for the card ------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["plain", "et", "slicing", "non_cubic",
                                  "inside", "odd_image"])
def test_gpu_forward_matches_oracle(case):
    vol = Volume.synthetic_sphere(32).as_jax()
    tf = tf_table(256, alpha_max=1.0)
    origin, dirs = rays(45, 61)
    window, et = WINDOW, case == "et"
    if case == "slicing":
        window = (jnp.float32(0.1), jnp.float32(0.9),
                  jnp.asarray([0.2, 0.0, 0.1]), jnp.asarray([0.9, 0.7, 1.0]))
    elif case == "non_cubic":
        vol = vol[:20, :, 5:30]
    elif case == "inside":
        origin, dirs = rays(45, 61, radius=0.3)
    elif case == "odd_image":
        origin, dirs = rays(37, 3)
    m = make_march_marcher(STEPS, STEP, et, EPS)
    got = m(vol, tf, origin, dirs, *window)
    want = oracle(vol, tf, origin, dirs, window, et)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.mark.gpu
def test_gpu_backward_matches_fused_vjp():
    """Full 16x16 tiles: real atomics, summed in any order."""
    vol = Volume.synthetic_sphere(32).as_jax()
    tf = tf_table(256)
    origin, dirs = rays(48, 64)
    window = (jnp.float32(0.05), jnp.float32(0.95), jnp.zeros(3),
              jnp.ones(3))
    got = grads(make_march_marcher(STEPS, STEP, False, EPS), vol, tf,
                origin, dirs, window)
    want = grads(make_fused_marcher(STEPS, STEP, False, EPS), vol, tf,
                 origin, dirs, window)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6)
