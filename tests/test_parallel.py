"""Sharded (shard_map over a device mesh) vs single-device rendering.

The reference's only parallelism is the GPU rasterizer marching every
fragment independently (``res/shaders/volume.frag:21-51``, SURVEY.md
§2.4); here the equivalent axis — pixel rows — is sharded over a
``jax.sharding.Mesh``.  Correctness claim: the sharded renderer and its
gradients (grid/TF psum'd inside the custom-VJP bwd) are bitwise-close to
the unsharded fused path on the same inputs.  Runs on 8 virtual CPU
devices (conftest sets ``xla_force_host_platform_device_count``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from volumetric_renderer.core.fused import make_fused_marcher
from volumetric_renderer.data.volume import Volume
from volumetric_renderer.parallel.mesh import make_mesh
from volumetric_renderer.parallel.render import make_sharded_renderer
from volumetric_renderer.parallel.train import init_state, make_train_step
from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.utils.config import RenderSettings


SETTINGS = RenderSettings(height=24, width=16, step_size=0.05,
                          early_termination=False)


def scene(n=12, tf_n=32):
    vol = Volume.synthetic_sphere(n).as_jax()
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(tf_n))
    tf = tf.at[:, 3].set(jnp.linspace(0.0, 0.6, tf_n))
    cam = OrbitCamera.from_angles(yaw_deg=33.0, pitch_deg=21.0)
    fixed = dict(dmin=jnp.float32(0.0), dmax=jnp.float32(1.0),
                 smin=jnp.zeros(3), smax=jnp.ones(3))
    return vol, tf, cam, fixed


def unsharded_render(vol, tf, cam, fixed, settings=SETTINGS):
    marcher = make_fused_marcher(settings.num_steps, settings.step_size,
                                 settings.early_termination,
                                 settings.termination_eps)
    origin, dirs = ray_grid(cam, settings.height, settings.width,
                            settings.fov_y_degrees, settings.near,
                            settings.far)
    return marcher(vol, tf, origin + 0.5, dirs, fixed["dmin"], fixed["dmax"],
                   fixed["smin"], fixed["smax"])


@pytest.mark.parametrize("mesh_spec", [
    ((8,), None),                          # 1D: 8 chips on "tiles"
    ((2, 4), ("hosts", "tiles")),          # 2D: 2 hosts x 4 chips
])
def test_sharded_forward_matches_unsharded(mesh_spec):
    shape, axis_names = mesh_spec
    mesh = make_mesh(jax.devices()[:8], shape=shape, axis_names=axis_names)
    vol, tf, cam, fixed = scene()
    want = unsharded_render(vol, tf, cam, fixed)
    render_fn = make_sharded_renderer(mesh, SETTINGS)
    got = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                    fixed["smin"], fixed["smax"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_sharded_blocked_matches_unsharded():
    """blocked marcher under shard_map: divergent per-shard while_loops."""
    mesh = make_mesh(jax.devices()[:8])
    vol, tf, cam, fixed = scene()
    want = unsharded_render(vol, tf, cam, fixed)
    render_fn = make_sharded_renderer(mesh, SETTINGS, method="blocked")
    got = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                    fixed["smin"], fixed["smax"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_sharded_rows_not_divisible():
    # 24 rows over a 7-device mesh: pad_rows kicks in, padded rays dropped.
    mesh = make_mesh(jax.devices()[:7])
    vol, tf, cam, fixed = scene()
    want = unsharded_render(vol, tf, cam, fixed)
    render_fn = make_sharded_renderer(mesh, SETTINGS)
    got = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                    fixed["smin"], fixed["smax"])
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_sharded_grads_match_unsharded():
    """Grid/TF gradients psum'd in the custom-VJP bwd == unsharded grads."""
    mesh = make_mesh(jax.devices()[:8])
    vol, tf, cam, fixed = scene()
    render_fn = make_sharded_renderer(mesh, SETTINGS)

    def loss_sharded(vol, tf):
        img = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                        fixed["smin"], fixed["smax"])
        return jnp.sum(jnp.sin(3.0 * img))   # nonuniform cotangents

    def loss_unsharded(vol, tf):
        img = unsharded_render(vol, tf, cam, fixed)
        return jnp.sum(jnp.sin(3.0 * img))

    gv_s, gt_s = jax.grad(loss_sharded, argnums=(0, 1))(vol, tf)
    gv_u, gt_u = jax.grad(loss_unsharded, argnums=(0, 1))(vol, tf)
    # Tolerance is scale-aware: the sharded jit compiles ray generation
    # differently than the eager reference (reassociated f32), which the
    # sharp density edge amplifies ~1e-4 relative — measured against a
    # float64 oracle both paths are well inside the BASELINE 1e-4 bound.
    for s, u in ((gv_s, gv_u), (gt_s, gt_u)):
        s, u = np.asarray(s), np.asarray(u)
        np.testing.assert_allclose(s, u, rtol=0,
                                   atol=2e-4 * np.abs(u).max())


def test_forward_has_no_collectives_backward_psums():
    """The scaling-efficiency design invariant, asserted at the HLO level
    (deterministic, unlike wall-clock scaling on a shared-core host):
    the sharded *forward* compiles to zero cross-device collectives —
    every card marches its own pixel rows — and the *backward* contains
    exactly the grid/TF gradient all-reduce (``core/fused.py``
    march_bwd)."""
    mesh = make_mesh(jax.devices()[:8])
    vol, tf, cam, fixed = scene()
    render_fn = make_sharded_renderer(mesh, SETTINGS)

    collectives = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")

    fwd_hlo = render_fn.lower(
        vol, tf, cam, fixed["dmin"], fixed["dmax"], fixed["smin"],
        fixed["smax"]).compile().as_text()
    found = [c for c in collectives if c in fwd_hlo]
    assert not found, f"forward should be communication-free, found {found}"

    def loss(vol, tf):
        img = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                        fixed["smin"], fixed["smax"])
        return jnp.sum(img ** 2)

    bwd_hlo = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(
        vol, tf).compile().as_text()
    assert "all-reduce" in bwd_hlo, "grid/TF gradient psum missing"


SLAB_SETTINGS = RenderSettings(height=24, width=16, step_size=0.05,
                               early_termination=False, tf_resolution=32)


KERNEL = dict(method="march", interpret=True)


@pytest.mark.parametrize("layout", ["contiguous", "cyclic", "tile-cyclic",
                                    "tile-shuffle"])
def test_sharded_slab_forward_matches_unsharded(layout):
    """The GPU production kernel under the mesh (BASELINE config 5 path):
    the ray-march kernel (interpreted here) per shard, every pixel
    layout, vs the unsharded fused reference."""
    mesh = make_mesh(jax.devices()[:8])
    vol, tf, cam, fixed = scene()
    want = unsharded_render(vol, tf, cam, fixed, settings=SLAB_SETTINGS)
    render_fn = make_sharded_renderer(mesh, SLAB_SETTINGS,
                                      row_layout=layout, **KERNEL)
    got = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                    fixed["smin"], fixed["smax"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


@pytest.mark.slow
def test_sharded_slab_grads_match_unsharded():
    """Grid/TF gradients through the kernel backward + shard_map's
    replicated-input psum == unsharded fused grads."""
    mesh = make_mesh(jax.devices()[:8])
    vol, tf, cam, fixed = scene()
    render_fn = make_sharded_renderer(mesh, SLAB_SETTINGS, **KERNEL)

    def loss_sharded(vol, tf):
        img = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                        fixed["smin"], fixed["smax"])
        return jnp.sum(jnp.sin(3.0 * img))

    def loss_unsharded(vol, tf):
        img = unsharded_render(vol, tf, cam, fixed, settings=SLAB_SETTINGS)
        return jnp.sum(jnp.sin(3.0 * img))

    gv_s, gt_s = jax.grad(loss_sharded, argnums=(0, 1))(vol, tf)
    gv_u, gt_u = jax.grad(loss_unsharded, argnums=(0, 1))(vol, tf)
    for s, u in ((gv_s, gv_u), (gt_s, gt_u)):
        s, u = np.asarray(s), np.asarray(u)
        np.testing.assert_allclose(s, u, rtol=0,
                                   atol=2e-4 * np.abs(u).max())


@pytest.mark.slow
def test_sharded_slab_hlo_audit():
    """Config-5 invariant on the GPU production path: the kernel forward
    compiles to zero collectives (cyclic layout with shard-order output —
    the training configuration), backward carries the grid/TF
    all-reduce."""
    mesh = make_mesh(jax.devices()[:8])
    vol, tf, cam, fixed = scene()
    render_fn = make_sharded_renderer(mesh, SLAB_SETTINGS,
                                      row_layout="cyclic",
                                      permuted_output=True, **KERNEL)
    collectives = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")
    fwd_hlo = render_fn.lower(
        vol, tf, cam, fixed["dmin"], fixed["dmax"], fixed["smin"],
        fixed["smax"]).compile().as_text()
    found = [c for c in collectives if c in fwd_hlo]
    assert not found, f"kernel forward should be communication-free: {found}"

    def loss(vol, tf):
        img = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                        fixed["smin"], fixed["smax"])
        return jnp.sum(img ** 2)

    bwd_hlo = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(
        vol, tf).compile().as_text()
    assert "all-reduce" in bwd_hlo, "kernel grid/TF gradient psum missing"


@pytest.mark.parametrize("layout", ["contiguous", "cyclic", "tile-cyclic",
                                    "tile-shuffle"])
@pytest.mark.parametrize("hw", [(24, 16), (30, 20), (48, 48)])
def test_make_layout_roundtrip(layout, hw):
    """pack -> unpack is the identity on any (H, W, C); valid marks
    exactly the true pixels (pack of ones == valid)."""
    from volumetric_renderer.parallel.mesh import make_layout

    h, w = hw
    for n in (3, 8):
        gh, gw, pack, unpack, valid = make_layout(layout, h, w, n)
        assert gh % n == 0
        rng = np.random.default_rng(1)
        img = jnp.asarray(rng.random((h, w, 4)), jnp.float32)
        packed = pack(img)
        assert packed.shape == (gh, gw, 4)
        np.testing.assert_array_equal(np.asarray(unpack(packed)),
                                      np.asarray(img))
        np.testing.assert_array_equal(
            np.asarray(pack(jnp.ones((h, w), jnp.float32))),
            np.asarray(valid))
        assert float(valid.sum()) == h * w


def test_cyclic_row_layout_properties():
    """Block-cyclic layout: a true permutation, 16-row blocks intact,
    device d owns blocks d, d+n, d+2n, ... (the load-balance contract
    used by the scaling artifact)."""
    from volumetric_renderer.parallel.mesh import cyclic_row_layout

    for h, n in [(1080, 8), (24, 8), (128, 4), (48, 3)]:
        hp, perm, inv = cyclic_row_layout(h, n)
        assert hp % (16 * n) == 0 and hp >= h
        assert sorted(perm) == list(range(hp))
        np.testing.assert_array_equal(perm[inv], np.arange(hp))
        rows_per = hp // n
        for d in range(n):
            shard_rows = perm[d * rows_per:(d + 1) * rows_per]
            blocks = shard_rows.reshape(-1, 16)
            # whole blocks, in-block order preserved
            np.testing.assert_array_equal(
                blocks % 16, np.tile(np.arange(16), (len(blocks), 1)))
            # round-robin: block indices d, d+n, d+2n, ...
            np.testing.assert_array_equal(
                blocks[:, 0] // 16, np.arange(d, hp // 16, n))


@pytest.mark.slow
def test_train_step_slab_method_decreases_loss():
    """Config 3/4 through the GPU production kernel (interpreted): sharded
    kernel forward + kernel backward + tile-cyclic layout, two views
    looking along different volume axes."""
    mesh = make_mesh(jax.devices()[:8])
    settings = RenderSettings(height=16, width=16, step_size=0.1,
                              early_termination=False, tf_resolution=32)
    vol_gt, tf, _, fixed_win = scene(n=8)

    cams = [OrbitCamera.from_angles(yaw_deg=a, pitch_deg=15.0)
            for a in (0.0, 90.0)]
    cameras = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)

    render_fn = make_sharded_renderer(mesh, settings)
    fixed = dict(vol=vol_gt, tf=tf, **fixed_win)
    targets = jnp.stack([
        render_fn(vol_gt, tf, c, fixed["dmin"], fixed["dmax"],
                  fixed["smin"], fixed["smax"]) for c in cams])

    optimizer = optax.adam(5e-2)
    step_fn = make_train_step(mesh, settings, optimizer,
                              optimize_vol=True, optimize_tf=False,
                              row_layout="tile-cyclic", **KERNEL)
    state = init_state(optimizer, dict(vol=jnp.full_like(vol_gt, 0.3)))
    losses = []
    for _ in range(6):
        state, loss = step_fn(state, fixed, cameras, targets)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses


def test_local_batch_bounds_partition(monkeypatch):
    """Host row ranges must tile [0, total) without gaps or overlap."""
    from volumetric_renderer.parallel import distributed

    for n_hosts, total in [(1, 10), (3, 10), (4, 16), (5, 7)]:
        ranges = []
        for i in range(n_hosts):
            monkeypatch.setattr(jax, "process_count", lambda: n_hosts)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            ranges.append(distributed.local_batch_bounds(total))
        covered = sorted(r for lo, hi in ranges for r in range(lo, hi))
        assert covered == list(range(total)), (n_hosts, total, ranges)


def test_pod_mesh_shape(monkeypatch):
    """pod_mesh reshapes global devices to (hosts, chips-per-host)."""
    from volumetric_renderer.parallel import distributed
    from volumetric_renderer.parallel.mesh import HOST_AXIS, TILE_AXIS

    for n_hosts in (1, 2, 4):
        monkeypatch.setattr(jax, "process_count", lambda: n_hosts)
        mesh = distributed.pod_mesh()
        assert mesh.axis_names == (HOST_AXIS, TILE_AXIS)
        assert mesh.shape[HOST_AXIS] == n_hosts
        assert mesh.shape[HOST_AXIS] * mesh.shape[TILE_AXIS] == len(
            jax.devices())


def test_init_distributed_single_process_noop():
    from volumetric_renderer.parallel.distributed import init_distributed

    init_distributed()  # no cluster env: must not raise
    assert jax.process_count() >= 1


def test_two_process_cluster_psum():
    """REAL multi-process JAX: spawn a 2-process gloo cluster (2 virtual
    CPU devices each), build pod_mesh over the 4 global devices, and psum
    across the process boundary — the collective multi-host grid/TF
    gradient reduction rides.  Subprocess-based: jax.distributed can only
    initialize once per process."""
    import json
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "distributed_worker.py")
    env = dict(os.environ, PYTHONPATH=root)
    # workers set their own platform/device-count env before importing jax
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, worker, coord, "2", str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env, text=True)
        for i in range(2)
    ]
    results = {}
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"worker {i} failed:\n{err[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results[i] = json.loads(line)
    # both processes saw the full cross-process reduction: 1+2+3+4
    assert results[0]["psum"] == results[1]["psum"] == 10.0
    # and the host row partition tiles the image
    assert results[0]["rows"] == [0, 32] and results[1]["rows"] == [32, 64]


@pytest.mark.slow
def test_train_step_decreases_loss():
    """Toy grid inversion (BASELINE config 4 shape): loss drops."""
    mesh = make_mesh(jax.devices()[:8])
    settings = RenderSettings(height=16, width=16, step_size=0.1,
                              early_termination=False)
    vol_gt, tf, _, fixed_win = scene(n=8)
    fixed = dict(vol=vol_gt, tf=tf, **fixed_win)

    cams = [OrbitCamera.from_angles(yaw_deg=a, pitch_deg=15.0)
            for a in (0.0, 90.0)]
    cameras = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    render_fn = make_sharded_renderer(mesh, settings)
    targets = jnp.stack([
        render_fn(vol_gt, tf, c, fixed["dmin"], fixed["dmax"],
                  fixed["smin"], fixed["smax"]) for c in cams])

    optimizer = optax.adam(5e-2)
    step_fn = make_train_step(mesh, settings, optimizer,
                              optimize_vol=True, optimize_tf=False)
    # zeros would start in the TF clamp zone (t=0 maps below texel 0's
    # center: lo == hi, zero slope — the sampler's CLAMP_TO_EDGE semantics),
    # where grid gradients are identically zero; start mid-window instead.
    state = init_state(optimizer, dict(vol=jnp.full_like(vol_gt, 0.3)))
    losses = []
    for _ in range(10):
        state, loss = step_fn(state, fixed, cameras, targets)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0], losses
    assert int(state.step) == 10
