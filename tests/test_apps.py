"""Smoke tests for the apps layer + checkpoint/metrics utilities."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest

from volumetric_renderer.utils.checkpoint import (
    latest_checkpoint, load_checkpoint, save_checkpoint,
)
from volumetric_renderer.utils.metrics import PhaseTimers, ThroughputMeter


def test_checkpoint_roundtrip(tmp_path):
    state = {"vol": jnp.arange(12.0).reshape(3, 4),
             "opt": (jnp.zeros(3), jnp.int32(7))}
    p = save_checkpoint(str(tmp_path / "ckpt_10.npz"), state, step=10)
    loaded, step = load_checkpoint(p, state)
    assert step == 10
    np.testing.assert_array_equal(np.asarray(loaded["vol"]),
                                  np.asarray(state["vol"]))
    np.testing.assert_array_equal(np.asarray(loaded["opt"][0]),
                                  np.asarray(state["opt"][0]))


def test_checkpoint_structure_mismatch(tmp_path):
    p = save_checkpoint(str(tmp_path / "c.npz"), {"a": jnp.zeros(2)})
    with pytest.raises(ValueError):
        load_checkpoint(p, {"a": jnp.zeros(2), "b": jnp.zeros(2)})


def test_latest_checkpoint(tmp_path):
    for s in (5, 20, 10):
        save_checkpoint(str(tmp_path / f"ckpt_{s}.npz"), {"x": jnp.zeros(1)})
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_20.npz")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_throughput_meter():
    m = ThroughputMeter(window=3)
    assert m.rate is None
    m.tick(0)
    for _ in range(4):
        m.tick(100)
    assert m.rate > 0


def test_phase_timers():
    t = PhaseTimers()
    with t.phase("render"):
        pass
    with t.phase("render"):
        pass
    rep = t.report()
    assert rep["render"]["count"] == 2


def test_render_cli_synthetic(tmp_path):
    from volumetric_renderer.apps.render_cli import main
    out = str(tmp_path / "r.png")
    npy = str(tmp_path / "r.npy")
    main(["x", "--synthetic", "--size", "48x32", "--steps", "24",
          "--out", out, "--npy", npy, "--yaw", "30", "--pitch", "20",
          "--slice-x", "0.1:0.9", "--tf", "preset:ramp"])
    assert os.path.exists(out)
    img = np.load(npy)
    assert img.shape == (32, 48, 4)
    assert img[..., 3].max() > 0.05


def test_render_cli_tf_json(tmp_path):
    from volumetric_renderer.apps.render_cli import main
    tf_file = tmp_path / "tf.json"
    tf_file.write_text(json.dumps({
        "color_markers": [[0.0, 0.0, 0.0, 1.0], [1.0, 1.0, 0.5, 0.0]],
        "alpha_markers": [[0.0, 0.0], [1.0, 0.9]],
    }))
    out = str(tmp_path / "r.png")
    main(["x", "--synthetic", "--size", "32x32", "--steps", "16",
          "--tf", str(tf_file), "--out", out])
    assert os.path.exists(out)


def test_turntable_gif(tmp_path):
    from volumetric_renderer.apps.turntable import main
    out = str(tmp_path / "o.gif")
    main(["--synthetic", "--frames", "3", "--size", "32x32",
          "--steps", "16", "--out", out])
    assert os.path.exists(out)


@pytest.mark.slow
def test_optimize_invert_smoke(tmp_path):
    from volumetric_renderer.apps.optimize import main
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "vol.npy")
    main(["invert", "--grid", "8", "--size", "24x24", "--march-steps", "12",
          "--views", "2", "--steps-opt", "6", "--ckpt-dir", ck,
          "--ckpt-every", "5", "--out", out])
    assert os.path.exists(out)
    assert latest_checkpoint(ck) is not None
    # resume continues from the checkpoint without error
    main(["invert", "--grid", "8", "--size", "24x24", "--march-steps", "12",
          "--views", "2", "--steps-opt", "8", "--ckpt-dir", ck,
          "--resume", "--out", out])


@pytest.mark.slow
def test_optimize_tf_fit_smoke(tmp_path):
    from volumetric_renderer.apps.optimize import main
    out = str(tmp_path / "tf.npy")
    main(["tf-fit", "--grid", "8", "--size", "24x24", "--march-steps", "12",
          "--views", "2", "--steps-opt", "4", "--tf-resolution", "32",
          "--out", out])
    assert np.load(out).shape == (32, 4)


def test_benchmark_harness(capsys):
    from volumetric_renderer.apps.benchmark import main
    main(["--size", "32x32", "--steps", "12", "--grid", "8", "--iters", "1"])
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert data["scaling"][0]["devices"] == 1
    assert data["scaling"][-1]["efficiency"] > 0


@pytest.mark.slow
@pytest.mark.gpu
def test_optimize_slab_method_smoke(tmp_path):
    """Config-4 loop through the GPU production kernel, compiled."""
    from volumetric_renderer.apps.optimize import main
    out = str(tmp_path / "vol.npy")
    main(["invert", "--grid", "8", "--size", "24x24", "--march-steps", "12",
          "--views", "2", "--steps-opt", "3", "--tf-resolution", "32",
          "--method", "march", "--out", out])
    assert os.path.exists(out)


def test_ablation_harness(capsys, monkeypatch):
    """Early-termination ablation produces speedup ratios (tiny shapes)."""
    from volumetric_renderer.apps import ablation
    from volumetric_renderer import models

    # shrink the config-2 workload for CI: small phantom, image, steps
    orig = models.head_phantom
    monkeypatch.setattr(models, "head_phantom", lambda n=128: orig(16))
    ablation.main(["--iters", "1", "--skip-flagship", "--size", "24x24",
                   "--steps", "12", "--methods", "fused"])
    data = json.loads(capsys.readouterr().out.strip())
    w = data["workloads"]["config2_head_phantom"]
    assert "et_speedup_fused" in w and w["fused_eton"]["rays_per_s"] > 0


def test_viewer_state_machine():
    """Headless viewer logic: drag orbits (sensitivity 0.25 inside
    OrbitCamera), scroll zooms with the reference radius clamp, reset
    restores; every event triggers exactly one re-render."""
    from volumetric_renderer.apps.viewer import ViewerState
    from volumetric_renderer.scene.camera import OrbitCamera

    calls = []

    def render_frame(cam):
        calls.append(np.asarray(cam.orientation))
        return np.zeros((8, 8, 3), np.float32)

    cam0 = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    st = ViewerState(render_frame, cam0)
    st.frame()
    assert st.last_rays_per_s > 0

    assert not st.drag(10, 10)          # no press yet
    st.press(0, 0)
    assert st.drag(40, 0)               # 40px drag = 10 deg yaw
    want = cam0.rotate((40.0, 0.0))
    np.testing.assert_allclose(np.asarray(st.camera.orientation),
                               np.asarray(want.orientation), atol=1e-6)
    st.release()
    assert not st.drag(50, 0)

    r0 = float(st.camera.radius)
    st.scroll(1)                        # wheel up zooms in
    assert float(st.camera.radius) < r0
    for _ in range(100):
        st.scroll(1)
    np.testing.assert_allclose(float(st.camera.radius), 0.1,
                               rtol=1e-6)      # camera.cpp:31-34 clamp

    st.reset()
    np.testing.assert_allclose(np.asarray(st.camera.orientation),
                               np.asarray(cam0.orientation))


def test_viewer_cursor_wrap_around():
    """Edge wrap-around during a drag (main_window.cpp:267-315): the
    cursor warps to the opposite edge, the motion event after the warp
    is ignored (its delta would be the warp jump), and subsequent drags
    keep rotating from the warped position."""
    from volumetric_renderer.apps.viewer import ViewerState
    from volumetric_renderer.scene.camera import OrbitCamera

    warps = []
    cam0 = OrbitCamera.from_angles(yaw_deg=0.0, pitch_deg=0.0)
    st = ViewerState(lambda c: np.zeros((4, 4, 3), np.float32), cam0,
                     wrap_bounds=((0.0, 0.0), (100.0, 100.0)),
                     warp_cursor=lambda x, y: warps.append((x, y)))

    st.press(90, 50)
    assert st.drag(105, 50)             # crosses max_x -> warp to min_x
    assert warps == [(0.0, 50)]
    want = cam0.rotate((15.0, 0.0))     # rotation BEFORE the warp applies
    np.testing.assert_allclose(np.asarray(st.camera.orientation),
                               np.asarray(want.orientation), atol=1e-6)

    # the synthetic "cursor jumped to the warped position" motion event
    # must not rotate (did_warp / ResetMouseDragDelta semantics)
    assert not st.drag(0, 50)
    # and dragging onward from the warped edge rotates normally
    assert st.drag(20, 50)
    want = want.rotate((20.0, 0.0))
    np.testing.assert_allclose(np.asarray(st.camera.orientation),
                               np.asarray(want.orientation), atol=1e-6)

    # y wrap at the min edge warps to max
    st.press(50, 5)
    assert st.drag(50, -10)
    assert warps[-1] == (50, 100.0)
