#!/usr/bin/env python
"""Smoke run of the main path on one GPU: import, render, train.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only, on four cards

Phases (each failure ends the run with a non-zero exit, printing no
result line):

1. Card: ``nvidia-smi`` name and power limit, read before JAX starts;
   JAX must then find a GPU.
2. Card-only tests: ``pytest -m gpu`` in a subprocess, while this
   process is still off the card (one JAX process per card).
3. Ingest: a seeded 256^3 CT-head phantom written as a uint16 gzip NRRD
   and read back through ``import_volume`` and the native decode.
4. Render: ``render(method="auto")`` at 1920x1080, 512 steps, early
   termination on, timed; every marcher compared with the oracle; the
   render CLI run once as a user would.
5. Train: ``make_train_step`` on a one-card mesh (grid and TF, 2 views
   at 1920x1080, 3 Adam steps); the kernel gradients of one 256x256 view
   checked against ``jax.grad`` through the oracle.
6. ``--four-cards``: a tile-cyclic pixel-sharded forward and one train
   step on four cards, each compared with the same on one card.

The last line is ``{"ok": true, "device": {...}}`` as JAX reports the
device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, STEPS, GRID = 1080, 1920, 512, 256


def phase(name):
    print(f"== {name}", flush=True)


def card_phase():
    phase("1. card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = out.strip().splitlines()[0]
    print(f"card (name, power limit): {card}", flush=True)
    return card


def gpu_tests_phase():
    phase("2. card-only tests (pytest -m gpu)")
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(ROOT, "tests"),
         "-m", "gpu", "-q", "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    print("\n".join(proc.stdout.strip().splitlines()[-15:]))
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"gpu tests failed (rc {proc.returncode})")
    print(f"gpu tests passed in {time.perf_counter() - t0:.1f} s",
          flush=True)


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r}")
    print(f"JAX device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    return dev


def ingest_phase(tmp):
    phase("3. ingest")
    import numpy as np

    from volumetric_renderer import models
    from volumetric_renderer.data._native import have_native
    from volumetric_renderer.data.importer import import_volume
    from volumetric_renderer.data.nrrd import write_nrrd

    raw = np.round(models.head_phantom(GRID, seed=0).data * 65535.0)
    path = os.path.join(tmp, "head.nrrd")
    write_nrrd(path, raw.astype(np.uint16), encoding="gzip")
    t0 = time.perf_counter()
    vol = import_volume(path)
    dt = time.perf_counter() - t0
    if not have_native():
        raise SystemExit("native decode library did not build or load")
    if vol.data.shape != raw.shape or not np.array_equal(vol.data, raw):
        raise SystemExit(f"NRRD round trip changed the data "
                         f"(shape {vol.data.shape})")
    print(f"imported {path}: {vol.data.shape} uint16 -> f32 in {dt:.2f} s "
          f"(native decode), range [{vol.vmin}, {vol.vmax}]", flush=True)
    return path, vol


def bone_tf(n=256):
    import jax.numpy as jnp

    from volumetric_renderer.transfer.gradient import Gradient

    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(n))
    # alpha reaches 1 by skull density: opaque surfaces, early termination
    return tf.at[:, 3].set(jnp.clip(jnp.linspace(0.0, 1.0, n) / 0.85,
                                    0.0, 1.0))


def render_phase(vol, path, card):
    phase("4. render")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from volumetric_renderer.core.marcher import march_rays
    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.render.api import (
        METHODS, make_marcher, production_method, render,
    )
    from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
    from volumetric_renderer.utils.config import RenderSettings

    v = vol.as_jax()
    tf = bone_tf()
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    settings = RenderSettings(height=H, width=W, step_size=1.8 / STEPS,
                              early_termination=True)
    win = dict(density_min=vol.vmin, density_max=vol.vmax)
    chosen = production_method()
    fn = jax.jit(lambda v, t: render(v, t, cam, settings, method="auto",
                                     **win))
    t0 = time.perf_counter()
    img = jax.block_until_ready(fn(v, tf))
    first = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(v, tf))
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    if img.shape != (H, W, 4) or not bool(jnp.isfinite(img).all()):
        raise SystemExit(f"render: shape {img.shape} or non-finite values")
    cover = float((img[..., 3] > 0.5).mean())
    print(f"method auto -> {chosen}: {ms:.3f} ms/frame median of 3 warm "
          f"runs ({[round(t * 1e3, 3) for t in times]}), first call "
          f"{first:.1f} s, {H * W / (ms / 1e3):,.0f} rays/s, on {card}; "
          f"{cover:.3f} of pixels opaque", flush=True)
    print(f"memory_analysis: {fn.lower(v, tf).compile().memory_analysis()}",
          flush=True)

    # Every marcher against the oracle run in float64 on the same f32
    # inputs, with early termination off (a fixed trip count) and on.
    # Over 512 compositing steps f32 rounding alone moves the float32
    # oracle ~1e-5 (smooth sphere) to ~1e-4 (the phantom's one-voxel skull
    # step) from the float64 one, so each marcher must come within 1e-5
    # of the float32 oracle's own error.  With ET on, a ray whose
    # transmittance lands within rounding of the threshold may stop one
    # step apart: the bound is the threshold.
    origin, dirs = ray_grid(cam, H, W)
    origin = origin + 0.5
    sphere = Volume.synthetic_sphere(GRID).as_jax()
    cases = (("sphere", sphere, (0.0, 1.0)),
             ("phantom", v, (vol.vmin, vol.vmax)))
    failed = []
    for name, vv, (lo, hi) in cases:
        for et in (False, True):
            s = settings.replace(early_termination=et)
            march_kw = dict(num_steps=STEPS, step_size=s.step_size,
                            early_termination=et,
                            termination_eps=s.termination_eps)
            with jax.enable_x64(True):
                f64 = jnp.float64
                ref = np.asarray(jax.jit(lambda a, b, c, d: march_rays(
                    a, b, c, d, density_min=f64(lo), density_max=f64(hi),
                    slice_min=jnp.zeros(3, f64), slice_max=jnp.ones(3, f64),
                    **march_kw))(*(jnp.asarray(x, f64)
                                   for x in (vv, tf, origin, dirs))))
            w = (jnp.float32(lo), jnp.float32(hi), jnp.zeros(3), jnp.ones(3))
            marchers = {"oracle": lambda a, b, c, d, *w: march_rays(
                a, b, c, d, density_min=w[0], density_max=w[1],
                slice_min=w[2], slice_max=w[3], **march_kw)}
            marchers.update((m, make_marcher(m, s)) for m in METHODS[1:])
            err_oracle = None
            for m, f in marchers.items():
                got = np.asarray(jax.jit(f)(vv, tf, origin, dirs, *w))
                err = float(np.abs(got.astype(np.float64) - ref).max())
                if err_oracle is None:
                    err_oracle = err
                bound = s.termination_eps if et else err_oracle + 1e-5
                print(f"  {name:7s} {m:8s} ET {'on ' if et else 'off'}: max "
                      f"abs err vs float64 oracle {err:.3e}, bound "
                      f"{bound:.3e}", flush=True)
                if not err <= bound:
                    failed.append(f"{name} {m} ET {et}: {err:.3e}")
            del ref
    if failed:
        raise SystemExit(f"marchers disagree with the oracle: {failed}")

    # the CLI's own entry point, in this process (one JAX process per card)
    phase("4b. render CLI: python -m volumetric_renderer.apps.render_cli "
          f"{os.path.basename(path)} --size {W}x{H} --out x.png")
    from volumetric_renderer.apps.render_cli import main as render_cli
    from volumetric_renderer.data.formats import read_png_image

    out_png = os.path.join(os.path.dirname(path), "x.png")
    render_cli([path, "--size", f"{W}x{H}", "--out", out_png])
    png = read_png_image(out_png)
    if png.shape != (H, W) or not 0.0 < float(png.max()) <= 1.0:
        raise SystemExit(f"render CLI wrote a bad PNG: {png.shape}")
    print(f"render_cli wrote {os.path.getsize(out_png)} bytes, "
          f"{png.shape[1]}x{png.shape[0]}", flush=True)


def train_setup(settings, vol, mesh):
    """Train step, state, fixed inputs, cameras and targets for grid + TF
    fitting on 2 posed views rendered from ``vol`` itself."""
    import jax
    import jax.numpy as jnp
    import optax

    from volumetric_renderer.parallel.render import make_sharded_renderer
    from volumetric_renderer.parallel.train import (
        init_state, make_train_step,
    )
    from volumetric_renderer.scene.camera import OrbitCamera

    tf = bone_tf()
    win = dict(dmin=jnp.float32(0.0), dmax=jnp.float32(1.0),
               smin=jnp.zeros(3), smax=jnp.ones(3))
    cams = [OrbitCamera.from_angles(yaw_deg=a, pitch_deg=20.0)
            for a in (0.0, 130.0)]
    render_fn = make_sharded_renderer(mesh, settings)
    targets = jnp.stack([render_fn(vol, tf, c, *win.values()) for c in cams])
    optimizer = optax.adam(1e-2)
    step_fn = make_train_step(mesh, settings, optimizer, optimize_vol=True,
                              optimize_tf=True, row_layout="tile-cyclic")
    # start from a blurred grid and a flattened TF: nonzero gradients
    params = dict(vol=jnp.clip(vol * 0.8 + 0.1, 0.0, 1.0),
                  tf=tf.at[:, 3].multiply(0.7))
    return (step_fn, init_state(optimizer, params), dict(win, vol=vol, tf=tf),
            jax.tree.map(lambda *xs: jnp.stack(xs), *cams), targets)


def train_phase(vol):
    phase("5. train")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from volumetric_renderer.core.marcher import march_rays
    from volumetric_renderer.parallel.mesh import make_mesh
    from volumetric_renderer.render.api import (
        make_marcher, production_method,
    )
    from volumetric_renderer.scene.camera import OrbitCamera, ray_grid
    from volumetric_renderer.utils.config import RenderSettings

    # densities normalised to [0, 1], the window the training step uses
    v = (vol.as_jax() - vol.vmin) / (vol.vmax - vol.vmin)
    settings = RenderSettings(height=H, width=W, step_size=1.8 / STEPS,
                              early_termination=False)
    mesh = make_mesh(jax.devices()[:1])
    step_fn, state, fixed, cameras, targets = train_setup(settings, v, mesh)
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        state, loss = step_fn(state, fixed, cameras, targets)
        loss = float(loss)
        losses.append(loss)
        print(f"  step {i}: loss {loss:.6e} ({time.perf_counter() - t0:.2f}"
              f" s)", flush=True)
    finite = all(bool(jnp.isfinite(x).all())
                 for x in jax.tree.leaves(state.params))
    if not (np.all(np.isfinite(losses)) and finite):
        raise SystemExit(f"training diverged: losses {losses}")

    # kernel gradients of one 256x256 view vs jax.grad through the oracle
    gs = settings.replace(height=256, width=256)
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    origin, dirs = ray_grid(cam, 256, 256)
    origin = origin + 0.5
    tf = bone_tf().at[:, 3].multiply(0.7)
    vg = jnp.clip(v * 0.8 + 0.1, 0.0, 1.0)
    w = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))
    target = jax.random.uniform(jax.random.PRNGKey(0), (256, 256, 4))

    def loss_o(vv, tt):
        img = march_rays(vv, tt, origin, dirs, density_min=w[0],
                         density_max=w[1], slice_min=w[2], slice_max=w[3],
                         num_steps=STEPS, step_size=gs.step_size)
        return jnp.mean((img - target) ** 2)

    # Gated on a TF with alpha <= 0.7: the prefix-sum backward (kernel and
    # fused alike) divides by 1 - a, which amplifies rounding without bound
    # as a -> 1; the opaque TF's numbers are printed to show that.
    def grad_errors(t):
        go = jax.jit(jax.grad(loss_o, argnums=(0, 1)))(vg, t)
        out = {}
        for m in dict.fromkeys((production_method(), "fused")):
            mk = make_marcher(m, gs)
            gm = jax.jit(jax.grad(
                lambda vv, tt: jnp.mean((mk(vv, tt, origin, dirs, *w)
                                         - target) ** 2),
                argnums=(0, 1)))(vg, t)
            out[m] = [float(jnp.abs(a - b).max() / jnp.abs(b).max())
                      for a, b in zip(gm, go)]
        return out

    for m, (rel_grid, rel_tf) in grad_errors(bone_tf()).items():
        print(f"  opaque TF (alpha up to 1), {m}: grid/TF gradient max rel "
              f"err vs oracle autodiff {rel_grid:.3e} / {rel_tf:.3e} (not "
              f"gated)", flush=True)
    errs = grad_errors(tf)
    for m, (rel_grid, rel_tf) in errs.items():
        print(f"  TF alpha <= 0.7, {m}: grid/TF gradient max rel err vs "
              f"oracle autodiff {rel_grid:.3e} / {rel_tf:.3e}, bound 1e-4",
              flush=True)
    if not max(errs[production_method()]) < 1e-4:
        raise SystemExit(f"gradients disagree: {errs}")


def four_card_phase():
    phase("6. four cards: sharded forward and train step vs one card")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from volumetric_renderer import models
    from volumetric_renderer.parallel.mesh import make_mesh
    from volumetric_renderer.parallel.render import make_sharded_renderer
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.utils.config import RenderSettings

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX found {len(devs)}")
    v = models.head_phantom(GRID, seed=0).as_jax()
    tf = bone_tf()
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    win = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))
    meshes = {n: make_mesh(devs[:n]) for n in (1, 4)}

    settings = RenderSettings(height=H, width=W, step_size=1.8 / STEPS,
                              early_termination=True)
    imgs, times = {}, {}
    for n, mesh in meshes.items():
        fn = make_sharded_renderer(mesh, settings, row_layout="tile-cyclic")
        imgs[n] = np.asarray(fn(v, tf, cam, *win))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(v, tf, cam, *win))
            ts.append(time.perf_counter() - t0)
        times[n] = sorted(ts)[1] * 1e3
        print(f"  forward on {n} card(s): {times[n]:.3f} ms median of 3",
              flush=True)
    err = float(np.abs(imgs[4] - imgs[1]).max())
    print(f"  forward 4 cards vs 1: max abs err {err:.3e} (bound 1e-5); "
          f"speed-up {times[1] / times[4]:.3f}", flush=True)
    if not err <= 1e-5:
        raise SystemExit(f"sharded forward disagrees: {err}")

    tsettings = settings.replace(early_termination=False)
    out = {}
    for n, mesh in meshes.items():
        step_fn, state, fixed, cameras, targets = train_setup(
            tsettings, v, mesh)
        state, loss = step_fn(state, fixed, cameras, targets)
        out[n] = (float(loss), jax.device_get(state.params))
    rel_loss = abs(out[4][0] - out[1][0]) / abs(out[1][0])
    print(f"  train step 4 cards vs 1: loss {out[4][0]:.6e} vs "
          f"{out[1][0]:.6e} (rel {rel_loss:.3e})", flush=True)
    worst = rel_loss
    for k in ("vol", "tf"):
        a, b = out[4][1][k], out[1][1][k]
        rel = float(abs(a - b).max() / abs(b).max())
        print(f"  updated {k}: max rel err {rel:.3e}", flush=True)
        worst = max(worst, rel)
    if not worst <= 1e-4:
        raise SystemExit(f"sharded train step disagrees: {worst}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()

    card = card_phase()
    if not args.four_cards:
        gpu_tests_phase()

    sys.path.insert(0, ROOT)
    from volumetric_renderer.utils.env import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = require_gpu()
    if args.four_cards:
        four_card_phase()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path, vol = ingest_phase(tmp)
            render_phase(vol, path, card)
            train_phase(vol)
    print(f"card (name, power limit): {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
