"""Differentiable-rendering optimization apps: TF-fit and grid inversion.

BASELINE configs 3-4 — capabilities with no reference counterpart (the
reference's TF editing is a human dragging markers,
``src/ui/components/gradient.cpp:134-469``):

* ``tf-fit``: recover the 1D transfer-function table from target images
  rendered with an unknown TF.
* ``invert``: recover the full density grid from N posed renders by
  pixel-loss gradient descent.

Both run sharded over every addressable device (pixels over the mesh,
grid/TF gradients psum'd inside the custom-VJP backward) and
checkpoint/resume via ``utils.checkpoint``.

    python -m volumetric_renderer.apps.optimize invert \
        --grid 64 --views 32 --steps-opt 200 --size 256x256 \
        --ckpt-dir /tmp/inv --resume
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["tf-fit", "invert"])
    ap.add_argument("--dataset", default=None,
                    help="NRRD ground-truth volume (default: synthetic)")
    ap.add_argument("--grid", type=int, default=64,
                    help="synthetic grid resolution")
    ap.add_argument("--size", default="256x256", help="render WxH")
    ap.add_argument("--march-steps", type=int, default=128)
    ap.add_argument("--views", type=int, default=32,
                    help="posed target views (config 4: 32)")
    ap.add_argument("--steps-opt", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--tf-resolution", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="save result (.npy)")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "march", "fused", "blocked"],
                    help="auto = the backend's production marcher (the "
                         "ray-march kernel on a GPU, fused XLA on the CPU)")
    from volumetric_renderer.parallel.mesh import LAYOUTS

    ap.add_argument("--row-layout", default="tile-cyclic",
                    choices=list(LAYOUTS),
                    help="pixel distribution over the mesh (tile-cyclic = "
                         "16x16 tiles round-robin, the finest balance)")
    args = ap.parse_args(argv)

    from volumetric_renderer.utils.env import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import optax

    from volumetric_renderer.data.importer import import_volume
    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.parallel.mesh import make_mesh
    from volumetric_renderer.parallel.render import make_sharded_renderer
    from volumetric_renderer.parallel.train import (
        init_state, make_train_step,
    )
    from volumetric_renderer.render.api import production_method
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.transfer.gradient import Gradient
    from volumetric_renderer.utils.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    from volumetric_renderer.utils.config import RenderSettings
    from volumetric_renderer.utils.metrics import PhaseTimers

    w, h = (int(v) for v in args.size.split("x"))
    settings = RenderSettings(height=h, width=w,
                              step_size=1.8 / args.march_steps,
                              early_termination=False,
                              tf_resolution=args.tf_resolution)
    mesh = make_mesh()
    print(f"mesh: {mesh.shape} over {mesh.size} device(s)", file=sys.stderr)

    if args.dataset:
        vol_gt = import_volume(args.dataset).as_jax()
    else:
        vol_gt = Volume.synthetic_sphere(args.grid).as_jax()

    tf_gt = jnp.asarray(Gradient.grayscale_ramp().discretize(
        args.tf_resolution))
    tf_gt = tf_gt.at[:, 3].set(
        jnp.linspace(0.0, 0.8, args.tf_resolution))

    # posed target views on an orbit ring (config 4 geometry)
    yaws = np.linspace(0.0, 360.0, args.views, endpoint=False)
    cams = [OrbitCamera.from_angles(yaw_deg=float(a), pitch_deg=20.0)
            for a in yaws]
    cameras = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)

    method = production_method() if args.method == "auto" else args.method
    print(f"method: {method} ({args.row_layout} row layout)",
          file=sys.stderr)

    fixed = dict(vol=vol_gt, tf=tf_gt,
                 dmin=jnp.float32(jnp.min(vol_gt)),
                 dmax=jnp.float32(jnp.max(vol_gt)),
                 smin=jnp.zeros(3), smax=jnp.ones(3))

    timers = PhaseTimers()
    render_fn = make_sharded_renderer(mesh, settings, method)
    with timers.phase("render_targets"):
        targets = jnp.stack([
            render_fn(vol_gt, tf_gt, c, fixed["dmin"], fixed["dmax"],
                      fixed["smin"], fixed["smax"]) for c in cams])
        jax.block_until_ready(targets)

    optimize_vol = args.mode == "invert"
    optimize_tf = args.mode == "tf-fit"
    optimizer = optax.adam(args.lr)
    step_fn = make_train_step(mesh, settings, optimizer,
                              optimize_vol=optimize_vol,
                              optimize_tf=optimize_tf, method=method,
                              row_layout=args.row_layout)

    params = {}
    if optimize_vol:
        # mid-window init (zeros sit in the TF sampler's zero-gradient
        # clamp zone — see tests/test_parallel.py)
        params["vol"] = jnp.full_like(vol_gt, 0.3)
    if optimize_tf:
        key = jax.random.PRNGKey(args.seed)
        params["tf"] = jax.random.uniform(
            key, (args.tf_resolution, 4), jnp.float32, 0.2, 0.8)
    state = init_state(optimizer, params)

    start = 0
    if args.resume and args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            state, start = load_checkpoint(ck, state)
            print(f"resumed from {ck} at step {start}", file=sys.stderr)

    rays_per_step = args.views * h * w
    for i in range(start, args.steps_opt):
        with timers.phase("train_step"):
            state, loss = step_fn(state, fixed, cameras, targets)
            loss = float(loss)
        if i % 10 == 0 or i == args.steps_opt - 1:
            print(f"step {i:5d}  loss {loss:.6e}  "
                  f"({rays_per_step/timers.totals['train_step']*max(1,i-start+1):,.0f} rays/s)",
                  file=sys.stderr)
        if not np.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {i}: fail-fast "
                             "(restart with --resume)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(f"{args.ckpt_dir}/ckpt_{i+1}.npz", state, i + 1)

    timers.log_report()
    if optimize_vol:
        err = float(jnp.max(jnp.abs(state.params["vol"] - vol_gt)))
        print(f"grid max abs err vs ground truth: {err:.4f}",
              file=sys.stderr)
        result = state.params["vol"]
    else:
        err = float(jnp.max(jnp.abs(state.params["tf"] - tf_gt)))
        print(f"tf max abs err vs ground truth: {err:.4f}", file=sys.stderr)
        result = state.params["tf"]
    if args.out:
        np.save(args.out, np.asarray(result))
        print(args.out)


if __name__ == "__main__":
    main()
