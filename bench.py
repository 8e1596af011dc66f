#!/usr/bin/env python
"""Benchmark of the renderer on one GPU: ms per frame, in turns.

Workload (BASELINE.md config 3): 256^3 synthetic sphere, 1920x1080 image,
512 steps per ray, 256-texel RGBA transfer function (alpha ramp^2),
early ray termination on.  ``--grad`` adds forward + backward
(``value_and_grad`` w.r.t. the grid and the TF table), the inner loop of
configs 3 and 4.

Every method in ``--methods`` (default: the production method, then the
fused XLA marcher) is compiled first, then timed in turns — round-robin
over ``--iters`` rounds in one process — so all see the same card state.
Each forward is checked against the oracle marcher with early termination
off (max abs RGBA error), each gradient against the fused method's.

Prints the device (platform, kind, count, the card's name and power
limit) on ``#`` lines, then ONE JSON line whose ``value`` is the first
method's median ms per frame.  Exits non-zero without a GPU: a CPU time
is not a number for the card.

Usage: python bench.py [--methods auto fused blocked] [--grad]
       [--grid N] [--iters N] [--ray-chunks K]
"""

import argparse
import json
import sys
import time

import numpy as np


def scene(grid_n, tf_n=256):
    import jax.numpy as jnp

    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.transfer.gradient import Gradient

    vol = Volume.synthetic_sphere(grid_n).as_jax()
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(tf_n))
    # realistic opacity ramp: opaque centers terminate rays early
    tf = tf.at[:, 3].set(jnp.linspace(0.0, 1.0, tf_n) ** 2)
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    return vol, tf, cam


def build(method, settings, cam, chunks):
    """``fwd(vol, tf)`` and ``grad(vol, tf) -> (loss, gvol, gtf)`` through
    ``method``'s marcher; the image splits into ``chunks`` row bands
    whose losses and gradients are summed (ray minibatching)."""
    import jax
    import jax.numpy as jnp

    from volumetric_renderer.render.api import make_marcher
    from volumetric_renderer.scene.camera import ray_grid

    h, w = settings.height, settings.width
    marcher = make_marcher(method, settings)
    origin, dirs = ray_grid(cam, h, w)
    origin = origin + 0.5
    scal = (jnp.float32(0.0), jnp.float32(1.0), jnp.zeros(3), jnp.ones(3))
    hc = h // chunks
    bands = [dirs[i * hc:(i + 1) * hc] for i in range(chunks)]

    fwd1 = jax.jit(lambda v, t, d: marcher(v, t, origin, d, *scal))
    grad1 = jax.jit(jax.value_and_grad(
        lambda v, t, d: jnp.sum(marcher(v, t, origin, d, *scal) ** 2)
        / (h * w), argnums=(0, 1)))

    def fwd(v, t):
        return jnp.concatenate([fwd1(v, t, d) for d in bands])

    def grad(v, t):
        loss, gv, gt = 0.0, 0.0, 0.0
        for d in bands:
            lb, (gvb, gtb) = grad1(v, t, d)
            loss, gv, gt = loss + lb, gv + gvb, gt + gtb
        return loss, gv, gt

    return fwd, grad


def timed_once(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", nargs="+", default=None,
                    help="marchers to time in turns (default: the "
                         "production method, then fused)")
    ap.add_argument("--grad", action="store_true",
                    help="also time forward + backward (grid + TF grads)")
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--ray-chunks", type=int, default=1,
                    help="split the image into K row bands per step, "
                         "gradients summed over bands")
    args = ap.parse_args()

    from volumetric_renderer.utils.env import (
        enable_compile_cache, gpu_name_and_power_limit,
    )

    card = gpu_name_and_power_limit()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from volumetric_renderer.core.marcher import march_rays
    from volumetric_renderer.render.api import production_method
    from volumetric_renderer.scene.camera import ray_grid
    from volumetric_renderer.utils.config import RenderSettings

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    print(f"# platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    print(f"# card (name, power limit): {card}")

    h, w, steps, grid_n = 1080, 1920, 512, args.grid
    if h % args.ray_chunks:
        sys.exit(f"--ray-chunks {args.ray_chunks} must divide {h}")
    settings = RenderSettings(height=h, width=w, step_size=1.8 / steps,
                              early_termination=True)
    methods = [production_method() if m == "auto" else m
               for m in args.methods or ["auto", "fused"]]
    methods = list(dict.fromkeys(methods))
    vol, tf, cam = scene(grid_n)
    print(f"# workload: {grid_n}^3 sphere, {w}x{h}, {steps} steps, ET on; "
          f"methods {methods}", file=sys.stderr)

    # reference: the oracle with ET off — a fixed trip count, so the bound
    # is f32 rounding in another order (with ET on, a ray whose
    # transmittance lands within rounding of the threshold can stop one
    # step apart, an error up to the threshold itself)
    origin, dirs = ray_grid(cam, h, w)
    ref = jax.jit(lambda v, t: march_rays(
        v, t, origin + 0.5, dirs, density_min=0.0, density_max=1.0,
        slice_min=jnp.zeros(3), slice_max=jnp.ones(3), num_steps=steps,
        step_size=settings.step_size))(vol, tf)
    off = settings.replace(early_termination=False)

    res, fns, grads = {}, {}, {}
    for m in methods:
        fwd, grad = build(m, settings, cam, args.ray_chunks)
        fwd_off, _ = build(m, off, cam, 1)
        t_c, _ = timed_once(fwd, vol, tf)
        err = float(jnp.abs(fwd_off(vol, tf) - ref).max())
        res[m] = dict(fwd_first_call_s=t_c,
                      max_abs_err_vs_oracle_et_off=err, fwd_ms=[])
        fns[m] = (fwd, grad)
        print(f"# {m}: first call {t_c:.1f} s, max abs err vs oracle "
              f"(ET off) {err:.3e}", file=sys.stderr)
        if args.grad:
            t_c, grads[m] = timed_once(grad, vol, tf)
            res[m].update(fwd_bwd_first_call_s=t_c, fwd_bwd_ms=[])
    del ref

    for _ in range(args.iters):
        for m in methods:
            res[m]["fwd_ms"].append(timed_once(fns[m][0], vol, tf)[0] * 1e3)
    if args.grad:
        for _ in range(args.iters):
            for m in methods:
                res[m]["fwd_bwd_ms"].append(
                    timed_once(fns[m][1], vol, tf)[0] * 1e3)
        if "fused" in grads:
            for m in methods:
                res[m]["grad_rel_err_vs_fused"] = [
                    float(jnp.abs(a - b).max() / jnp.abs(b).max())
                    for a, b in zip(grads[m][1:], grads["fused"][1:])]

    for m in methods:
        r = res[m]
        r["fwd_ms_median"] = float(np.median(r["fwd_ms"]))
        line = f"# {m}: fwd {r['fwd_ms_median']:.3f} ms"
        if args.grad:
            r["fwd_bwd_ms_median"] = float(np.median(r["fwd_bwd_ms"]))
            line += f", fwd+bwd {r['fwd_bwd_ms_median']:.3f} ms"
        print(line, file=sys.stderr)

    first = res[methods[0]]
    key = "fwd_bwd_ms_median" if args.grad else "fwd_ms_median"
    print(json.dumps({
        "metric": f"{'fwd_bwd' if args.grad else 'fwd'}_ms_per_frame_"
                  f"{grid_n}cubed_{w}x{h}_{steps}steps",
        "value": first[key],
        "unit": "ms",
        "method": methods[0],
        "rays_per_s": h * w / (first[key] / 1e3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "samples_per_method": args.iters,
        "methods": res,
    }))


if __name__ == "__main__":
    main()
