"""Early-termination ablation on realistic workloads.

The reference never terminates rays early — it breaks only on leaving the
unit cube (``res/shaders/volume.frag:33-37``); early termination on
transmittance saturation is a BASELINE-required improvement.  Whether it
*pays* depends on the scene: a translucent sphere never saturates (the
round-2 ablation measured exactly that and found ~1x), while an opaque
surface — the CT-head case it exists for (BASELINE config 2) — stops rays
within a few samples of the skull shell.

Measures, on the device JAX runs on:

* config 2: ``models.head_phantom`` 128^3, 512x512, 360 steps, an opaque
  bone TF (alpha ramps to 1 at skull density) — the production marcher,
  blocked and fused, ET on vs off.
* flagship: 256^3 sphere, 1920x1080, 512 steps, the bench TF — the
  production marcher only, ET on vs off.

    python -m volumetric_renderer.apps.ablation --out ablation.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--skip-flagship", action="store_true")
    ap.add_argument("--methods", nargs="+", default=None,
                    help="default: the production marcher, blocked, fused")
    ap.add_argument("--size", default="512x512",
                    help="config-2 image size (shrink for smoke tests)")
    ap.add_argument("--steps", type=int, default=360,
                    help="config-2 march steps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from volumetric_renderer.utils.env import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from volumetric_renderer import models
    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.render.api import production_method, render
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.transfer.gradient import Gradient
    from volumetric_renderer.utils.config import RenderSettings

    production = production_method()
    methods = args.methods or list(dict.fromkeys(
        [production, "blocked", "fused"]))
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)

    def timed(fn, *a):
        jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    out = {"device": str(jax.devices()[0].device_kind), "workloads": {}}

    def run(name, vol, tf, settings, methods):
        res = {}
        rays = settings.height * settings.width
        for method in methods:
            for et in (True, False):
                s = settings.replace(early_termination=et)
                fn = jax.jit(lambda v, t, s=s, m=method: render(
                    v, t, cam, s, method=m))
                dt = timed(fn, vol, tf)
                key = f"{method}_et{'on' if et else 'off'}"
                res[key] = dict(ms_per_frame=round(dt * 1e3, 2),
                                rays_per_s=round(rays / dt))
                print(f"# {name} {key}: {dt*1e3:.0f} ms", file=sys.stderr)
        for method in methods:
            on = res[f"{method}_eton"]["ms_per_frame"]
            off = res[f"{method}_etoff"]["ms_per_frame"]
            res[f"et_speedup_{method}"] = round(off / on, 4)
            print(f"# {name} ET speedup {method}: {off/on:.3f}x",
                  file=sys.stderr)
        out["workloads"][name] = res

    # config 2: opaque skull — the case early termination exists for
    vol2 = models.head_phantom(128).as_jax()
    ntf = 256
    tf2 = jnp.asarray(Gradient.grayscale_ramp().discretize(ntf))
    # linear RGBA TF whose alpha reaches ~1 by skull density (0.9)
    tf2 = tf2.at[:, 3].set(jnp.clip(
        jnp.linspace(0.0, 1.0, ntf) / 0.85, 0.0, 1.0))
    c2w, c2h = (int(v) for v in args.size.split("x"))
    run("config2_head_phantom", vol2, tf2,
        RenderSettings(height=c2h, width=c2w, step_size=1.8 / args.steps),
        methods)

    if not args.skip_flagship:
        vol3 = Volume.synthetic_sphere(256).as_jax()
        tf3 = jnp.asarray(Gradient.grayscale_ramp().discretize(ntf))
        tf3 = tf3.at[:, 3].set(jnp.linspace(0.0, 1.0, ntf) ** 2)
        run("flagship_sphere", vol3, tf3,
            RenderSettings(height=1080, width=1920, step_size=1.8 / 512),
            [production])

    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(args.out)
    else:
        print(text)


if __name__ == "__main__":
    main()
