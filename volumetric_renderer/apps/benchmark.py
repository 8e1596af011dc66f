"""Scaling benchmark harness: rays/s at 1..N devices + efficiency.

Measures the BASELINE scaling metric — rays/s efficiency from 1 chip to a
full mesh (target >= 0.9) — by timing the sharded renderer on sub-meshes
of increasing size.  On a CPU host this exercises the virtual device mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``); on a host with
several GPUs it measures real scaling over NVLink.

    python -m volumetric_renderer.apps.benchmark --size 512x512 \
        --steps 256 --grid 128
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--grad", action="store_true",
                    help="benchmark forward+backward instead of forward")
    args = ap.parse_args(argv)

    from volumetric_renderer.utils.env import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.parallel.mesh import make_mesh
    from volumetric_renderer.parallel.render import make_sharded_renderer
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.transfer.gradient import Gradient
    from volumetric_renderer.utils.config import RenderSettings

    w, h = (int(v) for v in args.size.split("x"))
    settings = RenderSettings(height=h, width=w,
                              step_size=1.8 / args.steps)
    vol = Volume.synthetic_sphere(args.grid).as_jax()
    tf = jnp.asarray(Gradient.grayscale_ramp().discretize(256))
    cam = OrbitCamera.from_angles(yaw_deg=30.0, pitch_deg=20.0)
    dmin, dmax = jnp.float32(0.0), jnp.float32(1.0)
    smin, smax = jnp.zeros(3), jnp.ones(3)

    devices = jax.devices()
    sizes = []
    n = 1
    while n <= len(devices):
        sizes.append(n)
        n *= 2
    if sizes[-1] != len(devices):
        sizes.append(len(devices))

    results = []
    for n in sizes:
        mesh = make_mesh(devices[:n])
        render_fn = make_sharded_renderer(mesh, settings)
        if args.grad:
            def work(vol, tf):
                def loss(v, t):
                    img = render_fn(v, t, cam, dmin, dmax, smin, smax)
                    return jnp.mean(img ** 2)
                return jax.grad(loss, argnums=(0, 1))(vol, tf)
            fn = jax.jit(work)
        else:
            fn = lambda v, t: render_fn(v, t, cam, dmin, dmax, smin, smax)
        warm = fn(vol, tf)
        jax.block_until_ready(warm)
        checksum = float(np.sum(jax.device_get(jax.tree.leaves(warm)[0])))
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(vol, tf))
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        print(f"devices={n}: iters={['%.4f' % t for t in times]} "
              f"checksum={checksum:.3f}", file=sys.stderr)
        rays = h * w / dt
        results.append((n, rays))
        base = results[0][1]
        eff = rays / (n * base)
        print(f"devices={n:3d}  {dt*1e3:8.1f} ms  {rays:14,.0f} rays/s  "
              f"efficiency={eff:.3f}", file=sys.stderr)

    base = results[0][1]
    out = {
        "workload": f"{args.grid}^3/{args.size}/{args.steps}steps"
                    + ("/grad" if args.grad else ""),
        "scaling": [
            {"devices": n, "rays_per_s": r, "efficiency": r / (n * base)}
            for n, r in results
        ],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
