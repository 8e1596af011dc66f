"""Turntable viewer: the offline replacement for the SDL/ImGui front end.

The reference demonstrates itself with an orbiting GIF
(``docs/images/example.gif``; camera drag = ``Camera::rotate``,
``src/scene/camera.cpp:15-29``).  This app reproduces that artifact
head-on: render an orbit sweep and write an animated GIF (or a PNG frame
sequence), with the same orbit camera math and a live rays/s meter in
place of the status-bar FPS counter.

    python -m volumetric_renderer.apps.turntable --synthetic \
        --frames 36 --size 512x512 --out orbit.gif
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--pitch", type=float, default=20.0)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--steps", type=int, default=180)
    ap.add_argument("--out", default="orbit.gif")
    ap.add_argument("--fps", type=int, default=12)
    ap.add_argument("--tf", default="preset:ramp")
    args = ap.parse_args(argv)

    from volumetric_renderer.utils.env import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from volumetric_renderer.apps.render_cli import load_tf
    from volumetric_renderer.data.importer import import_volume
    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.render.api import composite_over, render
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.utils.config import RenderSettings
    from volumetric_renderer.utils.metrics import ThroughputMeter

    w, h = (int(v) for v in args.size.split("x"))
    vol = (Volume.synthetic_sphere(64) if args.synthetic or not args.dataset
           else import_volume(args.dataset))
    tf = jnp.asarray(load_tf(args.tf, 256))
    settings = RenderSettings(height=h, width=w,
                              step_size=1.8 / args.steps)
    vj = vol.as_jax()
    bg = jnp.asarray([0.11, 0.11, 0.11])

    # one jitted renderer reused across frames: the camera is a traced
    # argument, so every frame after the first is compile-free
    fn = jax.jit(lambda cam: composite_over(
        render(vj, tf, cam, settings,
               density_min=vol.vmin, density_max=vol.vmax), bg))

    meter = ThroughputMeter()
    meter.tick(0)
    frames = []
    for i in range(args.frames):
        cam = OrbitCamera.from_angles(
            yaw_deg=360.0 * i / args.frames, pitch_deg=args.pitch)
        rgb = np.asarray(fn(cam))
        rate = meter.tick(h * w)
        if i == 0 or (i + 1) % 10 == 0:
            print(f"frame {i+1}/{args.frames}"
                  + (f"  {rate:,.0f} rays/s" if rate else ""),
                  file=sys.stderr)
        frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))

    from PIL import Image
    imgs = [Image.fromarray(f) for f in frames]
    if args.out.endswith(".gif"):
        imgs[0].save(args.out, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / args.fps), loop=0)
    else:
        for i, im in enumerate(imgs):
            im.save(args.out.replace("%d", str(i)) if "%d" in args.out
                    else f"{args.out}.{i:04d}.png")
    print(args.out)


if __name__ == "__main__":
    main()
