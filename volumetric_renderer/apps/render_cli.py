"""Offline renderer CLI — the reference app's full interactive surface as
flags.

The reference exposes, via ImGui (``src/ui/main_window.cpp:178-258``):
dataset import (NRRD / CSV stack), camera orbit + zoom, per-axis slicing
windows, the density window, and a transfer-function editor; the result is
shown in the viewport.  This CLI maps every one of those controls onto an
offline invocation producing a PNG (and optionally the raw RGBA .npy):

    python -m volumetric_renderer.apps.render_cli head.nrrd \
        --yaw 30 --pitch 20 --zoom 3 --size 1024x768 \
        --slice-x 0.1:0.9 --tf preset:grayscale --out head.png

Transfer functions: ``preset:grayscale`` (the reference default,
black->white / alpha 1, ``gradient.cpp:64-70``), ``preset:ramp``
(alpha ramp), or a JSON file with ``color_markers`` / ``alpha_markers``
lists mirroring the marker data model (``gradient.h:11-35``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_range(s: str):
    lo, hi = s.split(":")
    return float(lo), float(hi)


def load_tf(spec: str, resolution: int):
    from volumetric_renderer.transfer.gradient import Gradient
    if spec.startswith("preset:"):
        name = spec.split(":", 1)[1]
        if name == "grayscale":
            g = Gradient()           # reference default markers
        elif name == "ramp":
            g = Gradient.grayscale_ramp()
        else:
            raise SystemExit(f"unknown TF preset {name!r}")
    else:
        with open(spec) as f:
            d = json.load(f)
        g = Gradient(
            color_markers=[(m[0], tuple(m[1:4]))
                           for m in d.get("color_markers", [])] or None,
            alpha_markers=[tuple(m) for m in d.get("alpha_markers", [])]
            or None,
        )
    return g.discretize(resolution)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render a volumetric dataset to PNG")
    ap.add_argument("dataset", nargs="+",
                    help="NRRD file, or CSV slice files (one per Z slice)")
    ap.add_argument("--format", choices=["nrrd", "csv"], default=None)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--npy", default=None, help="also save raw RGBA .npy")
    ap.add_argument("--size", default="1280x720",
                    help="WxH (reference window: 1280x720)")
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--pitch", type=float, default=0.0)
    ap.add_argument("--zoom", type=float, default=3.0,
                    help="orbit radius, clamped to [0.1, 10] like "
                         "camera.cpp:31-34")
    ap.add_argument("--steps", type=int, default=360,
                    help="march steps (reference: 360, volume.frag:29-31)")
    ap.add_argument("--ray-dist", type=float, default=1.8)
    ap.add_argument("--slice-x", type=parse_range, default=(0.0, 1.0),
                    metavar="LO:HI")
    ap.add_argument("--slice-y", type=parse_range, default=(0.0, 1.0),
                    metavar="LO:HI")
    ap.add_argument("--slice-z", type=parse_range, default=(0.0, 1.0),
                    metavar="LO:HI")
    ap.add_argument("--density", type=parse_range, default=None,
                    metavar="LO:HI", help="density window (default: "
                    "dataset min/max, offscreen_pass.cpp:265-266)")
    ap.add_argument("--tf", default="preset:grayscale")
    ap.add_argument("--tf-resolution", type=int, default=256)
    ap.add_argument("--background", type=float, nargs=3,
                    default=(0.11, 0.11, 0.11))
    ap.add_argument("--no-early-termination", action="store_true")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "march", "blocked", "fused", "oracle"],
                    help="auto = the backend's production marcher (the "
                         "ray-march kernel on a GPU, fused XLA on the CPU)")
    ap.add_argument("--synthetic", action="store_true",
                    help="ignore dataset path; render the built-in sphere")
    args = ap.parse_args(argv)

    from volumetric_renderer.utils.env import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from volumetric_renderer.data.formats import write_png_rgb
    from volumetric_renderer.data.importer import import_volume
    from volumetric_renderer.data.volume import Volume
    from volumetric_renderer.render.api import composite_over, render
    from volumetric_renderer.scene.camera import OrbitCamera
    from volumetric_renderer.utils.config import RenderSettings
    from volumetric_renderer.utils.metrics import ThroughputMeter

    w, h = (int(v) for v in args.size.split("x"))
    if args.synthetic:
        vol = Volume.synthetic_sphere(64)
    else:
        paths = args.dataset if len(args.dataset) > 1 else args.dataset[0]
        vol = import_volume(paths, fmt=args.format)

    tf = jnp.asarray(load_tf(args.tf, args.tf_resolution))
    cam = OrbitCamera.from_angles(yaw_deg=args.yaw, pitch_deg=args.pitch,
                                  radius=args.zoom)
    settings = RenderSettings(
        height=h, width=w,
        step_size=args.ray_dist / args.steps, ray_dist=args.ray_dist,
        early_termination=not args.no_early_termination,
        tf_resolution=args.tf_resolution,
    )
    dmin, dmax = args.density if args.density else (vol.vmin, vol.vmax)
    smin = jnp.asarray([args.slice_x[0], args.slice_y[0], args.slice_z[0]])
    smax = jnp.asarray([args.slice_x[1], args.slice_y[1], args.slice_z[1]])

    meter = ThroughputMeter()
    meter.tick(0)
    t0 = time.perf_counter()
    img = render(vol.as_jax(), tf, cam, settings,
                 density_min=dmin, density_max=dmax,
                 slice_min=smin, slice_max=smax, method=args.method)
    img = np.asarray(img)
    rate = meter.tick(h * w)
    print(f"rendered {w}x{h} in {time.perf_counter()-t0:.2f}s "
          f"({rate:,.0f} rays/s incl. compile)", file=sys.stderr)

    if args.npy:
        np.save(args.npy, img)
    rgb = np.asarray(composite_over(jnp.asarray(img),
                                    jnp.asarray(args.background)))
    write_png_rgb(args.out, (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8))
    print(args.out)


if __name__ == "__main__":
    main()
