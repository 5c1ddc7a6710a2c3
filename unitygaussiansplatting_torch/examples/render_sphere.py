"""Demo: render the synthetic sphere scene over a background and save a PNG.

The port of ``examples/render_sphere.py``: 20,000 splats at 512x384, SH3,
``render_over_background`` over [0.1, 0.1, 0.12].  Prints the first render
(with the kernels' build, when this call built them), the steady ms/frame
over 5 frames by CUDA events, the image statistics, and writes the PNG.

    python -m unitygaussiansplatting_torch.examples.render_sphere [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..models.camera import Camera
from ..models.renderer import render_over_background
from ..utils.config import RenderSettings
from ..utils.device import resolve_device
from ..utils.synthetic import sphere_scene
from ._common import Stopwatch, add_device_arg, build_note, missing_libraries, save_rgb

BACKGROUND = (0.1, 0.1, 0.12)


def camera(width: int = 512, height: int = 384) -> Camera:
    return Camera.look_at(eye=[0.0, 0.8, -3.2], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=width,
                          height=height)


def run(out: str | None = None, n: int = 20_000, width: int = 512, height: int = 384, frames: int = 5,
        backend: str = "cuda", device=None) -> dict:
    """Render the scene ``1 + frames`` times; returns the last image and the
    times.  Writes the PNG to ``out`` when given."""
    dev = resolve_device(device)
    g = sphere_scene(n=n, seed=0).to(dev).activate()
    cam = camera(width, height)
    bg = torch.tensor(BACKGROUND, device=dev)
    settings = RenderSettings(sh_order=3)

    def frame():
        with torch.no_grad():
            return render_over_background(g, cam, bg, settings, backend=backend, device=dev)

    missing = missing_libraries()
    watch = Stopwatch(dev)
    watch.start()
    img = frame()
    first_ms = watch.stop()
    note = build_note(dev, missing)
    watch.start()
    for _ in range(frames):
        img = frame()
    steady_ms = watch.stop() / frames
    lo, hi, mean = torch.stack([img.min(), img.max(), img.mean()]).tolist()
    print(f"first render ({note}): {first_ms / 1e3:.2f}s")
    print(f"steady render: {steady_ms:.2f} ms/frame")
    print("img stats: min", lo, "max", hi, "mean", mean)
    if out:
        save_rgb(out, img)
        print("wrote", out)
    return dict(img=img, first_ms=first_ms, steady_ms=steady_ms, build=note, min=lo, max=hi, mean=mean)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out", nargs="?", default=os.path.join(tempfile.gettempdir(), "sphere.png"))
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    return run(args.out, device=dev)


if __name__ == "__main__":
    main()
