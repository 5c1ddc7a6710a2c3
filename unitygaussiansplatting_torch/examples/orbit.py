"""Demo: viewer-style camera orbit — render a turntable PNG sequence.

    python -m unitygaussiansplatting_torch.examples.orbit out_dir [--n 200000] [--frames 12] [--device cpu]
    python -m unitygaussiansplatting_torch.examples.orbit out_dir --ply scene.ply --frames 60

The port of ``examples/orbit.py``: the offline analog of the reference's
orbiting viewer camera (GaussianSplatRenderer.cs ``ActivateCamera``).  The
JAX script traces the pose into one jitted function so that the orbit never
recompiles.  Here every pose is built on the host before the first frame and
uploaded once as one (frames, 4, 4) tensor; a frame takes its row, so the
loop does no host work for the pose, reads nothing back but the finished
image for its PNG, and rebuilds nothing keyed on the view.  It prints the
device ms/frame by CUDA events beside the JAX script's figure, which
includes the PNG encode (host zlib).

Differs from the JAX script on purpose: with ``--ply`` the JAX script calls
``.activate()`` on the already activated ``Gaussians`` that
``input_splats_to_gaussians`` returns, which has no such method; the port
renders that cloud as it is.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..io.bridge import input_splats_to_gaussians
from ..io.ply import read_ply
from ..models.camera import Camera
from ..models.renderer import render
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device
from ..utils.image import save_png
from ..utils.synthetic import sphere_scene
from ._common import Stopwatch, add_device_arg

FOV = 47.0


def orbit_cameras(center, radius: float, frames: int, width: int, height: int) -> list[Camera]:
    """The turntable's cameras, frame ``i`` at ``theta = 2 pi i / frames``
    (``examples/orbit.py:135-143``), on the CPU."""
    center = np.asarray(center, np.float32)
    cams = []
    for i in range(frames):
        theta = 2.0 * np.pi * i / frames
        eye = center + radius * np.asarray([np.sin(theta), 0.2, -np.cos(theta)], np.float32)
        cams.append(Camera.look_at(eye=eye, target=center, up=[0, 1, 0], fov_y_deg=FOV, width=width,
                                   height=height))
    return cams


def load_cloud(ply: str | None, n: int, device):
    """``(Gaussians on device, orbit center)``: the PLY's splats around their
    mean, or the synthetic sphere around the origin."""
    if ply:
        g = input_splats_to_gaussians(read_ply(ply), device=device)
        center = g.means.cpu().numpy().mean(axis=0)
    else:
        g = sphere_scene(n=n, seed=0).to(device).activate()
        center = np.zeros(3, np.float32)
    return g, center


def run(out_dir: str | None = None, ply: str | None = None, n: int = 200_000, frames: int = 12,
        width: int = 512, height: int = 384, radius: float = 3.0, sh_order: int = 3, backend: str = "cuda",
        device=None) -> dict:
    """Render the orbit; returns the frames' device ms, the wall ms/frame
    with the PNG encode, and the last frame (host numpy).  ``out_dir=None``
    writes no PNG (each frame is still read back, as for a PNG)."""
    dev = resolve_device(device)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    g, center = load_cloud(ply, n, dev)
    settings = RenderSettings(sh_order=sh_order)
    config = RasterizeConfig()
    base = Camera.look_at(eye=center + np.asarray([0.0, 0.6, -radius], np.float32), target=center, up=[0, 1, 0],
                          fov_y_deg=FOV, width=width, height=height)
    views = torch.stack([c.view for c in orbit_cameras(center, radius, frames, width, height)]).to(dev)

    def frame(i):
        with torch.no_grad():
            return render(g, dataclasses.replace(base, view=views[i]), settings, config, backend=backend, device=dev)

    frame(0)  # the kernels' build and the allocator's first blocks
    watch = Stopwatch(dev)
    device_ms = []
    t0 = time.perf_counter()
    for i in range(frames):
        watch.start()
        img = frame(i)
        device_ms.append(watch.stop())
        pixels = img.cpu().numpy()
        del img  # the next frame reuses its memory
        if out_dir:
            save_png(os.path.join(out_dir, f"orbit_{i:04d}.png"), pixels)
    wall_ms = (time.perf_counter() - t0) / frames * 1e3
    mean_ms = sum(device_ms) / frames
    print(f"{frames} frames at {wall_ms:.1f} ms/frame (incl. PNG encode), {mean_ms:.2f} ms/frame on {dev.type} "
          f"-> {out_dir}")
    return dict(frame=pixels, device_ms=device_ms, device_ms_mean=mean_ms, wall_ms_per_frame=wall_ms)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--ply", default=None, help="render this file instead of the synthetic scene")
    p.add_argument("--n", type=int, default=200_000, help="synthetic splat count")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--radius", type=float, default=3.0)
    p.add_argument("--sh-order", type=int, default=3)
    add_device_arg(p)
    args = p.parse_args(argv)
    return run(args.out_dir, ply=args.ply, n=args.n, frames=args.frames, width=args.width, height=args.height,
               radius=args.radius, sh_order=args.sh_order, device=args.device)


if __name__ == "__main__":
    main()
