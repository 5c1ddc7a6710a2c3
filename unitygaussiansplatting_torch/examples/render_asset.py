"""Demo: the complete user story — import a splat file, render it.

    python -m unitygaussiansplatting_torch.examples.render_asset scene.ply out.png [--quality medium] [--device cpu]
    python -m unitygaussiansplatting_torch.examples.render_asset scene.asset.json out.png --camera 0

The port of ``examples/render_asset.py``: a raw .ply/.spz is imported on the
fly (``io.creator.create_asset``), a saved .asset.json (from ``python -m
unitygaussiansplatting_torch.io.creator`` or the JAX package's creator) is
loaded.  The asset renders from its quantized blobs on the device, decoded
every frame (``DeviceAsset``, the reference's per-frame ``LoadSplatData``),
or with ``--host-decode`` from float splats decoded on the host.  The camera
is an imported cameras.json camera when one is asked for, else one framing
the scene's bounds.  The frame is rendered through ``render_with_stats`` and
its pair-budget overflow flag is printed: the default config is kept, as in
the JAX script, and a frame that overflows it is missing splats.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..io.asset import decode_asset, load_asset
from ..io.bridge import input_splats_to_gaussians
from ..io.creator import create_asset
from ..io.device_asset import device_asset_from_asset
from ..models.camera import Camera
from ..models.renderer import render_with_stats
from ..ops.composite import composite_over
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device
from ._common import Stopwatch, add_device_arg, save_rgb

BACKENDS = ("cuda", "torch", "reference")


def asset_camera(asset, camera: int | None, width: int, height: int, fov: float) -> Camera:
    """The imported camera ``camera`` when the asset has cameras, else a
    camera framing its bounds (``examples/render_asset.py:222-230``)."""
    if camera is not None and asset.cameras:
        return Camera.from_camera_info(asset.cameras[camera], width, height, fov)
    center = (asset.bounds_min + asset.bounds_max) / 2
    extent = float(np.linalg.norm(asset.bounds_max - asset.bounds_min))
    eye = center + np.array([0.0, 0.25 * extent, -0.9 * extent], np.float32)
    return Camera.look_at(eye, center, [0, 1, 0], fov, width, height)


def run(input_path: str, output: str | None = None, quality: str = "medium", width: int = 1200,
        height: int = 797, fov: float = 47.0, camera: int | None = None, sh_order: int = 3,
        backend: str = "cuda", host_decode: bool = False, device=None) -> dict:
    """Import or load ``input_path``, render one frame over black; returns
    the image, the frame's ``RenderStats``, its device ms and the asset."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    dev = resolve_device(device)
    if input_path.endswith(".asset.json"):
        asset = load_asset(input_path)
    else:
        asset = create_asset(input_path, quality=quality, device=dev)
    if host_decode:
        cloud = input_splats_to_gaussians(decode_asset(asset), device=dev)
        print(f"{asset.splat_count} splats, {asset.total_bytes() / 1e6:.1f} MB asset (host decode)")
    else:
        cloud = device_asset_from_asset(asset, device=dev)
        print(f"{asset.splat_count} splats, {asset.total_bytes() / 1e6:.1f} MB asset, "
              f"{cloud.device_bytes() / 1e6:.1f} MB device-resident")
    cam = asset_camera(asset, camera, width, height, fov)

    watch = Stopwatch(dev).start()
    with torch.no_grad():
        rt, stats = render_with_stats(cloud, cam, RenderSettings(sh_order=sh_order), RasterizeConfig(), backend,
                                      device=dev)
        img = composite_over(rt, torch.zeros(3))
    frame_ms = watch.stop()
    overflow = bool(stats.overflowed)
    print(f"frame {frame_ms:.2f} ms; pair demand {int(stats.num_pairs)} of budget {stats.budget}, overflow "
          f"{overflow}" + (" (pairs were dropped: the frame misses splats)" if overflow else ""))
    if output:
        save_rgb(output, img)
        print("wrote", output)
    return dict(img=img, stats=stats, overflow=overflow, frame_ms=frame_ms, asset=asset, camera=cam)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("input", help=".ply / .spz / .asset.json")
    p.add_argument("output", help="output PNG path")
    p.add_argument("-q", "--quality", default="medium")
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=797)
    p.add_argument("--fov", type=float, default=47.0)
    p.add_argument("--camera", type=int, default=None, help="imported camera index")
    p.add_argument("--sh-order", type=int, default=3)
    p.add_argument("--backend", default="cuda", choices=BACKENDS)
    p.add_argument(
        "--host-decode",
        action="store_true",
        help="decode to float splats on the host instead of rendering from the compressed blobs on device",
    )
    add_device_arg(p)
    args = p.parse_args(argv)
    return run(args.input, args.output, quality=args.quality, width=args.width, height=args.height, fov=args.fov,
               camera=args.camera, sh_order=args.sh_order, backend=args.backend, host_decode=args.host_decode,
               device=args.device)


if __name__ == "__main__":
    main()
