"""Tile-overlap / depth-complexity statistics of the synthetic scenes.

The port of ``tools/measure_overlap.py``: for each scene at its bench camera
(1200x797, the default ``RasterizeConfig``), the visible share, the
per-splat tile-rect size distribution (what ``pair_multiplier`` must cover)
and the per-tile pair counts (the depth complexity a tile composites).  The
projection and the tile rects run on the device, the histogram and the
2-D difference grid of the per-tile counts in torch there; the host reads
the finished statistics.

    python -m unitygaussiansplatting_torch.tools.measure_overlap [n] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..examples._common import add_device_arg
from ..models.camera import Camera
from ..ops.binning import tile_grid, tile_rects
from ..ops.projection import project_splats
from ..utils import synthetic
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device

WIDTH, HEIGHT = 1200, 797
HIST_BINS = 16  # rect sizes 1..16, the last bin 16 and over
# The three scenes and their cameras (tools/measure_overlap.py:68-82).
SCENES = {
    "sphere_scene ": (synthetic.sphere_scene, 0, ([0, 0.6, -3.0], [0, 0, 0])),
    "outdoor_scene": (synthetic.outdoor_scene, 1, ([0, 0.4, -5.0], [0, -0.2, 0])),
    "captured_scene": (synthetic.captured_scene, 3, ([6.5, 2.2, -8.0], [0, 0.3, 0])),
}


def scene_camera(name: str, width: int = WIDTH, height: int = HEIGHT) -> Camera:
    eye, target = SCENES[name][2]
    return Camera.look_at(eye=eye, target=target, up=[0, 1, 0], fov_y_deg=47.0, width=width, height=height)


def overlap_stats(rects, n: int, tiles_x: int, tiles_y: int) -> dict:
    """The statistics of ``tile_rects``' output ``rects`` (on any device)
    for a cloud of ``n`` splats: the visible share, pairs per splat (mean
    over all and over the visible; p50/p95/p99/max), the rect-size
    histogram and the (tiles_y, tiles_x) per-tile pair counts, summed from
    a 2-D difference grid."""
    x0, y0, nx, ny, counts, valid = rects
    v = valid & (counts > 0)
    c = counts[v].to(torch.int64)
    cf = c.to(torch.float64)
    q = torch.tensor([0.5, 0.95, 0.99], dtype=torch.float64, device=cf.device)
    hist = torch.bincount(torch.clamp(c, 0, HIST_BINS), minlength=HIST_BINS + 1)

    grid = torch.zeros((tiles_y + 1, tiles_x + 1), dtype=torch.int64, device=c.device)
    x0v, y0v, nxv, nyv = (t[v].to(torch.int64) for t in (x0, y0, nx, ny))
    one = torch.ones_like(x0v)
    for (ys, xs), sign in (((y0v, x0v), one), ((y0v + nyv, x0v), -one), ((y0v, x0v + nxv), -one),
                           ((y0v + nyv, x0v + nxv), one)):
        grid.index_put_((ys, xs), sign, accumulate=True)
    per_tile = torch.cumsum(torch.cumsum(grid, 0), 1)[:tiles_y, :tiles_x]
    tile_q = torch.quantile(per_tile.flatten().to(torch.float64), q[:2])

    scalars = torch.stack([
        v.to(torch.float64).mean(), c.sum().to(torch.float64), cf.mean(), *torch.quantile(cf, q),
        c.max().to(torch.float64), per_tile.to(torch.float64).mean(), *tile_q, per_tile.max().to(torch.float64),
    ]).tolist()
    visible, total, mean_visible, p50, p95, p99, cmax, tile_mean, tile_p50, tile_p95, tile_max = scalars
    return dict(
        visible=visible, pairs_per_splat=total / n, pairs_per_visible=mean_visible, p50=p50, p95=p95, p99=p99,
        max=int(cmax), visible_count=int(c.numel()), hist=hist.cpu().numpy(), per_tile=per_tile,
        tile_mean=tile_mean, tile_p50=tile_p50, tile_p95=tile_p95, tile_max=int(tile_max),
    )


def report_lines(name: str, s: dict) -> list[str]:
    """The JAX tool's three lines (``tools/measure_overlap.py:40-61``)."""
    return [
        f"{name}: visible {s['visible']:.3f}, pairs/splat mean {s['pairs_per_splat']:.2f} "
        f"(visible-only {s['pairs_per_visible']:.2f}), p50 {s['p50']:.0f} p95 {s['p95']:.0f} "
        f"p99 {s['p99']:.0f} max {s['max']}",
        f"  rect-size histogram (1..16+): {(s['hist'][1:] / max(s['visible_count'], 1)).round(3)}",
        f"  per-tile pairs: mean {s['tile_mean']:.0f} p50 {s['tile_p50']:.0f} p95 {s['tile_p95']:.0f} "
        f"max {s['tile_max']}",
    ]


def stats(name: str, raw, cam: Camera, config: RasterizeConfig, device=None) -> dict:
    """Project ``raw`` at ``cam`` on ``device`` (CUDA unless told otherwise),
    take its tile rects and print and return :func:`overlap_stats`."""
    dev = resolve_device(device)
    with torch.no_grad():
        proj = project_splats(raw.to(dev).activate(), cam.to(dev), RenderSettings(sh_order=0))
        rects = tile_rects(proj, cam.width, cam.height, config)
        out = overlap_stats(rects, raw.num_splats, *tile_grid(cam.width, cam.height, config))
    for line in report_lines(name, out):
        print(line)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=1_000_000)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = RasterizeConfig()
    return {name: stats(name, make(n=args.n, seed=seed), scene_camera(name), config, dev)
            for name, (make, seed, _) in SCENES.items()}


if __name__ == "__main__":
    main()
