"""Tile-binned front-to-back rasterization in plain PyTorch (the tile path).

The port of the JAX package's XLA path (``rasterize_tiles_jax``): each tile
walks its depth-ordered pair range from :func:`binning.bin_splats` in chunks
of ``config.chunk_size`` (``tile_common.chunk_alphas`` and
``composite_chunk``), all tiles at once, and autograd differentiates it.  A
step holds several (tiles, chunk, pixels) float32 tensors, 0.5-1 GB each at
1200x797 with 32x64 tiles, and autograd keeps them for every step: the path
suits test-sized images and frames without a gradient.  ``backend="cuda"``
streams per tile and has no such cost.
"""

from __future__ import annotations

import torch

from ..utils.config import RasterizeConfig
from .binning import TileBinning, cdiv, tile_grid
from .projection import ProjectedSplats
from .tile_common import chunk_alphas, composite_chunk, quantize_view_fp16


def gather_pair_data(proj: ProjectedSplats, binning: TileBinning, chunk: int):
    """Per-pair splat view data in sorted pair order, padded by one chunk of
    dead rows; ``(center, axis1, axis2, color, opacity)``."""
    n = proj.depth.shape[0]
    ids = binning.pair_splat.long()
    real = ids < n
    safe = torch.clamp(ids, max=n - 1)

    def pad(x):
        return torch.cat([x, x.new_zeros((chunk,) + x.shape[1:])])

    opacity = torch.where(real, proj.opacity[safe], 0.0)
    return pad(proj.center[safe]), pad(proj.axis1[safe]), pad(proj.axis2[safe]), pad(proj.color[safe]), pad(opacity)


def rasterize_tiles_torch(
    proj: ProjectedSplats,
    binning: TileBinning,
    width: int,
    height: int,
    config: RasterizeConfig = RasterizeConfig(),
) -> torch.Tensor:
    """Composite tile-binned splats; (H, W, 4) premultiplied RGBA.

    A tile composites at most ``cdiv(max_pairs_per_tile, chunk_size)``
    chunks, the JAX package's static trip count; the pairs past them are
    dropped.  The loop stops at the busiest tile's chunk count when that is
    fewer (one host read): the steps past it add exact zeros.
    """
    proj = quantize_view_fp16(proj, config)
    dev = proj.depth.device
    th, tw, chunk = config.tile_h, config.tile_w, config.chunk_size
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    p = th * tw

    center, axis1, axis2, color, opacity = gather_pair_data(proj, binning, chunk)
    k = binning.pair_rank.shape[0]

    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tx, ty = tile_ids % tiles_x, tile_ids // tiles_x
    ix = torch.arange(tw, dtype=torch.float32, device=dev) + 0.5
    iy = torch.arange(th, dtype=torch.float32, device=dev) + 0.5
    px = (tx[:, None, None] * tw + ix[None, None, :]).expand(num_tiles, th, tw).reshape(num_tiles, p)
    py = (ty[:, None, None] * th + iy[None, :, None]).expand(num_tiles, th, tw).reshape(num_tiles, p)

    starts = binning.tile_starts[:-1].long()
    ends = binning.tile_starts[1:].long()
    busiest = int(torch.max(ends - starts)) if num_tiles else 0
    steps = min(cdiv(config.max_pairs_per_tile, chunk), cdiv(busiest, chunk))
    lane = torch.arange(chunk, device=dev)

    rgb = torch.zeros((num_tiles, p, 3), dtype=torch.float32, device=dev)
    acc_a = torch.zeros((num_tiles, p), dtype=torch.float32, device=dev)
    t = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    for i in range(steps):
        base = starts + i * chunk  # (T,)
        # The one-chunk pad keeps every partly live chunk inside the rows; a
        # clamped start (the JAX package's dynamic_slice) reads dead rows only.
        idx = torch.clamp(base, max=k)[:, None] + lane  # (T, C)
        live = (base[:, None] + lane) < ends[:, None]
        alphas = chunk_alphas(center[idx], axis1[idx], axis2[idx], opacity[idx], px, py, config)
        alphas = torch.where(live[..., None], alphas, 0.0)
        d_rgb, d_a, t = composite_chunk(t, alphas, color[idx])
        rgb = rgb + d_rgb
        acc_a = acc_a + d_a

    rgba = torch.cat([rgb, acc_a[..., None]], dim=-1)  # (T, P, 4)
    img = rgba.reshape(tiles_y, tiles_x, th, tw, 4).permute(0, 2, 1, 3, 4).reshape(tiles_y * th, tiles_x * tw, 4)
    return img[:height, :width]
