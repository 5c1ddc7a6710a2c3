"""Screen-tile binning helpers: grid, pair budget, depth keys, tile rects.

The tile-binned formulation of the official 3DGS rasterizer with a static
(splat, tile) pair budget.  Compositing order framework-wide is the quantized
view depth (top ``db`` bits of the positive float32 depth), ties broken by
splat id, fused with the tile id into one 32-bit key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.config import RasterizeConfig
from .projection import ProjectedSplats
from .tile_common import true_div


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TileBinning(NamedTuple):
    """Tile-sorted (splat, tile) pairs plus per-tile ranges.

    The fused pipeline (pair_expand.bin_and_prepare) generates pairs
    splat-major, so ``pair_rank`` holds original splat ids (n = sentinel).
    """

    pair_rank: torch.Tensor  # (K,) int32 splat id per sorted pair
    pair_tile: torch.Tensor  # (K,) int32 tile id per pair (num_tiles = sentinel)
    rank_counts: torch.Tensor  # (N,) int32 slots generated per splat
    tile_starts: torch.Tensor  # (T + 1,) int32: pairs of tile t are [s[t], s[t+1])
    num_pairs: torch.Tensor  # () int32 slot demand before budget clipping


def pair_budget(num_splats: int, config: RasterizeConfig) -> int:
    """Static (splat, tile) pair capacity for a given splat count."""
    k = int(num_splats * config.pair_multiplier)
    return max(cdiv(k, 1024) * 1024, 1024)


def tile_grid(width: int, height: int, config: RasterizeConfig) -> tuple[int, int]:
    return cdiv(width, config.tile_w), cdiv(height, config.tile_h)


def depth_key_bits(num_tiles: int) -> int:
    """Bits of quantized depth left in a fused (tile | depth) 32-bit key."""
    tile_vals = num_tiles + 2  # + sentinel tile, exclusive bound
    tb = max(int(tile_vals - 1).bit_length(), 1)
    db = 32 - tb
    if db < 12:
        raise ValueError(f"tile grid too large for fused sort key: {num_tiles} tiles")
    return min(db, 24)


def quantize_depth(depth: torch.Tensor, bits: int) -> torch.Tensor:
    """(N,) int32 monotone depth key in [0, 2^bits) for positive depths."""
    raw = depth.to(torch.float32).contiguous().view(torch.int32)
    raw = torch.clamp(raw, min=0)  # depth <= 0 is culled anyway
    return raw >> (32 - bits)


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with NaN mapped to 0 (XLA's conversion; PyTorch leaves
    NaN conversion undefined)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


def tile_rects(proj: ProjectedSplats, width: int, height: int, config: RasterizeConfig):
    """Per-splat tile-rect bounds: (x0, y0, nx, ny, counts, valid), int32.

    Opacity-aware ellipse AABBs when alpha_discard > 0 (a pixel past
    rho = sqrt(log(opacity / alpha_discard)) axis lengths is discarded
    anyway); quad-corner AABBs otherwise.
    """
    tiles_x, tiles_y = tile_grid(width, height, config)
    a1x, a1y = proj.axis1[:, 0], proj.axis1[:, 1]
    a2x, a2y = proj.axis2[:, 0], proj.axis2[:, 1]
    valid = proj.valid
    if config.alpha_discard > 0.0:
        rho = torch.sqrt(
            torch.clamp(
                torch.log(true_div(torch.clamp(proj.opacity, min=1e-30), config.alpha_discard)), min=0.0
            )
        )
        rx = rho * torch.sqrt(a1x * a1x + a2x * a2x) * 1.0001 + 0.01
        ry = rho * torch.sqrt(a1y * a1y + a2y * a2y) * 1.0001 + 0.01
        if config.quad_clip:
            rx = torch.minimum(rx, 2.0 * (torch.abs(a1x) + torch.abs(a2x)) + 0.01)
            ry = torch.minimum(ry, 2.0 * (torch.abs(a1y) + torch.abs(a2y)) + 0.01)
        valid = valid & (proj.opacity >= config.alpha_discard)
    else:
        rx = 2.0 * (torch.abs(a1x) + torch.abs(a2x))
        ry = 2.0 * (torch.abs(a1y) + torch.abs(a2y))
    cx, cy = proj.center[:, 0], proj.center[:, 1]

    tw, th = config.tile_w, config.tile_h
    x0 = _to_int(torch.clamp(torch.floor(true_div(cx - rx, tw)), 0, tiles_x))
    x1 = _to_int(torch.clamp(torch.floor(true_div(cx + rx, tw)) + 1, 0, tiles_x))
    y0 = _to_int(torch.clamp(torch.floor(true_div(cy - ry, th)), 0, tiles_y))
    y1 = _to_int(torch.clamp(torch.floor(true_div(cy + ry, th)) + 1, 0, tiles_y))
    nx = torch.clamp(x1 - x0, min=0)
    ny = torch.clamp(y1 - y0, min=0)
    counts = torch.where(valid, nx * ny, 0)
    return x0, y0, nx, ny, counts, valid


def slot_demand(proj: ProjectedSplats, width: int, height: int, config) -> torch.Tensor:
    """Fused-pipeline slot demand: real AABB pairs plus one sentinel slot per
    dead or empty splat.  ``proj`` must already be ``quantize_view_fp16``-ed
    so the bounds see the opacity the pipeline sees."""
    *_, counts, _ = tile_rects(proj, width, height, config)
    return torch.sum(torch.clamp(counts, min=1), dtype=torch.int32)
