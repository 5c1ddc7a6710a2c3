"""Screen-tile binning: grid, pair budget, depth keys, tile rects, and the
tile path's depth-major binning (:func:`bin_splats`).

The tile-binned formulation of the official 3DGS rasterizer with a static
(splat, tile) pair budget.  Compositing order framework-wide is the quantized
view depth (top ``db`` bits of the positive float32 depth), ties broken by
splat id; the fused pipeline fuses it with the tile id into one 32-bit key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.config import RasterizeConfig
from .projection import ProjectedSplats
from .tile_common import quantize_view_fp16, true_div


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TileBinning(NamedTuple):
    """Tile-sorted (splat, tile) pairs plus per-tile ranges.

    Two producers share the type.  :func:`bin_splats` (the tile path)
    generates pairs depth-major: ``pair_rank`` holds depth ranks, an index
    into ``depth_order``, and ``rank_counts`` the pairs of each rank.  The
    fused pipeline (``pair_expand.bin_and_prepare``) generates them
    splat-major: ``pair_rank`` holds splat ids (``depth_order`` None, the
    identity), K1's input on a frame's record route (sorted pair ``j``
    reads its fields from record ``pair_rank[j]``), and ``perm``/``bounds``
    carry what its backward reads.  On that record route (``perm`` None) a
    CUDA sort writes ``pair_rank`` and ``pair_tile`` on ``[0,
    tile_starts[T])``, the pairs of real tiles, only: entries past it are
    left unwritten.  Other consumers go through :attr:`pair_splat`.
    """

    pair_rank: torch.Tensor  # (K,) int32 index into depth_order (n = sentinel); fused: K1 reads records by it
    pair_tile: torch.Tensor  # (K,) int32 tile id per pair (num_tiles = sentinel)
    tile_starts: torch.Tensor  # (T + 1,) int32: pairs of tile t are [s[t], s[t+1])
    num_pairs: torch.Tensor  # () int32 demand before budget clipping
    depth_order: torch.Tensor | None = None  # (N,) int32 depth rank -> splat id; None: identity
    rank_counts: torch.Tensor | None = None  # (N,) int32 pairs generated per depth rank
    perm: torch.Tensor | None = None  # (K,) int64 slot of each sorted pair (fused, per-slot fields only)
    bounds: torch.Tensor | None = None  # (N + 1,) int32: slots of splat i are [b[i], b[i+1]) (fused)

    @property
    def pair_splat(self) -> torch.Tensor:
        """(K,) splat id per pair (n = sentinel)."""
        if self.depth_order is None:
            return self.pair_rank
        n = self.depth_order.shape[0]
        order_ext = torch.cat([self.depth_order, self.depth_order.new_full((1,), n)])
        return order_ext[self.pair_rank.long()]


def pair_budget(num_splats: int, config: RasterizeConfig) -> int:
    """Static (splat, tile) pair capacity for a given splat count."""
    k = int(num_splats * config.pair_multiplier)
    return max(cdiv(k, 1024) * 1024, 1024)


def tile_grid(width: int, height: int, config: RasterizeConfig) -> tuple[int, int]:
    return cdiv(width, config.tile_w), cdiv(height, config.tile_h)


def depth_key_bits(num_tiles: int, config: RasterizeConfig | None = None) -> int:
    """Bits of quantized depth left in a fused (tile | depth) 32-bit key, at
    most 24; ``config.depth_bits`` instead when set (a strip of a frame keeps
    the frame's bits, and so its compositing order)."""
    tile_vals = num_tiles + 2  # + sentinel tile, exclusive bound
    tb = max(int(tile_vals - 1).bit_length(), 1)
    db = 32 - tb
    if db < 12:
        raise ValueError(f"tile grid too large for fused sort key: {num_tiles} tiles")
    if config is not None and config.depth_bits is not None:
        if not 12 <= config.depth_bits <= min(db, 24):
            raise ValueError(f"depth_bits={config.depth_bits} outside 12..{min(db, 24)} for {num_tiles} tiles")
        return config.depth_bits
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


# The packed rect word: x0 in bits 0-10, y0 in 11-21, nx in 22-30, the depth
# rank's parity in bit 31.
RECT_MAX_TILES_X = 511
RECT_MAX_TILES_Y = 2047


def bin_splats(
    proj: ProjectedSplats, width: int, height: int, config: RasterizeConfig = RasterizeConfig()
) -> TileBinning:
    """Bin projected splats into depth-ordered per-tile pair lists (the tile path).

    Splats are sorted by the framework-wide quantized depth key (ties by
    index), each is expanded into the tiles of its rect in depth order into a
    static budget of K pairs, and the pairs are stably sorted by tile, which
    keeps each tile's pairs in depth order.  Over budget the *deepest*
    splats lose their pairs first (depth-major truncation).  Dead and
    pair-less splats sink to the end of the depth order.

    To render a viewport (a strip of a frame), shift ``proj.center`` by its
    origin and bin at its size: the pipeline is translation-covariant.
    """
    n = proj.depth.shape[0]
    dev = proj.depth.device
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    k = pair_budget(n, config)

    proj = quantize_view_fp16(proj, config)  # the bounds see the rounded opacity
    x0, y0, nx, ny, counts, valid = tile_rects(proj, width, height, config)
    if tiles_x > RECT_MAX_TILES_X or tiles_y > RECT_MAX_TILES_Y:
        raise ValueError(
            f"tile grid {tiles_x}x{tiles_y} exceeds the packed-rect limits "
            "(x0/y0: 11 bits, nx: 9 bits + parity bit)"
        )
    # The rect travels to the pair slots in one word; the rank's parity bit
    # keeps adjacent runs distinct when two consecutive splats share a rect,
    # so run starts (hence rank and within-run index) are value changes.
    # nx >= 1 for every emitted splat: the all-zero word is the sentinel.
    rect_packed = x0 | (y0 << 11) | (torch.clamp(nx, min=1) << 22)

    db = depth_key_bits(num_tiles, config)
    dq = quantize_depth(proj.depth, db).to(torch.int64)
    sort_key = torch.where(valid & (counts > 0), dq, 0xFFFFFFFF)
    order = torch.sort(sort_key, stable=True).indices
    counts_s = counts[order]
    rect_s = rect_packed[order]
    num_pairs = torch.sum(counts_s, dtype=torch.int32)

    # Expand the rect words to K slots; a sentinel row of count K absorbs the
    # slots past num_pairs.  Each row keeps what fits under K (the JAX
    # package's repeat(total_repeat_length=K)), so over budget the deepest
    # ranks lose their pairs.
    odd = (torch.arange(n, device=dev) & 1).bool()
    parity = torch.where(odd, torch.iinfo(torch.int32).min, 0).to(torch.int32)
    vals = torch.cat([rect_s | parity, rect_s.new_zeros(1)])
    counts_ext = torch.cat([counts_s.to(torch.int64), counts_s.new_full((1,), k, dtype=torch.int64)])
    ends = torch.cumsum(counts_ext, 0)
    kept = torch.clamp(ends, max=k) - torch.clamp(ends - counts_ext, max=k)
    rect_k = torch.repeat_interleave(vals, kept, output_size=k)

    # Within-run index j by a cummax over run starts, depth rank by a cumsum.
    iota_k = torch.arange(k, dtype=torch.int32, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), rect_k[1:] != rect_k[:-1]])
    j = iota_k - torch.cummax(torch.where(is_start, iota_k, 0), 0).values
    slot_rank = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    is_real = rect_k != 0
    slot_rank = torch.where(is_real, slot_rank, n)
    snx = torch.clamp((rect_k >> 22) & 0x1FF, min=1)  # the sentinel word has nx = 0
    q = torch.div(j, snx, rounding_mode="floor")  # the JAX package's reciprocal trick, exactly
    rem = j - q * snx
    tx = (rect_k & 0x7FF) + rem
    ty = ((rect_k >> 11) & 0x7FF) + q
    tile_id = torch.where(is_real, ty * tiles_x + tx, num_tiles).to(torch.int32)

    pair_tile, by_tile = torch.sort(tile_id, stable=True)
    pair_rank = slot_rank[by_tile]
    tile_starts = torch.searchsorted(
        pair_tile, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev), right=False
    ).to(torch.int32)
    return TileBinning(
        pair_rank=pair_rank,
        pair_tile=pair_tile,
        tile_starts=tile_starts,
        num_pairs=num_pairs,
        depth_order=order.to(torch.int32),
        rank_counts=counts_s,
    )
