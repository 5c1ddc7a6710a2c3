"""Reference rasterizer: exact, slow, differentiable; the test oracle.

The reference's draw semantics (RenderGaussianSplats.shader:35-108, blend
OneMinusDstAlpha/One): one global order by quantized depth key then splat
index, and front-to-back "under" compositing of every splat over the whole
image.  O(N * H * W): small scenes only.
"""

from __future__ import annotations

import torch

from ..utils.config import RasterizeConfig
from .binning import depth_key_bits, quantize_depth, tile_grid
from .projection import ProjectedSplats
from .tile_common import quantize_view_fp16


def _pixel_centers(width: int, height: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) pixel-center x and y."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device) + 0.5,
        torch.arange(width, dtype=torch.float32, device=device) + 0.5,
        indexing="ij",
    )
    return xs, ys


def splat_alpha_map(
    center: torch.Tensor,  # (2,)
    axis1: torch.Tensor,  # (2,)
    axis2: torch.Tensor,  # (2,)
    opacity: torch.Tensor,  # ()
    px: torch.Tensor,
    py: torch.Tensor,
    config: RasterizeConfig,
) -> torch.Tensor:
    """Alpha of one splat at every pixel center, shaped like ``px``.

    The quad-clipped Gaussian of the fragment shader
    (RenderGaussianSplats.shader:79-104), term for term as
    ``tile_common.chunk_alphas`` and K1.
    """
    a1_sq = torch.clamp(axis1[0] * axis1[0] + axis1[1] * axis1[1], min=1e-12)
    a2_sq = torch.clamp(axis2[0] * axis2[0] + axis2[1] * axis2[1], min=1e-12)
    dx, dy = px - center[0], py - center[1]
    qx = dx * (axis1[0] / a1_sq) + dy * (axis1[1] / a1_sq)
    qy = dx * (axis2[0] / a2_sq) + dy * (axis2[1] / a2_sq)
    alpha = torch.clamp(torch.exp(-(qx * qx + qy * qy)) * opacity, 0.0, config.alpha_max)
    keep = alpha >= config.alpha_discard
    if config.quad_clip:
        keep &= (torch.abs(qx) <= 2.0) & (torch.abs(qy) <= 2.0)
    return torch.where(keep, alpha, 0.0)


def rasterize_reference(
    proj: ProjectedSplats, width: int, height: int, config: RasterizeConfig = RasterizeConfig()
) -> torch.Tensor:
    """Composite all splats front-to-back; (H, W, 4) premultiplied RGBA."""
    proj = quantize_view_fp16(proj, config)
    dev = proj.depth.device
    xs, ys = _pixel_centers(width, height, dev)
    tiles_x, tiles_y = tile_grid(width, height, config)
    dq = quantize_depth(proj.depth, depth_key_bits(tiles_x * tiles_y, config)).to(torch.int64)
    order = torch.argsort(torch.where(proj.valid, dq, 0xFFFFFFFF), stable=True)
    opac = torch.where(proj.valid, proj.opacity, 0.0)

    accum = torch.zeros((height, width, 4), dtype=torch.float32, device=dev)
    trans = torch.ones((height, width), dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    for i in order.tolist():
        alpha = splat_alpha_map(proj.center[i], proj.axis1[i], proj.axis2[i], opac[i], xs, ys, config)
        accum = accum + (trans * alpha)[..., None] * torch.cat([proj.color[i], one])
        trans = trans * (1.0 - alpha)
    return accum
