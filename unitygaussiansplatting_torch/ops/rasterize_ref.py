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


def rasterize_reference(
    proj: ProjectedSplats, width: int, height: int, config: RasterizeConfig = RasterizeConfig()
) -> torch.Tensor:
    """Composite all splats front-to-back; (H, W, 4) premultiplied RGBA."""
    proj = quantize_view_fp16(proj, config)
    dev = proj.depth.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    tiles_x, tiles_y = tile_grid(width, height, config)
    dq = quantize_depth(proj.depth, depth_key_bits(tiles_x * tiles_y)).to(torch.int64)
    order = torch.argsort(torch.where(proj.valid, dq, 0xFFFFFFFF), stable=True)
    opac = torch.where(proj.valid, proj.opacity, 0.0)

    accum = torch.zeros((height, width, 4), dtype=torch.float32, device=dev)
    trans = torch.ones((height, width), dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    for i in order.tolist():
        a1, a2, c = proj.axis1[i], proj.axis2[i], proj.center[i]
        a1_sq = torch.clamp(a1[0] * a1[0] + a1[1] * a1[1], min=1e-12)
        a2_sq = torch.clamp(a2[0] * a2[0] + a2[1] * a2[1], min=1e-12)
        dx, dy = xs - c[0], ys - c[1]
        qx = dx * (a1[0] / a1_sq) + dy * (a1[1] / a1_sq)
        qy = dx * (a2[0] / a2_sq) + dy * (a2[1] / a2_sq)
        alpha = torch.clamp(torch.exp(-(qx * qx + qy * qy)) * opac[i], 0.0, config.alpha_max)
        keep = alpha >= config.alpha_discard
        if config.quad_clip:
            keep &= (torch.abs(qx) <= 2.0) & (torch.abs(qy) <= 2.0)
        alpha = torch.where(keep, alpha, 0.0)
        accum = accum + (trans * alpha)[..., None] * torch.cat([proj.color[i], one])
        trans = trans * (1.0 - alpha)
    return accum
