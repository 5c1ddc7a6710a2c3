"""Final compositing of the splat render target over a background.

The port of ``unitygaussiansplatting_tpu/ops/composite.py``: the reference's
fullscreen composite pass (package/Shaders/GaussianComposite.shader:35-39):
un-premultiply, optional gamma->linear conversion, then standard alpha blend
over the scene.
"""

from __future__ import annotations

import torch


def gamma_to_linear(c: torch.Tensor) -> torch.Tensor:
    """sRGB gamma -> linear, Unity's approximate polynomial form.

    Unity's GammaToLinearSpace (used by GaussianComposite.shader:38) uses the
    polynomial approximation rather than the exact piecewise sRGB curve.
    """
    return c * (c * (c * 0.305306011 + 0.682171111) + 0.012522878)


def linear_to_gamma(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma (Unity LinearToGammaSpace approximation)."""
    c = torch.clamp(c, min=0.0)
    return torch.clamp(1.055 * torch.pow(c, 0.416666667) - 0.055, min=0.0)


def composite_over(splat_rt: torch.Tensor, background, convert_gamma: bool = False) -> torch.Tensor:
    """Blend the premultiplied splat RGBA image over a background.

    Args:
      splat_rt: (H, W, 4) premultiplied output of the rasterizer.
      background: (H, W, 3) or (3,) background color, on any device.
      convert_gamma: apply the reference's gamma->linear conversion of the
        un-premultiplied splat color before blending (matches Unity's
        linear-space pipeline).  Off by default: a pure-linear renderer skips
        it.
    """
    rgb = splat_rt[..., :3]
    alpha = splat_rt[..., 3:4]
    if convert_gamma:
        straight = rgb / torch.clamp(alpha, min=1e-8)
        rgb = gamma_to_linear(straight) * alpha
    bg = torch.as_tensor(background, dtype=splat_rt.dtype).to(splat_rt.device)
    return rgb + (1.0 - alpha) * torch.broadcast_to(bg, splat_rt.shape[:-1] + (3,))
