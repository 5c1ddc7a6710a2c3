"""Scalar activation functions shared between import and render.

Elementwise and differentiable (GaussianUtils.cs:9-38).
"""

from __future__ import annotations

import torch

SH_C0 = 0.2820948  # GaussianUtils.cs:16


def sigmoid(v: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid (GaussianUtils.cs:9-12); raw PLY opacity -> [0, 1]."""
    return 1.0 / (1.0 + torch.exp(-v))


def inv_sigmoid(v: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Logit; used by PLY export (SplatUtilities.compute:541-544)."""
    v = torch.clamp(v, eps, 1.0 - eps)
    return torch.log(v / (1.0 - v))


def sh0_to_color(dc0: torch.Tensor) -> torch.Tensor:
    """DC spherical-harmonic coefficient -> base color (GaussianUtils.cs:14-18)."""
    return dc0 * SH_C0 + 0.5


def color_to_sh0(col: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`sh0_to_color`."""
    return (col - 0.5) / SH_C0


def linear_scale(log_scale: torch.Tensor) -> torch.Tensor:
    """Raw PLY log-scale -> linear scale (GaussianUtils.cs:20-23)."""
    return torch.abs(torch.exp(log_scale))
