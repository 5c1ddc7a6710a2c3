"""Quaternion helpers for splat orientation (GaussianUtils.cs:40-43).

Quaternions are stored ``(x, y, z, w)``, the reference's layout after
``NormalizeSwizzleRotation`` converts PLY's wxyz storage.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis.

    The norm is floored inside the sqrt, so a zero quaternion gives finite
    gradients.
    """
    norm = torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=eps * eps))
    return q / norm


def normalize_swizzle_rotation(wxyz: torch.Tensor) -> torch.Tensor:
    """PLY-order (w, x, y, z) -> normalized (x, y, z, w) (GaussianUtils.cs:40-43)."""
    q = quat_normalize(wxyz)
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)
