"""Spherical-harmonics shading, degrees 0-3 (GaussianSplatting.hlsl:130-179).

``sh`` is (..., 15, 3): bands 1..3 interleaved RGB.  The DC term is carried
separately as the base color ``sh0 * SH_C0 + 0.5``.
"""

from __future__ import annotations

import torch

SH_C1 = 0.4886025
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (-0.5900436, 2.8906114, -0.4570458, 0.3731763, -0.4570458, 1.4453057, -0.5900436)


def shade_sh(
    base_color: torch.Tensor,
    sh: torch.Tensor | None,
    view_dir: torch.Tensor,
    sh_order: int,
    only_sh: bool = False,
) -> torch.Tensor:
    """View-dependent color from SH coefficients, clamped to >= 0 (hlsl:178).

    ``view_dir`` is the normalized splat-minus-camera direction in object
    space; ``only_sh`` replaces the DC term with 0.5 (hlsl:146-148).
    """
    if not 0 <= sh_order <= 3:
        raise ValueError(f"sh_order must be in [0, 3], got {sh_order}")
    res = torch.full_like(base_color, 0.5) if only_sh else base_color
    if sh_order >= 1:
        if sh is None:
            raise ValueError("sh_order > 0 needs SH coefficients")
        x = view_dir[..., 0:1]
        y = view_dir[..., 1:2]
        z = view_dir[..., 2:3]
        res = res + SH_C1 * (-sh[..., 0, :] * y + sh[..., 1, :] * z - sh[..., 2, :] * x)
        if sh_order >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            res = res + (
                (SH_C2[0] * xy) * sh[..., 3, :]
                + (SH_C2[1] * yz) * sh[..., 4, :]
                + (SH_C2[2] * (2 * zz - xx - yy)) * sh[..., 5, :]
                + (SH_C2[3] * xz) * sh[..., 6, :]
                + (SH_C2[4] * (xx - yy)) * sh[..., 7, :]
            )
            if sh_order >= 3:
                res = res + (
                    (SH_C3[0] * y * (3 * xx - yy)) * sh[..., 8, :]
                    + (SH_C3[1] * xy * z) * sh[..., 9, :]
                    + (SH_C3[2] * y * (4 * zz - xx - yy)) * sh[..., 10, :]
                    + (SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)) * sh[..., 11, :]
                    + (SH_C3[4] * x * (4 * zz - xx - yy)) * sh[..., 12, :]
                    + (SH_C3[5] * z * (xx - yy)) * sh[..., 13, :]
                    + (SH_C3[6] * x * (xx - 3 * yy)) * sh[..., 14, :]
                )
    return torch.clamp(res, min=0.0)


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """The 15 band-1..3 basis functions at directions ``d``; (..., 15).

    ``shade_sh(base, sh, d, 3) == base + sum_k basis_k(d) * sh_k`` before the
    clamp.
    """
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack(
        [
            -SH_C1 * y,
            SH_C1 * z,
            -SH_C1 * x,
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
            SH_C3[0] * y * (3 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4 * zz - xx - yy),
            SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            SH_C3[4] * x * (4 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3 * yy),
        ],
        dim=-1,
    )
