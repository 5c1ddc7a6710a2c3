"""Spherical-harmonics shading, degrees 0-3 (GaussianSplatting.hlsl:130-179).

``sh`` is (..., 15, 3): bands 1..3 interleaved RGB, or a tuple of three
planar (..., 15) channel tensors (what ``io.device_asset.decode_device``
gives with ``planar_sh=True``).  The DC term is carried separately as the
base color ``sh0 * SH_C0 + 0.5``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SH_C1 = 0.4886025
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (-0.5900436, 2.8906114, -0.4570458, 0.3731763, -0.4570458, 1.4453057, -0.5900436)

# Coefficient index ranges of bands 1..3 within the 15-coefficient layout.
BAND_SLICES = (slice(0, 3), slice(3, 8), slice(8, 15))


def shade_sh(
    base_color: torch.Tensor,
    sh: torch.Tensor | tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None,
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
    if isinstance(sh, tuple):
        return _shade_sh_planar(base_color, sh, view_dir, sh_order, only_sh)
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


def _shade_sh_planar(base_color, sh_cols, view_dir, sh_order: int, only_sh: bool) -> torch.Tensor:
    """:func:`shade_sh` on three planar (..., 15) channels, bit-identical to
    the interleaved path: the same formulas in the same order of terms, one
    stack at the end."""
    x, y, z = view_dir[..., 0], view_dir[..., 1], view_dir[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = []
    for ch in range(3):
        s = sh_cols[ch]
        res = torch.full_like(x, 0.5) if only_sh else base_color[..., ch]
        if sh_order >= 1:
            res = res + SH_C1 * (-s[..., 0] * y + s[..., 1] * z - s[..., 2] * x)
            if sh_order >= 2:
                res = res + (
                    (SH_C2[0] * xy) * s[..., 3]
                    + (SH_C2[1] * yz) * s[..., 4]
                    + (SH_C2[2] * (2 * zz - xx - yy)) * s[..., 5]
                    + (SH_C2[3] * xz) * s[..., 6]
                    + (SH_C2[4] * (xx - yy)) * s[..., 7]
                )
                if sh_order >= 3:
                    res = res + (
                        (SH_C3[0] * y * (3 * xx - yy)) * s[..., 8]
                        + (SH_C3[1] * xy * z) * s[..., 9]
                        + (SH_C3[2] * y * (4 * zz - xx - yy)) * s[..., 10]
                        + (SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)) * s[..., 11]
                        + (SH_C3[4] * x * (4 * zz - xx - yy)) * s[..., 12]
                        + (SH_C3[5] * z * (xx - yy)) * s[..., 13]
                        + (SH_C3[6] * x * (xx - 3 * yy)) * s[..., 14]
                    )
        out.append(res)
    return torch.clamp(torch.stack(out, dim=-1), min=0.0)


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


# Fixed, well-conditioned sample directions at which each band's rotation
# matrix is fitted (enough to invert each band's basis); the JAX package's
# ``ops/sh.py:_SAMPLE_DIRS``.
_SAMPLE_DIRS = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.0, 1.0],
        [0.0, 1.0, 1.0],
        [1.0, 1.0, 1.0],
        [1.0, -1.0, 0.0],
        [0.3, -0.8, 0.5],
        [-0.7, 0.2, 0.6],
        [0.9, 0.3, -0.4],
        [-0.2, -0.5, -0.8],
        [0.5, 0.9, -0.1],
        [-0.9, -0.3, 0.2],
        [0.1, 0.6, 0.9],
    ],
    dtype=np.float64,
)
_SAMPLE_DIRS /= np.linalg.norm(_SAMPLE_DIRS, axis=1, keepdims=True)


@functools.cache
def _band_pinv() -> tuple[np.ndarray, ...]:
    """Per band, the pseudo-inverse of its basis at the sample directions:
    the basis evaluated in float32 (as every shading call does), then the
    pinv in float64 on the host."""
    basis = sh_basis(torch.from_numpy(_SAMPLE_DIRS.astype(np.float32))).double().numpy()
    return tuple(np.linalg.pinv(basis[:, sl]) for sl in BAND_SLICES)


def rotate_sh(sh: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate SH coefficients (..., 15, 3) by a (3, 3) rotation matrix.

    The reference's RotateSH (SphericalHarmonics.hlsl:24-210, used by the
    export bake, SplatUtilities.compute:549-609), built by projection: per
    band, the matrix that makes shading the rotated coefficients at d equal
    shading the originals at R^-1 d, fitted at fixed sample directions.
    Exact for band-limited functions.  Runs on ``sh``'s device.
    """
    dev = sh.device
    dirs = torch.from_numpy(_SAMPLE_DIRS.astype(np.float32)).to(dev)
    # R^-1 d_i = R^T d_i = d_i @ R (rows are directions).
    basis_rot = sh_basis(dirs @ torch.as_tensor(rot, dtype=torch.float32).to(dev))  # (S, 15)
    out = []
    for pinv, sl in zip(_band_pinv(), BAND_SLICES):
        m = torch.from_numpy(pinv.astype(np.float32)).to(dev) @ basis_rot[:, sl]  # (2l+1, 2l+1)
        out.append(torch.einsum("mk,...kc->...mc", m, sh[..., sl, :]))
    return torch.cat(out, dim=-2)
