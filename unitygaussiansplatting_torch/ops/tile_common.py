"""View-data rounding shared by every rasterizer path, and the tile path's
chunk math.

``quantize_view_fp16`` puts projected color, opacity and (optionally) axes on
the lattice the pack flags of :class:`RasterizeConfig` name, so every backend
composites identical values and the expansion kernel's round trips are exact.
``chunk_alphas`` and ``composite_chunk`` fold a chunk of depth-ordered splats
into a tile: alphas of C splats at P pixels, the exclusive prefix product of
``1 - alpha`` along the chunk, the colors as one matrix product.
"""

from __future__ import annotations

import torch

from ..utils.config import RasterizeConfig

F16_MIN_NORMAL = 6.103515625e-05  # 2^-14


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor``, correctly rounded on every device.

    PyTorch's CUDA kernels divide by a Python (CPU) scalar as a multiply by
    its rounded reciprocal, an ulp off the quotient that the CPU, the JAX
    package and the CUDA kernels compute; a divisor on x's device keeps the
    true division (``torch.full`` fills it there, with no host copy).
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def _f16_round(x: torch.Tensor) -> torch.Tensor:
    """Round through f16, flushing f16-subnormals (|x| < 2^-14) to zero, so
    the value set is exactly {normal f16} and 0."""
    r = x.to(torch.float16).to(torch.float32)
    return torch.where(torch.abs(r) < F16_MIN_NORMAL, 0.0, r)


def _unorm8_round(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Round to the k/scale 8-bit lattice with straight-through gradients."""
    q = true_div(torch.round(torch.clamp(x, 0.0, 255.0 / scale) * scale), scale)
    return x + (q - x).detach()


# pack_axes_u32 lattice: the axis pair as (theta 12-bit, log2|a1| 10-bit,
# log2|a2| 10-bit).  decompose_covariance2d gives axis2 = |a2| * perp(a1_hat)
# with a fixed handedness, so one angle and two lengths rebuild both axes.
AX32_LO = -1.3219281  # log2(0.4), just under the sqrt(2 * MIN_LAMBDA) floor
AX32_STEP = (12.0 - AX32_LO) / 1023.0  # to log2(MAX_AXIS_LEN)
AX32_TWO_PI = 6.2831853071795864769
PI = 3.14159265358979324


def axes_u32_codes(axis1: torch.Tensor, axis2: torch.Tensor):
    """(theta, n1, n2) integer codes (float32-exact values) of the axis pair."""
    a1x, a1y = axis1[..., 0], axis1[..., 1]
    n1 = torch.sqrt(torch.clamp(a1x * a1x + a1y * a1y, min=1e-12))
    n2 = torch.sqrt(torch.clamp(torch.sum(axis2 * axis2, dim=-1), min=1e-12))
    theta = torch.atan2(a1y, a1x)  # [-pi, pi]
    tc = torch.round((theta + PI) * (4096.0 / AX32_TWO_PI))
    tc = torch.where(tc >= 4096.0, 0.0, tc)  # theta == +pi wraps to -pi

    def nc(n):
        return torch.clamp(
            torch.round(true_div(torch.log2(torch.clamp(n, 0.4, 4096.0)) - AX32_LO, AX32_STEP)),
            0.0, 1023.0,
        )

    def scrub(v):
        return torch.where(torch.isfinite(v), v, 0.0)

    return scrub(tc), scrub(nc(n1)), scrub(nc(n2))


def decode_axes_u32(tc: torch.Tensor, n1c: torch.Tensor, n2c: torch.Tensor):
    """Inverse of :func:`axes_u32_codes`; returns (a1x, a1y, a2x, a2y)."""
    theta = tc * (AX32_TWO_PI / 4096.0) - PI
    ct, st = torch.cos(theta), torch.sin(theta)
    n1 = torch.exp2(AX32_LO + n1c * AX32_STEP)
    n2 = torch.exp2(AX32_LO + n2c * AX32_STEP)
    return n1 * ct, n1 * st, n2 * st, -n2 * ct


def quantize_view_fp16(proj, config: RasterizeConfig):
    """Round projected color+opacity (and axes) onto the configured lattice.

    Mirrors the reference's packed SplatViewData (f32tof16 of color and
    opacity, SplatUtilities.compute:247-248); with ``pack_color_rgba8`` the
    lattice is RGBA8 instead, with ``pack_axes_u32`` / ``pack_axes_f16`` the
    axes are rounded too.  Idempotent.
    """
    if config.pack_color_rgba8:
        proj = proj._replace(
            color=_unorm8_round(proj.color, 127.5),
            opacity=_unorm8_round(proj.opacity, 255.0),
        )
    elif config.pack_color_f16:
        proj = proj._replace(color=_f16_round(proj.color), opacity=_f16_round(proj.opacity))
    if config.pack_axes_u32:
        tc, n1c, n2c = axes_u32_codes(proj.axis1, proj.axis2)
        a1x, a1y, a2x, a2y = decode_axes_u32(tc, n1c, n2c)
        a1 = torch.stack([a1x, a1y], dim=-1)
        a2 = torch.stack([a2x, a2y], dim=-1)
        proj = proj._replace(
            axis1=proj.axis1 + (a1 - proj.axis1).detach(),
            axis2=proj.axis2 + (a2 - proj.axis2).detach(),
        )
    elif config.pack_axes_f16:
        proj = proj._replace(axis1=_f16_round(proj.axis1), axis2=_f16_round(proj.axis2))
    return proj


def chunk_alphas(
    center: torch.Tensor,  # (..., C, 2)
    axis1: torch.Tensor,  # (..., C, 2)
    axis2: torch.Tensor,  # (..., C, 2)
    opacity: torch.Tensor,  # (..., C)
    px: torch.Tensor,  # (..., P) pixel-center x
    py: torch.Tensor,  # (..., P) pixel-center y
    config: RasterizeConfig,
) -> torch.Tensor:
    """Quad-clipped Gaussian alpha for C splats at P pixels; (..., C, P).

    The fragment shader's math (RenderGaussianSplats.shader:79-104) in the
    term order of K1 and ``rasterize_ref.splat_alpha_map``: the reciprocal
    multiply at per-splat scale, then the clip, the discard and the quad
    clip.  Leading dims batch tiles.
    """
    dx = px.unsqueeze(-2) - center[..., 0:1]  # (..., C, P)
    dy = py.unsqueeze(-2) - center[..., 1:2]
    a1_sq = torch.clamp(torch.sum(axis1 * axis1, dim=-1, keepdim=True), min=1e-12)
    a2_sq = torch.clamp(torch.sum(axis2 * axis2, dim=-1, keepdim=True), min=1e-12)
    qx = dx * (axis1[..., 0:1] / a1_sq) + dy * (axis1[..., 1:2] / a1_sq)
    qy = dx * (axis2[..., 0:1] / a2_sq) + dy * (axis2[..., 1:2] / a2_sq)
    alpha = torch.exp(-(qx * qx + qy * qy)) * opacity.unsqueeze(-1)
    alpha = torch.clamp(alpha, 0.0, config.alpha_max)
    keep = alpha >= config.alpha_discard
    if config.quad_clip:
        keep &= (torch.abs(qx) <= 2.0) & (torch.abs(qy) <= 2.0)
    return torch.where(keep, alpha, 0.0)


def composite_chunk(
    transmittance: torch.Tensor,  # (..., P) running per-pixel transmittance
    alphas: torch.Tensor,  # (..., C, P) chunk alphas, depth-ordered along C
    colors: torch.Tensor,  # (..., C, 3)
):
    """Fold one chunk into the running front-to-back composite.

    Returns ``(rgb (..., P, 3), alpha (..., P), new transmittance (..., P))``.
    Splat i weighs ``T_in * prod_{j<i}(1 - a_j) * a_i``: the exclusive prefix
    product is a cumprod along the chunk shifted by one, and the color sum
    one matrix product (TF32 stays off: ``utils.device.resolve_device``).
    """
    cum = torch.cumprod(1.0 - alphas, dim=-2)  # inclusive prefix
    excl = torch.cat([torch.ones_like(cum[..., :1, :]), cum[..., :-1, :]], dim=-2)
    w = excl * alphas * transmittance.unsqueeze(-2)  # (..., C, P)
    rgb = torch.matmul(w.transpose(-1, -2), colors)
    return rgb, torch.sum(w, dim=-2), transmittance * cum[..., -1, :]
