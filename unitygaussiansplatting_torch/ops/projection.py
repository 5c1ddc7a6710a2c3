"""Splat projection: world-space Gaussians -> screen-space view data.

The per-splat view calculation of the reference's ``CSCalcViewData``
(SplatUtilities.compute:189-252): world/view transform, kill mask, 3D
covariance -> EWA 2D covariance -> screen axes, SH shading.  Plain PyTorch,
pointwise over the splat axis.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch
from torch.profiler import record_function

from ..utils.config import RenderSettings
from .covariance import project_covariance_planar
from .sh import shade_sh

if TYPE_CHECKING:
    from ..models.camera import Camera
    from ..models.gaussians import Gaussians

OPACITY_CLAMP = 65000.0  # SplatUtilities.compute:246


class ProjectedSplats(NamedTuple):
    """Screen-space splat data, one entry per input splat."""

    depth: torch.Tensor  # (N,) view-space depth (> 0 in front of camera)
    center: torch.Tensor  # (N, 2) pixel coords of the splat center (y down)
    axis1: torch.Tensor  # (N, 2) major screen axis, pixels
    axis2: torch.Tensor  # (N, 2) minor screen axis, pixels
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c), pixel space
    color: torch.Tensor  # (N, 3) shaded RGB
    opacity: torch.Tensor  # (N,) scaled opacity
    valid: torch.Tensor  # (N,) bool: in front of camera and not killed


def affine(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``p @ m[:3, :3].T + m[:3, 3]`` written out per component.

    Three products and a sum per output, in index order: no matrix product,
    so neither TF32 nor a library's summation order moves pixel-scale values.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rows = [x * m[i, 0] + y * m[i, 1] + z * m[i, 2] + m[i, 3] for i in range(3)]
    return torch.stack(rows, dim=-1)


def project_splats(
    g: "Gaussians",
    camera: "Camera",
    settings: RenderSettings = RenderSettings(),
    model: torch.Tensor | None = None,
    kill_mask: torch.Tensor | None = None,
) -> ProjectedSplats:
    """Project a Gaussian cloud into screen space.

    ``model`` is an optional (4, 4) object->world matrix; the covariance
    pipeline then runs in object space with the model rotation folded into
    the model-view matrix (SplatUtilities.compute:236).  ``kill_mask`` (N,)
    True kills a splat (deleted bits / cutouts, compute:204-220).
    """
    view = camera.view
    if model is not None:
        mv = view @ model
        means_world = affine(g.means, model)
        inv_model_rot = torch.linalg.inv(model[:3, :3])
    else:
        mv = view
        means_world = g.means
        inv_model_rot = None

    view_pos = affine(g.means, mv)
    depth = view_pos[..., 2]
    valid = depth > 1e-8
    if kill_mask is not None:
        valid = valid & ~kill_mask

    center = camera.view_to_pixel(view_pos)
    splat_scale = torch.tensor(float(settings.splat_scale), dtype=torch.float32)
    splat_scale2 = splat_scale * splat_scale  # squared in float32, as JAX does
    axes, cov2d = project_covariance_planar(
        g.rotations, g.scales, splat_scale2, view_pos, mv[:3, :3],
        camera.focal, camera.tan_fovx, camera.tan_fovy,
    )
    cxx, cxy, cyy = cov2d.unbind(-1)
    det = cxx * cyy - cxy * cxy
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    with record_function("splat_sh"):
        # View-dependent color: direction camera->splat in object space.
        view_dir = means_world - camera.position
        if inv_model_rot is not None:
            view_dir = view_dir @ inv_model_rot.T
        view_dir = view_dir / torch.sqrt(
            torch.clamp(torch.sum(view_dir * view_dir, dim=-1, keepdim=True), min=1e-24)
        )
        color = shade_sh(
            g.base_color,
            g.sh if settings.sh_order > 0 else None,
            view_dir,
            settings.sh_order,
            settings.sh_only,
        )
        opacity = torch.clamp(g.opacities * float(settings.opacity_scale), max=OPACITY_CLAMP)
        if settings.fp16_color:
            color = color.to(torch.float16).to(torch.float32)
            opacity = opacity.to(torch.float16).to(torch.float32)

    return ProjectedSplats(
        depth=depth,
        center=center,
        axis1=axes.axis1,
        axis2=axes.axis2,
        conic=conic,
        color=color,
        opacity=opacity,
        valid=valid,
    )
