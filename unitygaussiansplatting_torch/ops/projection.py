"""Splat projection: world-space Gaussians -> screen-space view data.

The per-splat view calculation of the reference's ``CSCalcViewData``
(SplatUtilities.compute:189-252): world/view transform, kill mask, 3D
covariance -> EWA 2D covariance -> screen axes, SH shading.

Two paths compute the same values.  :func:`project_splats_plain` is plain
PyTorch, pointwise over the splat axis (``covariance.py``, ``sh.py``): the
CPU path, the autograd path (training, the densification statistic) and the
kernels' oracle.  On CUDA tensors that need no autograd graph,
:func:`project_splats` launches the two kernels of ``csrc/project.cu``
instead, ``project_geom`` and, inside the ``splat_sh`` range,
``project_sh``; they repeat the plain version's operations in its order and
equal it bit for bit on the card.
"""

from __future__ import annotations

import weakref
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..utils.config import RenderSettings
from . import cuda_build
from .covariance import CLAMP_FACTOR, project_covariance_planar
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


_MODELS: dict[int, tuple] = {}


def model_constants(model: torch.Tensor) -> tuple[torch.Tensor, tuple[float, float, float]]:
    """The inverse of a (4, 4) object->world matrix's rotation block, on the
    matrix's device, and the matrix's origin (its translation) as host floats.

    Both read back from the card (the inverse's error check, the origin
    itself).  So for a matrix on the card they are derived once and kept
    while the tensor lives and is not edited in place (its version
    counter): frames that reuse their objects' matrices wait for neither.
    A matrix on the host is derived anew at every call.
    """
    if model.device.type == "cpu":
        m = model.detach()
        return torch.linalg.inv(m[:3, :3]), tuple(m[:3, 3].tolist())
    key, stamp = id(model), (model.data_ptr(), model._version)
    kept = _MODELS.get(key)
    if kept is None or kept[0]() is not model or kept[1] != stamp:
        m = model.detach()
        kept = (weakref.ref(model, lambda _, k=key: _MODELS.pop(k, None)), stamp, torch.linalg.inv(m[:3, :3]),
                tuple(m[:3, 3].tolist()))
        _MODELS[key] = kept
    return kept[2], kept[3]


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

    CUDA tensors that need no autograd graph take the kernels of
    ``csrc/project.cu`` (:func:`project_splats_cuda`); everything else takes
    :func:`project_splats_plain`.
    """
    sh = g.sh if isinstance(g.sh, tuple) else (g.sh,)
    inputs = (g.means, g.rotations, g.scales, g.opacities, g.base_color, *sh, camera.view, model)
    if g.means.device.type == "cuda" and not needs_graph(*inputs):
        return project_splats_cuda(g, camera, settings, model, kill_mask)
    return project_splats_plain(g, camera, settings, model, kill_mask)


def needs_graph(*inputs: torch.Tensor | None) -> bool:
    """Whether autograd records an operation on ``inputs`` (None entries
    skipped): grad mode is on and one of them requires grad.  The
    projection and ``rasterize`` take their kernels' route only when not."""
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in inputs)


def project_splats_plain(
    g: "Gaussians",
    camera: "Camera",
    settings: RenderSettings = RenderSettings(),
    model: torch.Tensor | None = None,
    kill_mask: torch.Tensor | None = None,
) -> ProjectedSplats:
    """Plain PyTorch version of :func:`project_splats`, differentiable."""
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


def _sh_channels(sh, n: int, ncoef: int, device):
    """SH channel c's ``(data_ptr, splat stride, coefficient stride)`` for
    c = 0, 1, 2 (flattened), and whether the kernel may stage it: an
    interleaved (N, 15, 3) tensor, contiguous and 16-byte aligned."""
    if isinstance(sh, tuple):
        if len(sh) != 3:
            raise ValueError(f"planar SH must be three (N, K) channels, got {len(sh)}")
        cols = []
        for c, ch in enumerate(sh):
            if ch.dim() != 2 or ch.shape[1] < ncoef:
                raise ValueError(f"SH channel {c} must be (N, >= {ncoef}), got {tuple(ch.shape)}")
            cols += cuda_build.operand(ch, f"g.sh[{c}]", (n, ch.shape[1]), device)
        return cols, False
    if sh.dim() != 3 or sh.shape[1] < ncoef:
        raise ValueError(f"g.sh must be (N, >= {ncoef}, 3), got {tuple(sh.shape)}")
    ptr, s0, s1, s2 = cuda_build.operand(sh, "g.sh", (n, sh.shape[1], 3), device)
    cols = [v for c in range(3) for v in (ptr + 4 * c * s2, s0, s1)]
    return cols, sh.shape[1] == 15 and sh.is_contiguous() and ptr % 16 == 0


SH_COEFFS = (0, 3, 8, 15)  # band 1..sh_order coefficients read
SH_ONLY, FP16_COLOR, SH_STAGED, HAS_MODEL = 1, 2, 4, 8  # csrc/project.cu's flags


def project_splats_cuda(
    g: "Gaussians",
    camera: "Camera",
    settings: RenderSettings = RenderSettings(),
    model: torch.Tensor | None = None,
    kill_mask: torch.Tensor | None = None,
) -> ProjectedSplats:
    """:func:`project_splats_plain`'s values from the two kernels of
    ``csrc/project.cu``, without an autograd graph.

    ``project_geom`` writes depth, center, axes and conic as the rows of one
    (10, N) buffer and the valid bytes; ``project_sh``, inside the
    ``splat_sh`` range, writes color and opacity as the rows of a (4, N)
    buffer.  The fields are views of those rows (``center`` is
    ``buf[1:3].T``), which every consumer reads at their strides.  The view,
    model-view and inverse model rotation stay on the device: the kernels
    read them there, so nothing waits for the host.
    """
    dev = g.means.device
    n = g.means.shape[0]
    if not 0 <= settings.sh_order <= 3:
        raise ValueError(f"sh_order must be in [0, 3], got {settings.sh_order}")
    if settings.sh_order > 0 and g.sh is None:
        raise ValueError("sh_order > 0 needs SH coefficients")
    if n >= 2**31:
        raise ValueError(f"project_splats_cuda takes fewer than 2^31 splats, got {n}")
    op = cuda_build.operand
    means = op(g.means, "g.means", (n, 3), dev)
    view = camera.view
    op(view, "camera.view", (4, 4), dev)
    if model is not None:
        op(model, "model", (4, 4), dev)
        mv = view @ model
        inv_rot = model_constants(model)[0]
    else:
        mv, inv_rot = view, None
    kill = (None, 0) if kill_mask is None else op(kill_mask, "kill_mask", (n,), dev, torch.bool)
    splat_scale = np.float32(settings.splat_scale)
    splat_scale2 = float(splat_scale * splat_scale)  # squared in float32, as the plain version does

    geo = torch.empty((10, n), dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    cuda_build.launch(
        "project", "project_geom_launch", dev,
        *means, *op(g.rotations, "g.rotations", (n, 4), dev), *op(g.scales, "g.scales", (n, 3), dev),
        mv.data_ptr(), *mv.stride(), *kill, n, camera.tan_fovx, camera.tan_fovy,
        CLAMP_FACTOR * camera.tan_fovx, CLAMP_FACTOR * camera.tan_fovy, camera.focal, -camera.focal,
        float(camera.width), float(camera.height), splat_scale2, geo.data_ptr(), valid.data_ptr(),
    )

    with record_function("splat_sh"):
        flags = SH_ONLY * settings.sh_only | FP16_COLOR * settings.fp16_color
        if settings.sh_order > 0:
            sh, staged = _sh_channels(g.sh, n, SH_COEFFS[settings.sh_order], dev)
            flags |= SH_STAGED * staged
        else:
            sh = [None, 0, 0] * 3
        if model is not None:
            model_args = (model.data_ptr(), *model.stride(), inv_rot.data_ptr(), *inv_rot.stride())
            flags |= HAS_MODEL
        else:
            model_args = (None, 0, 0, None, 0, 0)
        position = camera.position
        shaded = torch.empty((4, n), dtype=torch.float32, device=dev)
        cuda_build.launch(
            "project", "project_sh_launch", dev,
            *means, *op(g.base_color, "g.base_color", (n, 3), dev), *op(g.opacities, "g.opacities", (n,), dev),
            *sh, position.data_ptr(), *position.stride(),
            *model_args, n, settings.sh_order, flags, float(settings.opacity_scale), shaded.data_ptr(),
        )
    return ProjectedSplats(
        depth=geo[0], center=geo[1:3].T, axis1=geo[3:5].T, axis2=geo[5:7].T, conic=geo[7:10].T,
        color=shaded[:3].T, opacity=shaded[3], valid=valid,
    )
