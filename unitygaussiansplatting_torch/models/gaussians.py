"""Gaussian splat cloud data model (struct of tensors).

The activated form mirrors the decoded ``SplatData`` a shader sees
(GaussianSplatting.hlsl:209-216); the raw form mirrors the float struct of
file import before activations (GaussianFileReader.cs:17-26).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import activations
from ..ops.quaternion import normalize_swizzle_rotation, quat_normalize


def _move(value, device):
    if isinstance(value, tuple):  # planar SH channels
        return tuple(v.to(device) for v in value)
    return value.to(device)


def _to(obj, device):
    """Copy of a tensor dataclass with every field on ``device``."""
    return dataclasses.replace(
        obj, **{f.name: _move(getattr(obj, f.name), device) for f in dataclasses.fields(obj)}
    )


@dataclasses.dataclass
class Gaussians:
    """Activated splat cloud (what the renderer consumes).

    means (N, 3) world positions; rotations (N, 4) normalized xyzw; scales
    (N, 3) linear; opacities (N,) in [0, 1]; base_color (N, 3) =
    ``sh0 * SH_C0 + 0.5``; sh (N, 15, 3) band 1..3 coefficients, or three
    planar (N, 15) channels (``ops.sh.shade_sh`` takes either).
    """

    means: torch.Tensor
    rotations: torch.Tensor
    scales: torch.Tensor
    opacities: torch.Tensor
    base_color: torch.Tensor
    sh: torch.Tensor | tuple[torch.Tensor, torch.Tensor, torch.Tensor]

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    def to(self, device) -> "Gaussians":
        return _to(self, device)


@dataclasses.dataclass
class RawGaussians:
    """Pre-activation splat parameters (3DGS PLY layout, GaussianFileReader.cs:210-240).

    means (N, 3); rotations_wxyz (N, 4) unnormalized; log_scales (N, 3);
    opacity_logits (N,); sh0 (N, 3) raw DC coefficients; sh (N, 15, 3).
    """

    means: torch.Tensor
    rotations_wxyz: torch.Tensor
    log_scales: torch.Tensor
    opacity_logits: torch.Tensor
    sh0: torch.Tensor
    sh: torch.Tensor

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    def to(self, device) -> "RawGaussians":
        return _to(self, device)

    def activate(self) -> Gaussians:
        """Apply the import-time activations (GaussianFileReader.cs:210-240)."""
        return Gaussians(
            means=self.means,
            rotations=normalize_swizzle_rotation(self.rotations_wxyz),
            scales=activations.linear_scale(self.log_scales),
            opacities=activations.sigmoid(self.opacity_logits),
            base_color=activations.sh0_to_color(self.sh0),
            sh=self.sh,
        )


def deactivate(g: Gaussians) -> RawGaussians:
    """Inverse of :meth:`RawGaussians.activate`, used by PLY export.

    Mirrors the export kernel's inverse activations
    (SplatUtilities.compute:616-673: InvSigmoid, log scale, color -> SH0).
    """
    q = quat_normalize(g.rotations)
    wxyz = torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)
    return RawGaussians(
        means=g.means,
        rotations_wxyz=wxyz,
        log_scales=torch.log(torch.clamp(g.scales, min=1e-37)),
        opacity_logits=activations.inv_sigmoid(g.opacities),
        sh0=activations.color_to_sh0(g.base_color),
        sh=g.sh,
    )
