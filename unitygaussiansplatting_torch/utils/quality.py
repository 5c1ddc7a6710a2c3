"""Quality probes for the lossy pack knobs.

The pack knobs of :class:`utils.config.RasterizeConfig` trade image quality
for sort operands; their caveats depend on the scene (``pack_color_rgba8``
hard-saturates shaded rgb at 2.0 where the reference's f16 SplatViewData
keeps highlights, SplatUtilities.compute:247-248).  These helpers measure a
scene and camera's exposure to each caveat, so a knob is turned on from
evidence.
"""

from __future__ import annotations

import torch

from ..models.camera import Camera
from ..ops.projection import project_splats
from ..utils.config import RenderSettings
from ..utils.device import resolve_device


def rgba8_clip_fraction(gaussians, camera: Camera, settings: RenderSettings = RenderSettings(), device=None) -> dict:
    """Fraction of on-screen shaded color values outside rgba8's [0, 2].

    Returns ``{"clipped_high": f, "clipped_low": f, "max_color": f}`` over
    the valid (on-screen) splats' SH-shaded rgb.  ``clipped_low`` counts
    values below 0 for completeness: SH shading already clamps at 0
    (GaussianSplatting.hlsl ``max(res, 0)``), so it is 0 unless shading
    changes.  A ``clipped_high`` above ~1e-3 means ``pack_color_rgba8`` will
    visibly flatten highlights on this scene; keep the f16 path there.  Runs
    on ``device`` (CUDA unless told otherwise); the three numbers are one
    host read.
    """
    dev = resolve_device(device)
    with torch.no_grad():
        proj = project_splats(gaussians.to(dev), camera.to(dev), settings)
        valid = proj.valid[:, None]
        total = torch.clamp(torch.sum(torch.where(proj.valid, 1.0, 0.0)) * 3.0, min=1.0)
        hi = torch.sum(torch.where(valid & (proj.color > 2.0), 1.0, 0.0)) / total
        lo = torch.sum(torch.where(valid & (proj.color < 0.0), 1.0, 0.0)) / total
        mx = torch.max(torch.where(valid, proj.color, -torch.inf))
        hi, lo, mx = torch.stack([hi, lo, mx]).tolist()
    return {"clipped_high": hi, "clipped_low": lo, "max_color": mx}
