"""Render orchestration: project -> bin (K2 + sort) -> composite (K1).

Backends with identical semantics:

- ``backend="cuda"`` (default): the fused tile pipeline; on a CUDA device the
  hand-written kernels, on the CPU their plain PyTorch versions.  Forward only
  in this release.
- ``backend="reference"``: the O(N*H*W) oracle (small scenes).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ..ops.binning import pair_budget, slot_demand, tile_rects
from ..ops.projection import project_splats
from ..ops.rasterize_cuda import rasterize
from ..ops.rasterize_ref import rasterize_reference
from ..ops.tile_common import quantize_view_fp16
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device
from .camera import Camera
from .gaussians import Gaussians


class RenderStats(NamedTuple):
    """Per-frame counters beside the image.

    ``num_pairs`` is the true (splat, tile) slot demand; above ``budget``
    pairs were dropped splat-major and the frame is missing content: raise
    ``config.pair_multiplier``.
    """

    num_pairs: torch.Tensor  # () int32 slot demand this frame
    budget: int  # static pair capacity
    overflowed: torch.Tensor  # () bool: num_pairs > budget
    visible: torch.Tensor | None = None  # (N,) bool, when want_visibility


def check_overflow(stats: RenderStats, action: str = "warn") -> bool:
    """Host-side overflow check: warn or raise if the frame dropped pairs."""
    over = bool(stats.overflowed)
    if over:
        msg = (
            f"pair budget overflow: frame needed {int(stats.num_pairs)} (splat, tile) "
            f"pairs but the static budget is {stats.budget}; pairs were dropped "
            "splat-id-major. Raise config.pair_multiplier."
        )
        if action == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, stacklevel=2)
    return over


def suggest_pair_multiplier(
    gaussians: Gaussians,
    cameras,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    slack: float = 1.2,
    device=None,
) -> tuple[float, int]:
    """Worst slot demand over ``cameras`` and a multiplier covering it times
    ``slack``: ``(multiplier, max_demand)``.  One N-sized pass per camera
    (projection + tile rects), with the pipeline's own accounting."""
    if isinstance(cameras, Camera):
        cameras = [cameras]
    if not cameras:
        raise ValueError("suggest_pair_multiplier needs at least one camera")
    dev = resolve_device(device)
    g = gaussians.to(dev)
    worst = 0
    with torch.no_grad():
        for cam in cameras:
            proj = quantize_view_fp16(project_splats(g, cam.to(dev), settings), config)
            worst = max(worst, int(slot_demand(proj, cam.width, cam.height, config)))
    return (worst * slack) / max(g.num_splats, 1), worst


def render(
    gaussians: Gaussians,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    model: torch.Tensor | None = None,
    kill_mask: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Render a splat cloud; (H, W, 4) premultiplied linear RGBA, alpha =
    coverage (1 - final transmittance).  Runs on ``device`` (CUDA unless told
    otherwise; raises when no GPU is present and no device is given)."""
    img, _ = render_with_stats(
        gaussians, camera, settings, config, backend, model=model, kill_mask=kill_mask,
        device=device,
    )
    return img


def render_with_stats(
    gaussians: Gaussians,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    model: torch.Tensor | None = None,
    kill_mask: torch.Tensor | None = None,
    want_visibility: bool = False,
    device=None,
) -> tuple[torch.Tensor, RenderStats]:
    """Like :func:`render` but also returns :class:`RenderStats`.

    ``want_visibility`` fills ``RenderStats.visible`` with the per-splat
    "non-empty on-screen tile rect" mask (the 3DGS ``radii > 0`` filter).
    """
    if backend not in ("cuda", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    g = gaussians.to(dev)
    camera = camera.to(dev)
    if model is not None:
        model = model.to(dev)
    if kill_mask is not None:
        kill_mask = kill_mask.to(dev)
    proj = project_splats(g, camera, settings, model=model, kill_mask=kill_mask)
    w, h = camera.width, camera.height

    visible = None
    if want_visibility:
        *_, counts, valid = tile_rects(quantize_view_fp16(proj, config), w, h, config)
        visible = valid & (counts > 0)
    if backend == "reference":
        img = rasterize_reference(proj, w, h, config)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return img, RenderStats(zero, 0, zero < 0, visible)
    budget = pair_budget(proj.depth.shape[0], config)
    img, num_pairs = rasterize(proj, w, h, config)
    return img, RenderStats(num_pairs, budget, num_pairs > budget, visible)
