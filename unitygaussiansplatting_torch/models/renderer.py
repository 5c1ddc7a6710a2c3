"""Render orchestration: project -> bin (K2 + sort) -> composite (K1).

Backends with identical semantics:

- ``backend="cuda"`` (default): the fused tile pipeline; on a CUDA device the
  hand-written kernels, on the CPU their plain PyTorch versions.  Its
  backward is the hand-written one (K3 + K4).
- ``backend="torch"``: the tile path in plain PyTorch (the JAX package's
  ``"jax"`` backend, its default): depth-major binning and chunked
  compositing, differentiated by autograd.  Memory grows with the frame:
  test-sized images, or frames without a gradient.
- ``backend="reference"``: the O(N*H*W) oracle (small scenes), differentiated
  by autograd.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..ops import composite as composite_ops
from ..ops.binning import bin_splats, pair_budget, slot_demand, tile_rects
from ..ops.projection import project_splats
from ..ops.rasterize_cuda import rasterize
from ..ops.rasterize_ref import rasterize_reference
from ..ops.rasterize_tiles import rasterize_tiles_torch
from ..ops.tile_common import quantize_view_fp16
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device
from .camera import Camera
from .gaussians import Gaussians


class RenderStats(NamedTuple):
    """Per-frame counters beside the image.

    ``num_pairs`` is the true (splat, tile) pair demand (with ``"cuda"``
    also one sentinel slot per dead splat); above ``budget`` pairs were
    dropped and the frame is missing content (depth-major on the ``"torch"``
    backend, splat-id-major on ``"cuda"``): raise ``config.pair_multiplier``.
    """

    num_pairs: torch.Tensor  # () int32 pair demand this frame
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
            "(depth-major on the torch backend, splat-id-major on the cuda backend). "
            "Raise config.pair_multiplier."
        )
        if action == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, stacklevel=2)
    return over


def _decoded(gaussians, device, planar_sh: bool = False) -> Gaussians:
    """``gaussians`` on ``device``; an ``io.device_asset.DeviceAsset``
    (duck-typed on ``pos_q``, as the JAX package does) is moved there and
    decoded from its quantized words, so that the frame holds no float copy
    of the cloud between frames."""
    if hasattr(gaussians, "pos_q"):
        from ..io.device_asset import decode_device

        with record_function("splat_decode"):
            return decode_device(gaussians.to(device), planar_sh=planar_sh, device=device)
    return gaussians.to(device)


def suggest_pair_multiplier(
    gaussians: Gaussians,
    cameras,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    slack: float = 1.2,
    model: torch.Tensor | None = None,
    device=None,
) -> tuple[float, int]:
    """Worst slot demand over ``cameras`` and a multiplier covering it times
    ``slack``: ``(multiplier, max_demand)``.  One N-sized pass per camera
    (projection + tile rects), with the pipeline's own accounting.
    ``gaussians`` may be a ``DeviceAsset``; ``model`` is the object->world
    matrix the frames will render it with."""
    if isinstance(cameras, Camera):
        cameras = [cameras]
    if not cameras:
        raise ValueError("suggest_pair_multiplier needs at least one camera")
    dev = resolve_device(device)
    g = _decoded(gaussians, dev)
    if model is not None:
        model = model.to(dev)
    worst = 0
    with torch.no_grad():
        for cam in cameras:
            proj = quantize_view_fp16(project_splats(g, cam.to(dev), settings, model=model), config)
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
    center_probe: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Render a splat cloud; (H, W, 4) premultiplied linear RGBA, alpha =
    coverage (1 - final transmittance).  Runs on ``device`` (CUDA unless told
    otherwise; raises when no GPU is present and no device is given)."""
    img, _ = render_with_stats(
        gaussians, camera, settings, config, backend, model=model, kill_mask=kill_mask,
        center_probe=center_probe, device=device,
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
    center_probe: torch.Tensor | None = None,
    want_visibility: bool = False,
    device=None,
) -> tuple[torch.Tensor, RenderStats]:
    """Like :func:`render` but also returns :class:`RenderStats`.

    ``gaussians`` may also be an ``io.device_asset.DeviceAsset``: it is
    decoded on the device each frame (``config.decode_planar_sh`` keeps its
    SH planar), the reference's per-frame ``LoadSplatData``
    (GaussianSplatting.hlsl:428-608).

    ``center_probe`` is an (N, 2) zero tensor added to the projected splat
    centers: its gradient is the screen-space positional gradient (the 3DGS
    densification statistic).  ``want_visibility`` fills ``RenderStats.visible`` with the per-splat
    "non-empty on-screen tile rect" mask (the 3DGS ``radii > 0`` filter).

    The stages carry ``torch.profiler`` ranges, the JAX package's named
    scopes: ``splat_decode``, ``splat_project`` with ``splat_sh`` inside it
    (``ops/projection.py``), then ``splat_rasterize_cuda`` with ``splat_bin``
    inside it (``ops/rasterize_cuda.py``) and ``splat_sort`` inside that
    (``ops/pair_expand.py``), or ``splat_bin`` alone on the ``"torch"``
    backend.  ``ViewerSession.frame`` wraps the whole frame in
    ``splat_frame``.
    """
    if backend not in ("cuda", "torch", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    g = _decoded(gaussians, dev, planar_sh=config.decode_planar_sh)
    camera = camera.to(dev)
    if model is not None:
        model = model.to(dev)
    if kill_mask is not None:
        kill_mask = kill_mask.to(dev)
    with record_function("splat_project"):
        proj = project_splats(g, camera, settings, model=model, kill_mask=kill_mask)
    if center_probe is not None:
        proj = proj._replace(center=proj.center + center_probe.to(dev))
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
    if backend == "torch":
        with record_function("splat_bin"):
            binning = bin_splats(proj, w, h, config)
        img = rasterize_tiles_torch(proj, binning, w, h, config)
        return img, RenderStats(binning.num_pairs, budget, binning.num_pairs > budget, visible)
    with record_function("splat_rasterize_cuda"):
        img, num_pairs = rasterize(proj, w, h, config)
    return img, RenderStats(num_pairs, budget, num_pairs > budget, visible)


def render_over_background(
    gaussians: Gaussians,
    camera: Camera,
    background,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    convert_gamma: bool = False,
    device=None,
) -> torch.Tensor:
    """Full frame: splat RT composited over a background color/image.

    Mirrors GaussianSplatRenderSystem.OnPreCullCamera's RT + composite pass
    (GaussianSplatRenderer.cs:187-211).  ``gaussians`` may be a
    ``DeviceAsset``; runs on ``device`` (CUDA unless told otherwise).
    """
    rt = render(gaussians, camera, settings, config, backend, device=device)
    return composite_ops.composite_over(rt, background, convert_gamma=convert_gamma)


def render_multi(
    clouds: list[Gaussians],
    camera: Camera,
    settings_list: list[RenderSettings] | None = None,
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    render_order: list[float] | None = None,
    models: list | None = None,
    device=None,
) -> torch.Tensor:
    """Render several splat objects into one frame; (H, W, 4) premultiplied.

    GaussianSplatRenderSystem.GatherSplatsForCamera + SortAndRenderSplats
    (GaussianSplatRenderer.cs:73-169): objects are ordered by explicit render
    order (higher in front), then by the view depth of their origin (nearest
    first), then by index; each object is depth-sorted on its own, and the
    objects composite front to back into one target ("under" blending).
    Splats of different objects do not interleave in depth, as in the
    reference.  The origins' depths are one host read a frame.  The backend
    defaults to ``"cuda"``; the JAX package's default, its XLA tile path, is
    ``"torch"`` here.  Runs on ``device`` (CUDA unless told otherwise).
    """
    dev = resolve_device(device)
    camera = camera.to(dev)
    n = len(clouds)
    settings_list = settings_list or [RenderSettings()] * n
    models = [None if m is None else torch.as_tensor(m, dtype=torch.float32).to(dev) for m in (models or [None] * n)]
    origins = torch.zeros((n, 3), device=dev)
    for i, m in enumerate(models):
        if m is not None:
            origins[i] = m[:3, 3]
    depths = camera.world_to_view(origins)[:, 2].tolist()
    explicit = render_order or [0.0] * n
    order = sorted((-explicit[i], depths[i], i) for i in range(n))

    accum = torch.zeros((camera.height, camera.width, 4), dtype=torch.float32, device=dev)
    for _, _, i in order:
        rt = render(clouds[i], camera, settings_list[i], config, backend, model=models[i], device=dev)
        accum = accum + (1.0 - accum[..., 3:4]) * rt  # new content goes behind what is drawn
    return accum


@dataclasses.dataclass
class GaussianSplatRenderer:
    """Stateful wrapper mirroring the reference's component API: a cloud plus
    its display settings (GaussianSplatRenderer.cs:215-251).  The functional
    :func:`render` is the primary API; this class serves interactive and
    driver use.  ``backend`` defaults to ``"cuda"`` (see
    :func:`render_multi`)."""

    gaussians: Gaussians
    settings: RenderSettings = RenderSettings()
    config: RasterizeConfig = RasterizeConfig()
    backend: str = "cuda"
    device: object = None

    def render_frame(self, camera: Camera) -> torch.Tensor:
        return render(self.gaussians, camera, self.settings, self.config, self.backend, device=self.device)
