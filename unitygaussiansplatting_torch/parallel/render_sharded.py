"""Splat-sharded rendering and training steps.

- Splat sharding: each rank holds its rows of the cloud; projection is
  pointwise over splats and runs with no communication.
- View-data exchange: one all-gather of the projected view data (15 floats
  a splat, the analog of the reference's ``SplatViewData``); the raw
  parameters never leave their rank.
- Every rank then bins and composites the whole frame with the tile path
  (``backend="torch"``), so the frame is replicated and so is the loss.
- Gradients: the gather's backward takes this rank's rows of the (equal)
  gradient every rank holds, so each rank's parameters get exactly their
  gradient, with no sum.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.camera import Camera
from ..models.gaussians import Gaussians, RawGaussians
from ..ops.binning import bin_splats
from ..ops.projection import project_splats
from ..ops.rasterize_tiles import rasterize_tiles_torch
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.convert import RAW_FIELDS
from .collectives import gather_rows, pack_proj, unpack_proj
from .mesh import SPLAT_AXIS, local_device


def _frame(g: Gaussians, mesh: DeviceMesh, camera: Camera, settings, config) -> torch.Tensor:
    proj = project_splats(g, camera, settings)
    proj = unpack_proj(gather_rows(pack_proj(proj), mesh.get_group(SPLAT_AXIS), replicated=True))
    binning = bin_splats(proj, camera.width, camera.height, config)
    return rasterize_tiles_torch(proj, binning, camera.width, camera.height, config)


def render_sharded_fn(
    mesh: DeviceMesh,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
):
    """``fn(g_local) -> (H, W, 4)`` frame, the same on every rank; ``g_local``
    is this rank's rows (``mesh.shard_gaussians``), every rank's the same
    count."""
    camera = camera.to(local_device(mesh))
    return lambda g: _frame(g, mesh, camera, settings, config)


def render_sharded(g: Gaussians, mesh: DeviceMesh, camera: Camera, **kw) -> torch.Tensor:
    return render_sharded_fn(mesh, camera, **kw)(g)


def train_step_sharded_fn(
    mesh: DeviceMesh,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    lr: float = 1e-3,
):
    """``step(raw_local, target) -> (loss, new raw_local)``: an SGD step on
    the L2 image loss, on this rank's raw rows; the loss is the same on
    every rank."""
    camera = camera.to(local_device(mesh))

    def step(raw: RawGaussians, target: torch.Tensor):
        params = [getattr(raw, f).detach().requires_grad_(True) for f in RAW_FIELDS]
        img = _frame(RawGaussians(**dict(zip(RAW_FIELDS, params))).activate(), mesh, camera, settings, config)
        loss = torch.mean(torch.square(img - target.to(img.device)))
        grads = torch.autograd.grad(loss, params)
        new = RawGaussians(**{f: (p - lr * g).detach() for f, p, g in zip(RAW_FIELDS, params, grads)})
        return loss.detach(), new

    return step


def train_step_sharded(raw: RawGaussians, target, mesh: DeviceMesh, camera: Camera, **kw):
    return train_step_sharded_fn(mesh, camera, **kw)(raw, target)
