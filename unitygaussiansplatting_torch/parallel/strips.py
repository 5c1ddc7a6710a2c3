"""Strip-sharded rendering: each rank composites its own strip of tile rows.

- Each rank projects its splat shard (no communication).
- One all-gather of the projected view data (15 floats a splat).
- Each rank shifts the gathered centers by its strip's origin, which is
  exact in float32 (origins are multiples of ``tile_h`` and pixel
  coordinates are far below 2^24), and renders at strip height: everything
  after projection is translation-covariant, so the ordinary pipeline
  renders the viewport.  A strip keeps the frame's depth bits
  (``RasterizeConfig.depth_bits``), so it composites in the frame's order.
  The pair work shards by ~1/D, since pairs outside the strip are never
  generated.
- One all-gather of the strips makes the frame on every rank.

Gradients: a rank's strip reads only its part of the gathered view data,
so that gather's backward sums over ranks; every rank computes the same
loss from the gathered strips, so the strips' gather takes this rank's rows.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.camera import Camera
from ..models.gaussians import Gaussians
from ..ops.binning import bin_splats, depth_key_bits, tile_grid
from ..ops.projection import ProjectedSplats, project_splats
from ..ops.rasterize_cuda import rasterize
from ..ops.rasterize_tiles import rasterize_tiles_torch
from ..utils.config import RasterizeConfig, RenderSettings
from .collectives import gather_rows, pack_proj, unpack_proj
from .mesh import SPLAT_AXIS, local_device, mesh_position

BACKENDS = ("torch", "cuda")


def strip_height(height: int, num_ranks: int, config: RasterizeConfig) -> int:
    """Rows of one strip: the frame's tile rows split over the ranks, rounded up."""
    _, tiles_y = tile_grid(1, height, config)
    return -(-tiles_y // num_ranks) * config.tile_h


def render_strip(proj: ProjectedSplats, rank: int, num_ranks: int, camera: Camera,
                 config: RasterizeConfig, backend: str = "torch") -> torch.Tensor:
    """Rank ``rank``'s strip, (strip_height, W, 4), from the view data it
    sees (all of it, or what the culled exchange sent it).

    ``backend="torch"`` bins and composites with the tile path;
    ``backend="cuda"`` runs the fused pipeline (K2's per-splat pass, K2 and
    K1 on a CUDA device, their plain versions on the CPU), whose backward is
    K3 and K4.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    h = strip_height(camera.height, num_ranks, config)
    # The frame's depth bits: a strip's smaller grid would leave more, and
    # order near-equal depths other than the frame does.
    tiles_x, tiles_y = tile_grid(camera.width, camera.height, config)
    config = dataclasses.replace(config, depth_bits=depth_key_bits(tiles_x * tiles_y, config))
    origin = torch.tensor([0.0, float(rank * h)], dtype=torch.float32, device=proj.center.device)
    shifted = proj._replace(center=proj.center - origin)
    if backend == "cuda":
        return rasterize(shifted, camera.width, h, config)[0]
    binning = bin_splats(shifted, camera.width, h, config)
    return rasterize_tiles_torch(shifted, binning, camera.width, h, config)


def assemble_strips(strip: torch.Tensor, mesh: DeviceMesh, height: int) -> torch.Tensor:
    """Every rank's strip stacked into the frame, on every rank."""
    frame = gather_rows(strip, mesh.get_group(SPLAT_AXIS), replicated=True)
    return frame[:height]


def render_strips_fn(
    mesh: DeviceMesh,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "torch",
):
    """``fn(g_local) -> (H, W, 4)`` frame, the same on every rank; ``g_local``
    is this rank's rows, every rank's the same count."""
    camera = camera.to(local_device(mesh))
    rank, size = mesh_position(mesh)

    def fn(g: Gaussians) -> torch.Tensor:
        proj = project_splats(g, camera, settings)
        proj = unpack_proj(gather_rows(pack_proj(proj), mesh.get_group(SPLAT_AXIS), replicated=False))
        strip = render_strip(proj, rank, size, camera, config, backend)
        return assemble_strips(strip, mesh, camera.height)

    return fn


def render_strips(g: Gaussians, mesh: DeviceMesh, camera: Camera, **kw) -> torch.Tensor:
    return render_strips_fn(mesh, camera, **kw)(g)
