"""Culled all-to-all exchange of projected splats (owner-computes strips).

``strips.py``'s all-gather replicates all N splats' view data on every rank,
O(N) memory a rank.  Here each splat owner:

1. projects its shard (no communication);
2. finds, with the binner's own rects (``ops.binning.tile_rects`` at strip
   height, on the centers shifted by each strip's origin, exactly as the
   destination will bin them), which strips each splat touches;
3. compacts, per destination, the view data of the splats touching its
   strip into a send block of fixed capacity (one single-key sort plus
   capped gathers);
4. exchanges the blocks with one ``all_to_all_single``,

so a rank holds O(N x overlap / D) view data.  Gradients flow back through
the exchange (its backward is the same exchange of the cotangents) and the
compaction's gathers.

Send capacity is fixed: splats past ``cap`` for one (source, destination)
are dropped, later rows first, and the true demand is returned, so callers
can detect truncation (the pair budget's contract,
``models.renderer.check_overflow``).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.camera import Camera
from ..models.gaussians import Gaussians
from ..ops.binning import cdiv, tile_rects
from ..ops.projection import ProjectedSplats, project_splats
from ..ops.tile_common import quantize_view_fp16
from ..utils.config import RasterizeConfig, RenderSettings
from .collectives import all_gather_flat, all_to_all_rows, pack_proj, unpack_proj
from .mesh import SPLAT_AXIS, local_device, mesh_position
from .strips import assemble_strips, render_strip, strip_height


def send_capacity(n_local: int, cap_frac: float) -> int:
    """Splats a source sends one destination at most.  A frame is truncated
    iff an entry of ``send_demand`` exceeds this."""
    return min(max(cdiv(int(n_local * cap_frac), 8) * 8, 8), n_local)


def default_cap_frac(num_ranks: int) -> float:
    """A strip covers ~1/D of the screen plus overlap: min(1, 4/D)."""
    return min(1.0, 4.0 / num_ranks)


def _compact_for_dest(proj: ProjectedSplats, send_mask: torch.Tensor, cap: int):
    """Up to ``cap`` masked splats' view data in row order; ``(view data, demand)``."""
    n = send_mask.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=send_mask.device)
    key = torch.where(send_mask, iota, 0x7FFFFFFF)
    picks = torch.clamp(torch.sort(key, stable=True).values[:cap], max=n - 1).long()
    demand = torch.sum(send_mask, dtype=torch.int32)
    live = torch.arange(cap, device=send_mask.device) < demand
    sel = ProjectedSplats(*(x[picks] for x in proj))
    return sel._replace(valid=sel.valid & live), demand


def compact_sends(proj: ProjectedSplats, num_ranks: int, camera: Camera, config: RasterizeConfig, cap: int):
    """One source's send buffer: ``(rows (D * cap, 15), demand (D,) int32)``,
    block d holding the view data of the splats that touch strip d."""
    h = strip_height(camera.height, num_ranks, config)
    # The rounding never touches the centers, so it is done once for all
    # destinations and then shifted.
    quantized = quantize_view_fp16(proj, config)
    blocks, demands = [], []
    for dst in range(num_ranks):
        origin = torch.tensor([0.0, float(dst * h)], dtype=torch.float32, device=proj.center.device)
        *_, counts, valid = tile_rects(quantized._replace(center=quantized.center - origin), camera.width, h, config)
        sel, demand = _compact_for_dest(proj, valid & (counts > 0), cap)
        blocks.append(pack_proj(sel))
        demands.append(demand)
    return torch.cat(blocks), torch.stack(demands)


def render_strips_culled_fn(
    mesh: DeviceMesh,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "torch",
    cap_frac: float | None = None,
):
    """``fn(g_local) -> ((H, W, 4) frame, send_demand (D, D) int32)``, both
    the same on every rank.  ``send_demand[s, d]`` is how many splats source
    s had for destination d; above ``send_capacity(n_local, cap_frac)`` that
    block was truncated.  ``cap_frac`` defaults to ``default_cap_frac(D)``."""
    camera = camera.to(local_device(mesh))
    rank, size = mesh_position(mesh)
    group = mesh.get_group(SPLAT_AXIS)
    if cap_frac is None:
        cap_frac = default_cap_frac(size)

    def fn(g: Gaussians):
        proj = project_splats(g, camera, settings)
        cap = send_capacity(proj.depth.shape[0], cap_frac)
        send, demand_row = compact_sends(proj, size, camera, config, cap)
        recv = unpack_proj(all_to_all_rows(send, group))  # block s: from source s, touching my strip
        demand = torch.empty(size * size, dtype=torch.int32, device=demand_row.device)
        all_gather_flat(demand, demand_row, group=group)
        strip = render_strip(recv, rank, size, camera, config, backend)
        return assemble_strips(strip, mesh, camera.height), demand.view(size, size)

    return fn


def render_strips_culled(g: Gaussians, mesh: DeviceMesh, camera: Camera, **kw):
    return render_strips_culled_fn(mesh, camera, **kw)(g)
