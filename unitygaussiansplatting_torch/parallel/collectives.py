"""Differentiable collectives over the ``"splats"`` group, and the packed
view-data rows they move.

JAX differentiates its collectives by transposing them.  Here each is a
``torch.autograd.Function`` whose backward depends on who consumes the
result:

- partitioned consumers (each rank renders its own strip from the gathered
  view data): the gradients of the gathered rows are summed over ranks,
  ``reduce_scatter_tensor``;
- replicated consumers (every rank computes the same frame from the
  gathered data, or the same loss from the gathered strips): every rank
  already holds the whole gradient, so the backward takes this rank's rows;
  a sum would scale it by the world size;
- ``all_to_all_single`` of equal blocks: the backward is the same exchange
  of the cotangents.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.projection import ProjectedSplats

# The flat-tensor collectives took new names in PyTorch 2.13 (the old ones
# warn there); older releases have only the old ones.
all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# ProjectedSplats as rows of 15 float32: depth 1, center 2, axis1 2, axis2 2,
# conic 3, color 3, opacity 1 (14 floats) and valid as 0/1.
_PROJ_WIDTHS = (("depth", 1), ("center", 2), ("axis1", 2), ("axis2", 2), ("conic", 3), ("color", 3),
                ("opacity", 1))
PROJ_ROW = 15


def pack_proj(proj: ProjectedSplats) -> torch.Tensor:
    """(N, 15) float32 rows of the view data (differentiable)."""
    cols = [getattr(proj, name).reshape(proj.depth.shape[0], w) for name, w in _PROJ_WIDTHS]
    return torch.cat(cols + [proj.valid.to(torch.float32)[:, None]], dim=1)


def unpack_proj(rows: torch.Tensor) -> ProjectedSplats:
    """Inverse of :func:`pack_proj`."""
    out, c = {}, 0
    for name, w in _PROJ_WIDTHS:
        out[name] = rows[:, c] if w == 1 else rows[:, c:c + w]
        c += w
    return ProjectedSplats(valid=rows[:, c].detach() > 0.5, **out)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, replicated):
        size = dist.get_world_size(group)
        out = x.new_empty((size * x.shape[0],) + x.shape[1:])
        all_gather_flat(out, x.contiguous(), group=group)
        ctx.group, ctx.replicated, ctx.rows = group, replicated, x.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        if ctx.replicated:
            return grad[rank * ctx.rows:(rank + 1) * ctx.rows].contiguous(), None, None
        out = grad.new_empty((ctx.rows,) + grad.shape[1:])
        reduce_scatter_flat(out, grad.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None


def gather_rows(x: torch.Tensor, group, replicated: bool) -> torch.Tensor:
    """All ranks' ``x`` stacked along dim 0 in rank order.  ``replicated``:
    every rank consumes the result alike (backward: this rank's rows);
    else each consumes its own part (backward: the sum over ranks)."""
    return _GatherRows.apply(x, group, replicated)


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Block d of ``x``'s D equal row blocks goes to rank d; block s of the
    result came from rank s."""
    return _AllToAllRows.apply(x, group)
