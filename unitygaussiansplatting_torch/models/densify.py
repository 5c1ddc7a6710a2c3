"""Adaptive density control: clone / split / prune for training (3DGS §5.2).

The port of ``unitygaussiansplatting_tpu/models/densify.py``.  Masks,
gathers and concatenations run in torch on the cloud's own device: at 6.1M
splats the parameters are 1.44 GB, which a round trip through the host would
move twice.  Only the split's random offsets are drawn on the host, from
``np.random.default_rng(seed)`` exactly as the JAX package draws them, so
that split children land where JAX's do.  The functions have no device
policy of their own and never touch their input's tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quaternion import quat_to_rotation_matrix
from ..utils.convert import RAW_FIELDS
from .gaussians import RawGaussians


def _gather(raw: RawGaussians, idx: torch.Tensor) -> dict:
    return {f: getattr(raw, f).detach().index_select(0, idx) for f in RAW_FIELDS}


@torch.no_grad()
def prune(
    raw: RawGaussians,
    min_opacity: float = 0.005,
    max_world_scale: float | None = None,
    return_map: bool = False,
):
    """Drop splats below an opacity threshold (and optionally huge ones).

    ``return_map`` also returns the kept input indices (int64, on the
    cloud's device) for optimizer-state carry-over, see :func:`densify`.
    The sigmoid is taken in float32, as the JAX package takes it.
    """
    opacity = 1.0 / (1.0 + torch.exp(-raw.opacity_logits.detach()))
    keep = opacity > min_opacity
    if max_world_scale is not None:
        keep &= torch.exp(raw.log_scales.detach()).amax(dim=1) < max_world_scale
    kept = torch.nonzero(keep).flatten()
    out = RawGaussians(**_gather(raw, kept))
    if return_map:
        return out, kept
    return out


@torch.no_grad()
def densify(
    raw: RawGaussians,
    position_grads,
    grad_threshold: float = 2e-4,
    scale_threshold: float = 0.01,
    split_factor: float = 1.6,
    seed: int = 0,
    return_map: bool = False,
):
    """Clone small / split large high-gradient splats (3DGS §5.2).

    ``position_grads`` (N,) or (N, D), a tensor or an array, is the
    accumulated positional-gradient statistic; rows are norm-reduced.  Hot
    splats (norm above ``grad_threshold``) no larger than
    ``scale_threshold`` are cloned, larger ones split in two children whose
    scales shrink by ``split_factor`` and whose means are drawn from the
    parent gaussian; the split parents go.  Output rows: the survivors in
    order, then the clones, then the first children, then the second ones.

    As in the JAX package, clones are duplicated in place rather than moved
    along the gradient (the pair drifts apart under the optimizer).

    ``return_map`` also returns ``(src_idx, is_new)``: for each output row
    the input row it derives from (int64) and whether it is a new splat
    (clone copies and split children), for carrying Adam moments across the
    topology change.
    """
    dev = raw.means.device
    n = raw.num_splats
    grads = torch.as_tensor(position_grads, device=dev).reshape(n, -1)
    gnorm = torch.sqrt(torch.sum(grads * grads, dim=1))
    hot = gnorm > grad_threshold
    log_scales = raw.log_scales.detach()
    world_scale = torch.exp(log_scales).amax(dim=1)
    clone_idx = torch.nonzero(hot & (world_scale <= scale_threshold)).flatten()
    split_mask = hot & (world_scale > scale_threshold)
    split_idx = torch.nonzero(split_mask).flatten()
    keep_idx = torch.nonzero(~split_mask).flatten()
    m = split_idx.numel()

    src_idx = torch.cat([keep_idx, clone_idx, split_idx, split_idx])
    out = _gather(raw, src_idx)
    if m:
        # Children: offsets drawn from the parent gaussian (rotated, scaled
        # standard normals), scales shrunk; two draws in child order.
        rng = np.random.default_rng(seed)
        q = raw.rotations_wxyz.detach().index_select(0, split_idx)
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
        rot = quat_to_rotation_matrix(torch.cat([qn[:, 1:], qn[:, :1]], dim=1))
        parent_log_scales = log_scales.index_select(0, split_idx)
        scales = torch.exp(parent_log_scales)
        means = raw.means.detach().index_select(0, split_idx)
        first = n - m + clone_idx.numel()
        shrink = float(np.float32(math.log(split_factor)))
        for child in range(2):
            eps = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32)).to(dev)
            offset = torch.sum(rot * (eps * scales)[:, None, :], dim=2)
            rows = slice(first + child * m, first + (child + 1) * m)
            out["means"][rows] = means + offset
            out["log_scales"][rows] = parent_log_scales - shrink
    result = RawGaussians(**out)
    if return_map:
        is_new = torch.arange(src_idx.numel(), device=dev) >= keep_idx.numel()
        return result, src_idx, is_new
    return result


@torch.no_grad()
def reset_opacity(raw: RawGaussians, ceiling: float = 0.01) -> RawGaussians:
    """Clamp opacities to a low value (periodic reset, 3DGS §5.2).  The
    other fields are the input's own tensors."""
    logit_ceiling = float(np.float32(np.log(ceiling / (1 - ceiling))))
    return RawGaussians(
        **{f: getattr(raw, f) for f in RAW_FIELDS if f != "opacity_logits"},
        opacity_logits=torch.clamp(raw.opacity_logits.detach(), max=logit_ceiling),
    )


@torch.no_grad()
def pad_to_capacity(raw: RawGaussians, capacity: int) -> RawGaussians:
    """Pad with zero-opacity splats so that the cloud's size only changes in
    capacity steps (dead splats render as nothing).

    As in the JAX package, the input object itself comes back when no
    padding is needed.
    """
    n = raw.num_splats
    if n > capacity:
        raise ValueError(f"{n} splats exceed capacity {capacity}")
    pad = capacity - n
    if pad == 0:
        return raw
    out = {}
    for f in RAW_FIELDS:
        v = getattr(raw, f).detach()
        filler = torch.zeros((pad,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        if f in ("opacity_logits", "log_scales"):
            filler -= 20.0  # sigmoid(-20) ~ 0: invisible; degenerate size
        if f == "rotations_wxyz":
            filler[:, 0] = 1.0
        out[f] = torch.cat([v, filler])
    return RawGaussians(**out)
