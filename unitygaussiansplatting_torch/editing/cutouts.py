"""Cutout volumes: ellipsoid/box regions that hide splats.

The reference's GaussianCutout component (GaussianCutout.cs:20-40) and its
``IsSplatCut`` test (SplatUtilities.compute:164-187), over all splats at once
on the positions' device.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from ..ops.projection import affine


class CutoutType(enum.IntEnum):
    ELLIPSOID = 0
    BOX = 1


@dataclasses.dataclass(frozen=True)
class Cutout:
    """One cutout volume: a world->local matrix mapping the unit shape."""

    mat: torch.Tensor  # (4, 4) world(object)->cutout-local
    type: CutoutType = CutoutType.ELLIPSOID
    invert: bool = False


def _inside(c: Cutout, pos: torch.Tensor) -> torch.Tensor:
    local = affine(pos, c.mat.to(device=pos.device, dtype=pos.dtype))
    if c.type == CutoutType.ELLIPSOID:
        return torch.sum(local * local, dim=-1) <= 1.0
    return torch.all(torch.abs(local) <= 1.0, dim=-1)


def cutout_kill_mask(cutouts: list[Cutout], pos: torch.Tensor) -> torch.Tensor:
    """(N,) bool on ``pos``'s device: True where a splat is hidden.

    The kernel's sequential rule (compute:164-187): the first cutout that
    *contains* a splat decides by its invert flag; a splat inside no cutout is
    cut iff any non-inverted cutout exists.
    """
    n = pos.shape[0]
    decided = torch.zeros(n, dtype=torch.bool, device=pos.device)
    result = torch.zeros(n, dtype=torch.bool, device=pos.device)
    if not cutouts:
        return result
    for c in cutouts:
        inside = _inside(c, pos)
        result = torch.where(inside & ~decided, bool(c.invert), result)
        decided = decided | inside
    return torch.where(decided, result, any(not c.invert for c in cutouts))
