"""Selection and edit operations on a splat cloud.

The reference's GPU edit kernels and the renderer's Edit* API
(GaussianSplatRenderer.cs:788-1075, SplatUtilities.compute:266-521).  The
reference flips bits in GPU word buffers with atomics; here an edit is a
function of boolean masks and the ``Gaussians`` tensors that returns new
ones, on the cloud's device: keeping the previous cloud undoes it.

The reference supports translate/rotate/scale only on uncompressed Float32
assets (compute:445,469,510); here they work on any loaded cloud, since they
operate on the decoded representation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.camera import Camera
from ..models.gaussians import Gaussians
from ..ops.quaternion import quat_mul, quat_normalize, quat_rotate_vector
from ..utils.device import resolve_device


@dataclasses.dataclass
class EditState:
    """Selection + deletion bits (the reference's _SplatSelectedBits /
    _SplatDeletedBits word buffers, as bool tensors on the cloud's device)."""

    selected: torch.Tensor  # (N,) bool
    deleted: torch.Tensor  # (N,) bool

    @staticmethod
    def empty(n: int, device=None) -> "EditState":
        """Nothing selected or deleted, on ``device`` (CUDA unless told otherwise)."""
        dev = resolve_device(device)
        return EditState(torch.zeros(n, dtype=torch.bool, device=dev), torch.zeros(n, dtype=torch.bool, device=dev))


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype).to(like.device)


def select_rect(
    state: EditState,
    g: Gaussians,
    camera: Camera,
    rect_min,
    rect_max,
    subtract: bool = False,
    kill_mask: torch.Tensor | None = None,
) -> EditState:
    """Rectangle selection in pixel coords (CSSelectionUpdate, compute:393-423).

    Add mode ORs bits in; subtract mode ANDs them out.  Splats behind the
    camera (view z <= 0) or cut by cutouts never change.
    """
    camera = camera.to(g.means.device)
    view_pos = camera.world_to_view(g.means)
    pix = camera.view_to_pixel(view_pos)
    rect_min, rect_max = _vec(rect_min, pix), _vec(rect_max, pix)
    inside = (
        (view_pos[..., 2] > 0)
        & (pix[:, 0] >= rect_min[0])
        & (pix[:, 0] <= rect_max[0])
        & (pix[:, 1] >= rect_min[1])
        & (pix[:, 1] <= rect_max[1])
    )
    if kill_mask is not None:
        inside &= ~kill_mask
    if subtract:
        return dataclasses.replace(state, selected=state.selected & ~inside)
    return dataclasses.replace(state, selected=state.selected | inside)


def select_all(state: EditState) -> EditState:
    return dataclasses.replace(state, selected=torch.ones_like(state.selected))


def invert_selection(state: EditState) -> EditState:
    """CSInvertSelection (compute:340-352); deleted splats stay unselected."""
    return dataclasses.replace(state, selected=~state.selected & ~state.deleted)


def clear_selection(state: EditState) -> EditState:
    return dataclasses.replace(state, selected=torch.zeros_like(state.selected))


def delete_selected(state: EditState) -> EditState:
    """EditDeleteSelected (GaussianSplatRenderer.cs:862-870)."""
    return EditState(selected=torch.zeros_like(state.selected), deleted=state.deleted | state.selected)


def translate_selection(g: Gaussians, state: EditState, delta) -> Gaussians:
    """CSTranslateSelection (compute:435-452)."""
    means = torch.where(state.selected[:, None], g.means + _vec(delta, g.means), g.means)
    return dataclasses.replace(g, means=means)


def rotate_selection(g: Gaussians, state: EditState, rot_xyzw, center) -> Gaussians:
    """CSRotateSelection (compute:459-497): rotate positions about ``center``
    and compose the rotation into the splats' orientations.

    The reference composes ``q * delta`` and tags it '@TODO: correct
    rotation'; the world-frame composition ``delta * q`` is used here, as in
    the JAX package.  SH coefficients are not rotated (the reference's TODO;
    the export bake does rotate them).
    """
    rot = quat_normalize(_vec(rot_xyzw, g.rotations))
    center = _vec(center, g.means)
    sel = state.selected[:, None]
    moved = quat_rotate_vector(g.means - center, rot) + center
    rotated = quat_mul(torch.broadcast_to(rot, g.rotations.shape), g.rotations)
    return dataclasses.replace(
        g, means=torch.where(sel, moved, g.means), rotations=torch.where(sel, rotated, g.rotations)
    )


def scale_selection(g: Gaussians, state: EditState, factor, center) -> Gaussians:
    """CSScaleSelection (compute:500-521): scale positions about ``center``.

    Like the reference, the splats' own scales are left unchanged
    (compute:499 '@TODO: maybe scale the splat scale itself too?').
    """
    center = _vec(center, g.means)
    moved = (g.means - center) * _vec(factor, g.means) + center
    return dataclasses.replace(g, means=torch.where(state.selected[:, None], moved, g.means))


class EditSummary(NamedTuple):
    """0-d tensors on the cloud's device (no host read)."""

    selected_count: torch.Tensor
    deleted_count: torch.Tensor
    cut_count: torch.Tensor
    selected_bounds_min: torch.Tensor  # (3,)
    selected_bounds_max: torch.Tensor


def edit_summary(g: Gaussians, state: EditState, kill_mask: torch.Tensor | None = None) -> EditSummary:
    """Counts + selection bounds (CSUpdateEditData, compute:266-315: the
    popcounts and atomic sortable-uint bounds become reductions)."""
    sel = state.selected & ~state.deleted
    dev = g.means.device
    n_cut = (
        torch.sum(kill_mask & ~state.deleted) if kill_mask is not None else torch.zeros((), dtype=torch.int64, device=dev)
    )
    inf = torch.tensor(float("inf"), device=dev)
    return EditSummary(
        selected_count=torch.sum(sel),
        deleted_count=torch.sum(state.deleted),
        cut_count=n_cut,
        selected_bounds_min=torch.amin(torch.where(sel[:, None], g.means, inf), dim=0),
        selected_bounds_max=torch.amax(torch.where(sel[:, None], g.means, -inf), dim=0),
    )
