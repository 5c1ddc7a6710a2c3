"""Splat editing: selection, delete, transform, cutouts, export (the port of
``unitygaussiansplatting_tpu/editing``).  Every function computes on its
inputs' device."""

from .cutouts import Cutout, CutoutType, cutout_kill_mask
from .edits import (
    EditState,
    delete_selected,
    edit_summary,
    invert_selection,
    rotate_selection,
    scale_selection,
    select_all,
    select_rect,
    translate_selection,
)
from .export import export_gaussians, merge_gaussians

__all__ = [
    "Cutout",
    "CutoutType",
    "cutout_kill_mask",
    "EditState",
    "delete_selected",
    "edit_summary",
    "invert_selection",
    "rotate_selection",
    "scale_selection",
    "select_all",
    "select_rect",
    "translate_selection",
    "export_gaussians",
    "merge_gaussians",
]
