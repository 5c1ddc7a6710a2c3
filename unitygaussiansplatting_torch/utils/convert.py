"""Carry splat parameters and cameras across from plain numpy arrays.

The JAX package's ``RawGaussians`` and ``Camera`` hold numpy-convertible
arrays; these functions build the port's versions from the same values, so
that both packages can be fed identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.camera import Camera
from ..models.gaussians import RawGaussians

RAW_FIELDS = ("means", "rotations_wxyz", "log_scales", "opacity_logits", "sh0", "sh")


def raw_gaussians_from_numpy(arrays: dict) -> RawGaussians:
    """Port ``RawGaussians`` from a dict of the JAX ``RawGaussians`` fields
    (``models/gaussians.py``: means, rotations_wxyz, log_scales,
    opacity_logits, sh0, sh), as float32 CPU tensors."""
    missing = [f for f in RAW_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing RawGaussians fields: {missing}")
    return RawGaussians(
        **{
            f: torch.from_numpy(np.array(arrays[f], dtype=np.float32))
            for f in RAW_FIELDS
        }
    )


def camera_from_numpy(view, fov_y: float, width: int, height: int) -> Camera:
    """Port ``Camera`` from a (4, 4) world->view matrix and intrinsics
    (``fov_y`` in radians, as the JAX ``Camera`` stores it)."""
    view = np.asarray(view, dtype=np.float32)
    if view.shape != (4, 4):
        raise ValueError(f"view must be (4, 4), got {view.shape}")
    return Camera(
        view=torch.from_numpy(view.copy()),
        fov_y=float(fov_y),
        width=int(width),
        height=int(height),
    )
