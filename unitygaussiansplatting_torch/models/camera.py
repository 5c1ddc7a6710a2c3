"""Pinhole camera: world->view transform plus intrinsics.

Convention (not Unity's): world/view space is right-handed, the camera looks
down +Z with view-space y up, so ``view_pos[..., 2]`` is the positive depth;
pixel space is y-down with pixel centers at half-integers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """view: (4, 4) float32 world->view matrix; fov_y in radians; size in px."""

    view: torch.Tensor
    fov_y: float
    width: int
    height: int

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def tan_fovy(self) -> float:
        return math.tan(0.5 * self.fov_y)

    @property
    def tan_fovx(self) -> float:
        return self.tan_fovy * self.aspect

    @property
    def focal(self) -> float:
        """Pixel focal length (GaussianSplatting.hlsl:70)."""
        return self.width / (2.0 * self.tan_fovx)

    @property
    def position(self) -> torch.Tensor:
        """Camera position in world space, ``-R^T t``."""
        r = self.view[:3, :3]
        t = self.view[:3, 3]
        return -(r.T @ t)

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, view=self.view.to(device))

    @staticmethod
    def look_at(eye, target, up, fov_y_deg: float, width: int, height: int) -> "Camera":
        """Build a camera looking from ``eye`` toward ``target`` (on the CPU)."""
        eye = np.asarray(eye, dtype=np.float32)
        target = np.asarray(target, dtype=np.float32)
        up = np.asarray(up, dtype=np.float32)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(up, fwd)
        right = right / np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        rot = np.stack([right, true_up, fwd], axis=0)  # world->view rows
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = rot
        view[:3, 3] = -rot @ eye
        return Camera(
            view=torch.from_numpy(view),
            fov_y=math.radians(fov_y_deg),
            width=int(width),
            height=int(height),
        )

    def view_to_pixel(self, v: torch.Tensor) -> torch.Tensor:
        """(..., 3) view points -> (..., 2) pixel coords (y-down)."""
        z = v[..., 2]
        ndc_x = v[..., 0] / (z * self.tan_fovx)
        ndc_y = v[..., 1] / (z * self.tan_fovy)
        px = (ndc_x * 0.5 + 0.5) * self.width
        py = (0.5 - ndc_y * 0.5) * self.height
        return torch.stack([px, py], dim=-1)
