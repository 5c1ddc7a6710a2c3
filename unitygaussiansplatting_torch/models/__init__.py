"""Data models: splat clouds, cameras, render orchestration, training."""

from .camera import Camera
from .gaussians import Gaussians, RawGaussians, deactivate
from .renderer import GaussianSplatRenderer, render, render_multi, render_over_background

__all__ = [
    "Camera",
    "Gaussians",
    "RawGaussians",
    "deactivate",
    "GaussianSplatRenderer",
    "render",
    "render_multi",
    "render_over_background",
]
