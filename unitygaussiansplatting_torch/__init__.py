"""PyTorch + CUDA port of tpu-splat: Gaussian splat rendering on NVIDIA Hopper.

The JAX package ``unitygaussiansplatting_tpu`` is the reference; this package
imports nothing from it.  Hand-written CUDA kernels live in ``csrc/`` and are
built by ``nvcc`` at first use (``ops/cuda_build.py``).
"""

from .models.camera import Camera
from .models.gaussians import Gaussians, RawGaussians
from .models.renderer import RenderStats, check_overflow, render, render_with_stats
from .utils.config import RasterizeConfig, RenderSettings

__all__ = [
    "Camera",
    "Gaussians",
    "RawGaussians",
    "RasterizeConfig",
    "RenderSettings",
    "RenderStats",
    "check_overflow",
    "render",
    "render_with_stats",
]
