"""PyTorch + CUDA port of tpu-splat: Gaussian splat rendering on NVIDIA Hopper.

The JAX package ``unitygaussiansplatting_tpu`` is the reference; this package
imports nothing from it.  Hand-written CUDA kernels live in ``csrc/`` and are
built by ``nvcc`` at first use (``ops/cuda_build.py``).

Quick start (on the card; pass ``device="cpu"`` to run the kernels' plain
versions on the CPU)::

    from unitygaussiansplatting_torch import Camera, render
    from unitygaussiansplatting_torch.io.creator import create_asset
    from unitygaussiansplatting_torch.io.asset import decode_asset
    from unitygaussiansplatting_torch.io.bridge import input_splats_to_gaussians

    asset = create_asset("scene.ply", quality="medium")
    cloud = input_splats_to_gaussians(decode_asset(asset))
    cam = Camera.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0], 45, 1200, 797)
    image = render(cloud, cam)  # (H, W, 4) premultiplied RGBA on the card

The user-facing programs run as ``python -m unitygaussiansplatting_torch.<name>``
(add ``--device cpu`` without a card), each the counterpart of a JAX script:

- ``examples.render_sphere``: ``examples/render_sphere.py``;
- ``examples.orbit``: ``examples/orbit.py``;
- ``examples.render_asset``: ``examples/render_asset.py``;
- ``examples.train_splats``: ``examples/train_splats.py``;
- ``examples.train_full``: ``examples/train_full.py``;
- ``tools.measure_overlap``: ``tools/measure_overlap.py``;
- ``tools.measure_bc7``: ``tools/measure_bc7.py``.

``examples.train_full`` differs from its JAX script on purpose in two
places: its held-out cameras sit at true midpoints of the training ring
(the JAX script's r5 "held-out" cameras are training cameras), and its
first/last loss means divide by the real counts (the JAX script divides by
a hard-coded 10).  ``examples`` says more.
"""

from .models.camera import Camera
from .models.gaussians import Gaussians, RawGaussians, deactivate
from .models.renderer import (
    GaussianSplatRenderer,
    RenderStats,
    check_overflow,
    render,
    render_multi,
    render_over_background,
    render_with_stats,
    suggest_pair_multiplier,
)
from .utils.config import RasterizeConfig, RenderSettings

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Gaussians",
    "RawGaussians",
    "deactivate",
    "GaussianSplatRenderer",
    "RenderStats",
    "check_overflow",
    "render",
    "render_multi",
    "render_over_background",
    "render_with_stats",
    "suggest_pair_multiplier",
    "RasterizeConfig",
    "RenderSettings",
    "__version__",
]
