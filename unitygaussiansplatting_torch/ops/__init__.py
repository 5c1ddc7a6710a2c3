"""Per-splat math, binning, the tile path and the kernels' wrappers with
their plain versions."""

from . import activations, composite, covariance, morton, packing, projection, quaternion, sh
from .projection import ProjectedSplats, project_splats
from .rasterize_ref import rasterize_reference

__all__ = [
    "activations",
    "composite",
    "covariance",
    "morton",
    "packing",
    "projection",
    "quaternion",
    "sh",
    "ProjectedSplats",
    "project_splats",
    "rasterize_reference",
]
