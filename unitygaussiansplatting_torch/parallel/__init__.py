"""Multi-rank rendering on ``torch.distributed``: the rank mesh, joining the
world, and splat-sharded render and train steps (all-gather, strips, and
the culled all-to-all exchange)."""

from .mesh import make_mesh, splat_sharding, tile_sharding
from .multihost import (
    global_gaussians_from_local,
    initialize,
    make_pod_mesh,
    process_splat_slice,
)
from .render_sharded import render_sharded, train_step_sharded
from .strips import render_strips, render_strips_fn

__all__ = [
    "make_mesh",
    "splat_sharding",
    "tile_sharding",
    "render_sharded",
    "train_step_sharded",
    "render_strips",
    "render_strips_fn",
    "initialize",
    "make_pod_mesh",
    "process_splat_slice",
    "global_gaussians_from_local",
]
