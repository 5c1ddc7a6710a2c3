"""The rank mesh and what a rank owns.

The reference is strictly single-GPU (SURVEY.md §2.4); the port shards the
renderer's two data axes over the ranks of a ``torch.distributed`` world,
one rank per card, on a 1-D ``DeviceMesh`` whose dim is named ``"splats"``:

- *splat-sharded* (the JAX package's ``splat_sharding``): a rank holds the
  contiguous rows ``[r * N / D, (r + 1) * N / D)`` of every (N, ...) tensor
  of the cloud, on its own card (:func:`shard_gaussians`);
- *tile-sharded* (``tile_sharding``): a rank composites the horizontal strip
  ``r`` of the frame's tile rows (``parallel/strips.py``);
- *replicated* (``replicated``): every rank holds the whole tensor (the
  gathered view data, the final frame).

GSPMD places arrays by sharding annotations; here each rank's program holds
its part, so :func:`splat_sharding` and :func:`tile_sharding` return the
rows a rank owns, and nothing places data for it.  A rank's position on the
mesh is its rank in the mesh's process group: collectives order their
parts by it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.config import RasterizeConfig
from ..utils.device import resolve_device

SPLAT_AXIS = "splats"


def make_mesh(device=None) -> DeviceMesh:
    """1-D mesh over every rank of the initialized world, dim ``"splats"``,
    on CUDA unless the caller passes ``device="cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize() first")
    return init_device_mesh(resolve_device(device).type, (dist.get_world_size(),), mesh_dim_names=(SPLAT_AXIS,))


def mesh_position(mesh: DeviceMesh) -> tuple[int, int]:
    """``(rank, size)`` of this process on the mesh's group; raises when the
    mesh's rank order is not its group's (collectives would misplace parts)."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != sorted(ranks):
        raise ValueError(f"mesh ranks {ranks} are not in group order; build the mesh with make_pod_mesh()")
    group = mesh.get_group(SPLAT_AXIS)
    return dist.get_rank(group), dist.get_world_size(group)


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def splat_sharding(mesh: DeviceMesh, n: int) -> slice:
    """The rows of an (n, ...) splat tensor this rank owns; ``n`` must divide
    by the mesh size (pad with ``models.densify.pad_to_capacity``)."""
    rank, size = mesh_position(mesh)
    if n % size:
        raise ValueError(f"{n} splats do not divide over a mesh of {size} ranks")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def tile_sharding(mesh: DeviceMesh, height: int, config: RasterizeConfig) -> slice:
    """The image rows of the strip this rank composites (the padded frame is
    ``size`` strips of ``strips.strip_height`` rows)."""
    from .strips import strip_height

    rank, size = mesh_position(mesh)
    h = strip_height(height, size, config)
    return slice(rank * h, (rank + 1) * h)


def shard_gaussians(g, mesh: DeviceMesh):
    """This rank's rows of a ``Gaussians``/``RawGaussians`` on its device."""
    rows = splat_sharding(mesh, g.means.shape[0])
    dev = local_device(mesh)
    return dataclasses.replace(
        g, **{f.name: getattr(g, f.name)[rows].to(dev) for f in dataclasses.fields(g)}
    )
