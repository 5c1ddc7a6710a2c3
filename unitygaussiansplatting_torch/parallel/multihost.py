"""Multi-process deployment: joining the world, the pod mesh, sharded loading.

The reference is single-GPU with an 8.6M-splat cap from its 2 GB buffer
limit (GaussianSplatAsset.cs:16); sharding splats over ranks removes the cap,
and this module is the process-level plumbing that runs the same code on one
card or many:

- :func:`initialize`: one call per process, wrapping
  ``torch.distributed.init_process_group`` (NCCL on CUDA, gloo where the
  caller passes ``device="cpu"``).  With no arguments and no cluster
  environment it forms a world of size 1, so a single card runs the
  multi-rank code unchanged.
- :func:`make_pod_mesh`: the ``"splats"`` mesh with each node's ranks next
  to each other (NVLink-innermost), so neighbour-heavy collectives cross
  the network only at node boundaries.
- :func:`process_splat_slice` / :func:`global_gaussians_from_local`: each
  process reads only its rows of the asset; no process holds the whole
  scene.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device
from .mesh import local_device, make_mesh, splat_sharding

# Launcher variables: (world size, rank, local rank) of torchrun, SLURM and
# Open MPI.
_LAUNCHERS = (
    ("WORLD_SIZE", "RANK", "LOCAL_RANK"),
    ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
)


def _cluster_env() -> tuple[int, int, int] | None:
    """``(world size, rank, local rank)`` when a launcher started this
    process as one of several, else None."""
    env = os.environ
    for size_var, rank_var, local_var in _LAUNCHERS:
        try:
            size = int(env.get(size_var, "") or 0)
        except ValueError:
            continue
        if size > 1:
            rank = int(env.get(rank_var, "0"))
            return size, rank, int(env.get(local_var, "0"))
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> None:
    """Join (or form) the ``torch.distributed`` world; call once per process
    before any collective.

    - Explicit arguments: ``coordinator_address`` is ``host:port`` of rank
      0's store, with ``num_processes`` and this ``process_id``.
    - No arguments and a launcher environment (torchrun, SLURM, Open MPI):
      the world size and rank come from it, the address from
      ``MASTER_ADDR``/``MASTER_PORT``; without them it raises.
    - No arguments and no cluster: a world of size 1.

    NCCL on CUDA (the rank takes the card of its local rank), gloo where the
    caller passes ``device="cpu"``; nothing falls back.  Idempotent: a second
    call that asks for the world already formed is a no-op, and one that asks
    for another world (a cluster's arguments or environment after a world of
    size 1 formed) raises instead of stranding this process alone.
    """
    env = _cluster_env()
    explicit = coordinator_address is not None or (num_processes or 0) > 1
    if explicit:
        want = num_processes
    else:
        want = env[0] if env is not None else 1
    if dist.is_initialized():
        if want != dist.get_world_size():
            raise RuntimeError(
                f"multihost.initialize(): this process already belongs to a world of "
                f"{dist.get_world_size()} rank(s) and cannot join one of {want}; call "
                "initialize() with the cluster's arguments at process start"
            )
        return

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL")
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a cluster needs coordinator_address, num_processes and process_id")
        size, rank, local = num_processes, process_id, process_id
        address = coordinator_address
    elif env is not None:
        size, rank, local = env
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
            raise RuntimeError(
                f"a cluster environment of {size} processes was found, but no MASTER_ADDR/MASTER_PORT "
                "to join it: set them, or pass coordinator_address, num_processes and process_id"
            )
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        size, rank, local = 1, 0, 0
        address = f"127.0.0.1:{_free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=size, rank=rank)


def make_pod_mesh(device=None) -> DeviceMesh:
    """The ``"splats"`` mesh over the whole world, each node's ranks next to
    each other (NVLink-innermost).

    Positions on the mesh are ranks (a process group orders its parts by
    rank), so the layout holds when the launcher numbers ranks node by node,
    as torchrun and SLURM's block distribution do; this checks the node
    names and raises when one node's ranks are not adjacent.
    """
    mesh = make_mesh(device)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    seen = [h for i, h in enumerate(hosts) if i == 0 or hosts[i - 1] != h]
    if len(seen) != len(set(seen)):
        raise ValueError(f"the ranks of a node are not adjacent ({hosts}); launch the ranks node by node")
    return mesh


def process_splat_slice(n_total: int, mesh: DeviceMesh) -> tuple[int, int]:
    """``[start, stop)`` of the splat rows this process owns; ``n_total``
    must divide by the mesh size (pad at import time), and the mesh's ranks
    must be in group order (contiguous rows per rank)."""
    rows = splat_sharding(mesh, n_total)
    return rows.start, rows.stop


def global_gaussians_from_local(local, mesh: DeviceMesh, n_total: int):
    """This rank's shard of the global cloud from its own rows (from
    :func:`process_splat_slice`), on its device; the counterpart of the JAX
    package's assembly of a globally sharded array, where each rank's
    program holds its part."""
    start, stop = process_splat_slice(n_total, mesh)
    dev = local_device(mesh)
    out = {}
    for f in dataclasses.fields(local):
        x = torch.as_tensor(getattr(local, f.name))
        if x.shape[0] != stop - start:
            raise ValueError(f"{f.name}: {x.shape[0]} local rows, this rank owns [{start}, {stop})")
        out[f.name] = x.to(dev)
    return dataclasses.replace(local, **out)
