"""Mini-batch k-means for SH palette clustering, on the device.

The port of ``unitygaussiansplatting_tpu/io/kmeans.py``, the replacement of
the reference's heaviest import step: the mini-batch k-means of the Cluster*
SH formats (package/Editor/Utils/KMeansClustering.cs:15-208, Sculley 2010).

Distances are ``|x|^2 + |c|^2 - 2 x c^T`` in float32, the product a matmul
(TF32 off: ``utils.device.resolve_device`` turns it off), chunked over the
centers; centers are padded to a whole chunk with ``1e17`` rows that never
win.  The per-center batch sums are a stable sort by assignment and float64
prefix sums, and the counts a ``bincount``: no floating-point atomics, so one
seed gives the same palette bit for bit on every run (``index_add_`` on
CUDA adds in whatever order its atomics land).

The randomness is apart from the fit: :func:`fit_kmeans_from_draws` takes
the row indices of its initial candidates, its probe batch and its
mini-batches, and :func:`fit_kmeans` draws them from a ``torch.Generator``.
The JAX package draws from ``jax.random``, which torch cannot reproduce, so
the port's palette is not JAX's for the same seed; fed JAX's draws, the fit
is JAX's.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device

_PAD = 1e17  # padding center coordinate: its distance beats no real center's


def _chunked_argmin_dist(x: torch.Tensor, centers: torch.Tensor, k_chunk: int):
    """Nearest center for each row of x; distances chunked over centers.

    x: (B, D), centers: (K, D) with K % k_chunk == 0.  Returns
    (best_idx (B,) int64, best_dist (B,)); a tie goes to the lower index.
    """
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # (B, 1)
    best_d = torch.full((x.shape[0],), float("inf"), dtype=torch.float32, device=x.device)
    best_i = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    for base in range(0, centers.shape[0], k_chunk):
        c = centers[base : base + k_chunk]
        c_sq = torch.sum(c * c, dim=-1)  # (k_chunk,)
        d = x_sq + c_sq[None, :] - 2.0 * torch.matmul(x, c.T)  # (B, k_chunk)
        dmin, idx = torch.min(d, dim=-1)
        upd = dmin < best_d
        best_d = torch.where(upd, dmin, best_d)
        best_i = torch.where(upd, idx + base, best_i)
    return best_i, best_d


def _pad_centers(centers: torch.Tensor, kpad: int) -> torch.Tensor:
    pad = centers.new_full((kpad - centers.shape[0], centers.shape[1]), _PAD)
    return torch.cat([centers, pad])


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, num: int):
    """Per-segment row sums and counts, (num, D) float32 and (num,) float32,
    in an order fixed by the data: rows sorted stably by segment, float64
    prefix sums differenced at the segment bounds."""
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=num)
    prefix = torch.cumsum(x[order].to(torch.float64), dim=0)
    prefix = torch.cat([prefix.new_zeros((1, x.shape[1])), prefix])
    ends = torch.cumsum(counts, dim=0)
    sums = prefix[ends] - prefix[ends - counts]
    return sums.to(torch.float32), counts.to(torch.float32)


def fit_kmeans_from_draws(
    data: torch.Tensor,
    init_idx: torch.Tensor,
    probe_idx: torch.Tensor,
    batch_idx: torch.Tensor,
    k: int,
    k_chunk: int = 4096,
) -> torch.Tensor:
    """Mini-batch k-means from given draws; returns (k, D) centers.

    ``init_idx`` (attempts, k): the rows of each initial candidate set;
    ``probe_idx`` (P,): the rows that score the candidates (the lowest sum
    of nearest distances wins; a tie goes to the first); ``batch_idx``
    (iters, batch): each step's mini-batch.  Each step assigns its batch and
    moves every center that won a row by Sculley's per-center learning rate
    ``batch_count / total_count`` toward the batch mean of its rows
    (KMeansClustering.cs:508-570's three seedings, the JAX package's
    random-sample seeding and batched update, ``io/kmeans.py:62-120``).
    """
    k_chunk = min(k_chunk, k)
    kpad = -(-k // k_chunk) * k_chunk
    probe = data[probe_idx]
    costs = []
    for idx in init_idx:
        _, dmin = _chunked_argmin_dist(probe, _pad_centers(data[idx], kpad), k_chunk)
        costs.append(torch.sum(dmin))
    centers = _pad_centers(data[init_idx[int(torch.argmin(torch.stack(costs)))]], kpad)
    counts = torch.ones((kpad,), dtype=torch.float32, device=data.device)
    for idx in batch_idx:
        x = data[idx]
        assign, _ = _chunked_argmin_dist(x, centers, k_chunk)
        batch_sums, batch_counts = _segment_sums(x, assign, kpad)
        counts = counts + batch_counts
        won = batch_counts > 0
        lr = torch.where(won, batch_counts / counts, 0.0)[:, None]
        target = torch.where(won[:, None], batch_sums / torch.clamp(batch_counts[:, None], min=1.0), centers)
        centers = centers + lr * (target - centers)
    return centers[:k]


def fit_kmeans(
    data: torch.Tensor,
    k: int,
    seed: int = 0,
    iters: int = 256,
    batch: int = 8192,
    k_chunk: int = 4096,
    init_attempts: int = 3,
) -> torch.Tensor:
    """Mini-batch k-means of ``data`` (N, D) on its device; (k, D) centers.

    Draws :func:`fit_kmeans_from_draws`'s indices from a ``torch.Generator``
    on ``data``'s device seeded with ``seed``: each of ``init_attempts``
    candidate sets is ``k`` distinct rows (with repeats when N < k), the
    probe ``min(4096, N)`` rows, each of ``iters`` mini-batches ``batch``
    rows, all uniform.
    """
    n = data.shape[0]
    dev = data.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randint(*shape):
        return torch.randint(0, n, shape, generator=gen, device=dev)

    if n >= k:
        init_idx = torch.stack([torch.randperm(n, generator=gen, device=dev)[:k] for _ in range(init_attempts)])
    else:
        init_idx = randint(init_attempts, k)
    probe_idx = randint(min(4096, n))
    batch_idx = randint(iters, batch)
    return fit_kmeans_from_draws(data, init_idx, probe_idx, batch_idx, k, k_chunk)


def assign_clusters(
    data: torch.Tensor, centers: torch.Tensor, k_chunk: int = 4096, n_chunk: int = 65536
) -> torch.Tensor:
    """Nearest-center index for every row of data, rows chunked by
    ``n_chunk``; (N,) int64."""
    k = centers.shape[0]
    kc = min(k_chunk, k)
    centers_p = _pad_centers(centers, -(-k // kc) * kc)
    return torch.cat([_chunked_argmin_dist(x, centers_p, kc)[0] for x in torch.split(data, n_chunk)])


def cluster_sh(sh, k: int, seed: int = 0, iters: int = 512, batch: int = 8192, device=None):
    """Cluster (N, 15, 3) SH coefficients into a k-entry palette on
    ``device`` (CUDA unless told otherwise).

    Returns (table (k, 15, 3) float32, indices (N,) int64) on the device:
    the inputs the asset encoder stores for Cluster* formats
    (GaussianSplatAssetCreator.cs:476-518).
    """
    dev = resolve_device(device)
    flat = torch.as_tensor(sh, dtype=torch.float32).to(dev).reshape(-1, 45)
    k_chunk = min(4096, k)
    centers = fit_kmeans(flat, k=k, seed=seed, iters=iters, batch=batch, k_chunk=k_chunk)
    idx = assign_clusters(flat, centers, k_chunk=k_chunk)
    return centers.reshape(k, 15, 3), idx
