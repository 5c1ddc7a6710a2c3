"""Synthetic test scenes.

Procedurally generated clouds with known statistics stand in for captured
scenes (bicycle/truck/garden), which are not distributable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.gaussians import RawGaussians
from .device import resolve_device


def sphere_scene(
    n: int = 10_000,
    radius: float = 1.0,
    seed: int = 0,
    sh_bands: bool = True,
) -> RawGaussians:
    """Random splats on a sphere shell with varied scale/orientation/color.

    Host numpy generation, bit-identical to the JAX package's
    ``utils.synthetic.sphere_scene`` for the same arguments; returns CPU
    tensors.
    """
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = radius * (1.0 + 0.05 * rng.normal(size=(n, 1)))
    means = (dirs * radii).astype(np.float32)

    rot = rng.normal(size=(n, 4)).astype(np.float32)  # unnormalized wxyz
    log_scales = rng.uniform(np.log(0.005), np.log(0.05), size=(n, 3)).astype(np.float32)
    opacity_logits = rng.uniform(-2.0, 3.0, size=(n,)).astype(np.float32)
    sh0 = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    if sh_bands:
        sh = (0.2 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    else:
        sh = np.zeros((n, 15, 3), dtype=np.float32)
    return RawGaussians(
        means=torch.from_numpy(means),
        rotations_wxyz=torch.from_numpy(rot),
        log_scales=torch.from_numpy(log_scales),
        opacity_logits=torch.from_numpy(opacity_logits),
        sh0=torch.from_numpy(sh0),
        sh=torch.from_numpy(sh),
    )


def sphere_scene_device(
    n: int = 10_000,
    radius: float = 1.0,
    seed: int = 0,
    sh_bands: bool = True,
    device=None,
) -> RawGaussians:
    """:func:`sphere_scene`'s distributions drawn on ``device`` (CUDA unless
    told otherwise) from a seeded ``torch.Generator``.

    Statistically the same scene, not the same bits: a full-size scene is
    generated in milliseconds on the card instead of minutes of host numpy.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def uniform(lo, hi, *shape):
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return u * (hi - lo) + lo

    dirs = normal(n, 3)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    radii = radius * (1.0 + 0.05 * normal(n, 1))
    log_scales = uniform(math.log(0.005), math.log(0.05), n, 3)
    rot = normal(n, 4)
    opacity_logits = uniform(-2.0, 3.0, n)
    sh0 = uniform(-1.5, 1.5, n, 3)
    if sh_bands:
        sh = 0.2 * normal(n, 15, 3)
    else:
        sh = torch.zeros((n, 15, 3), device=dev, dtype=torch.float32)
    return RawGaussians(
        means=dirs * radii,
        rotations_wxyz=rot,
        log_scales=log_scales,
        opacity_logits=opacity_logits,
        sh0=sh0,
        sh=sh,
    )
