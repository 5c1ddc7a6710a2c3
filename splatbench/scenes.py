"""The benchmark's scenes and targets, drawn on the device from ``--seed``.

``outdoor_scene`` draws the distributions of the port's host generator
``utils/synthetic.outdoor_scene`` (a bicycle-class capture's statistics) in
a few large calls of a seeded ``torch.Generator``: a dense foreground
cluster, a ground plane, a sparse far shell, log-normal scales over about
three decades and a bimodal opacity.  The same distributions, not the same
bits.  The copy lives here so that the benchmark's input stays put when the
program's generator changes.

The cloud comes back in Morton order of its positions, as an importer
leaves a captured scene (``GaussianSplatAssetCreator.cs`` reorders before it
chunks), so that a Medium asset's 256-splat chunks are spatially coherent.
Both sides of the comparison (the program and ``reference/``) take the
cloud from here.
"""

from __future__ import annotations

import math

import torch

RAW_FIELDS = ("means", "rotations_wxyz", "log_scales", "opacity_logits", "sh0", "sh")
MORTON_BITS = 21  # per axis: a 63-bit code


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of ``seed`` (any
    whole number, folded into 64 bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + stream * 0x85EBCA77) % (2**63))
    return gen


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """21-bit integers with two zero bits after each bit (int64)."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def morton_order(means: torch.Tensor) -> torch.Tensor:
    """Indices that put ``means`` (N, 3) in Morton order over their bounding box."""
    lo = means.amin(0)
    span = torch.clamp(means.amax(0) - lo, min=1e-12)
    q = torch.clamp(((means - lo) / span * (2**MORTON_BITS - 1)).to(torch.int64), 0, 2**MORTON_BITS - 1)
    code = _spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1) | (_spread_bits(q[:, 2]) << 2)
    return torch.sort(code, stable=True).indices


@torch.no_grad()
def outdoor_scene(n: int, seed: int, device) -> dict[str, torch.Tensor]:
    """The raw (pre-activation) cloud of ``n`` splats: a dict of the 3DGS
    PLY fields ``RAW_FIELDS`` as float32 tensors on ``device``."""
    gen = generator(seed, device)
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    n_fg = int(n * 0.55)
    n_ground = int(n * 0.25)
    n_bg = n - n_fg - n_ground

    def uniform(lo, hi, *shape):
        return torch.rand(shape, **f32) * (hi - lo) + lo

    fg = torch.randn(n_fg, 3, **f32) * torch.tensor([1.2, 0.8, 1.2], device=device)
    ground = torch.stack(
        [uniform(-12, 12, n_ground), -0.8 + 0.05 * torch.randn(n_ground, **f32), uniform(-12, 12, n_ground)], dim=1
    )
    dirs = torch.randn(n_bg, 3, **f32)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    r_bg = uniform(8.0, 30.0, n_bg, 1)
    means = torch.cat([fg, ground, dirs * r_bg])

    # Medians ~1.5 cm foreground, 4 cm ground; the far shell proportional to
    # distance (a constant angular size); mild flattening everywhere.
    log_scales = torch.cat([
        torch.randn(n_fg, 3, **f32) * 0.9 + math.log(0.015),
        torch.randn(n_ground, 3, **f32) * 0.7 + math.log(0.04),
        torch.log(r_bg * 0.02) + torch.randn(n_bg, 3, **f32) * 0.5,
    ])
    log_scales[:, 1] -= uniform(0.0, 1.5, n)

    solid = torch.rand(n, **f32) < 0.5
    opacity_logits = torch.where(solid, uniform(0.5, 6.0, n), uniform(-4.5, 0.5, n))
    rot = torch.randn(n, 4, **f32)
    sh0 = uniform(-1.2, 1.8, n, 3)
    sh = 0.15 * torch.randn(n, 15, 3, **f32)

    order = morton_order(means)
    fields = dict(means=means, rotations_wxyz=rot, log_scales=log_scales, opacity_logits=opacity_logits,
                  sh0=sh0, sh=sh)
    return {k: v.index_select(0, order).contiguous() for k, v in fields.items()}


@torch.no_grad()
def targets(count: int, width: int, height: int, seed: int, device) -> torch.Tensor:
    """``count`` seeded (H, W, 3) linear RGB training targets in [0, 1)."""
    return torch.rand((count, height, width, 3), generator=generator(seed, device, stream=1), device=device,
                      dtype=torch.float32)
