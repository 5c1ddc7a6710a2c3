"""Morton (Z-order) encodings used for splat locality.

The port of ``unitygaussiansplatting_tpu/ops/morton.py`` and of the Morton
order its asset creator takes from the native extension
(``unitygaussiansplatting_tpu/native/splat_native.cpp:54-137``):

- the 3D 21-bit-per-axis encode that reorders splats for chunk locality
  (package/Runtime/GaussianUtils.cs:79-95, GaussianSplatAssetCreator.cs:384-429);
- the 2D 16x16 encode/decode of the color texture's swizzle
  (package/Shaders/GaussianSplatting.hlsl:113-127).

The JAX package has two 3D orders that disagree on a few rows in 100,000:
the numpy fallback (:func:`morton_order_np`, coordinates
``(p - min) / extent * (2^21 - 1)`` in float64) and the native extension its
creator loads (``(p - min) * ((2^21 - 1) / extent)`` in float32, clamped,
truncated, then a stable LSD radix argsort).  :func:`morton_order` computes
the native formula on the device and sorts stably, so its permutation is the
native one; :func:`morton_order_plain` is the same formula in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

_COORD_MAX = 2097151.0  # 2^21 - 1
# Part1by2's shift/mask ladder (GaussianUtils.cs:81-90).
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF), (8, 0x100F00F00F00F00F),
           (4, 0x10C30C30C30C30C3), (2, 0x1249249249249249))


def _part1by2_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    for shift, mask in _SPREAD:
        x = (x ^ (x << np.uint64(shift))) & np.uint64(mask)
    return x


def morton_encode3_np(v: np.ndarray) -> np.ndarray:
    """(N, 3) uint 21-bit coords -> (N,) uint64 Morton codes (GaussianUtils.cs:92-95)."""
    return (
        (_part1by2_np(v[..., 2]) << np.uint64(2))
        | (_part1by2_np(v[..., 1]) << np.uint64(1))
        | _part1by2_np(v[..., 0])
    )


def morton_order_np(positions: np.ndarray) -> np.ndarray:
    """The JAX package's numpy Morton order: positions normalized to the
    scene bounds in float64, scaled to 21-bit integer coords, encoded,
    argsorted stably."""
    pmin = positions.min(axis=0)
    pmax = positions.max(axis=0)
    extent = np.maximum(pmax - pmin, 1e-12)
    scaled = (positions - pmin) / extent * float((1 << 21) - 1)
    coords = scaled.astype(np.uint64)
    codes = morton_encode3_np(coords)
    return np.argsort(codes, kind="stable")


def _native_scale(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """Per-axis float32 ``(2^21 - 1) / extent``, 0 on a flat axis
    (splat_native.cpp:74-78)."""
    ext = bmax.astype(np.float32) - bmin.astype(np.float32)
    safe = np.where(ext > np.float32(1e-12), ext, np.float32(1))
    return np.where(ext > np.float32(1e-12), np.float32(_COORD_MAX) / safe, np.float32(0))


def morton_codes_np(positions: np.ndarray) -> np.ndarray:
    """(N, 3) positions -> (N,) uint64 Morton codes by the native formula
    (splat_native.cpp:72-86), in numpy float32."""
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    bmin, bmax = pos.min(axis=0), pos.max(axis=0)
    v = (pos - bmin) * _native_scale(bmin, bmax)
    return morton_encode3_np(np.clip(v, np.float32(0), np.float32(_COORD_MAX)).astype(np.uint64))


def morton_order_plain(positions: np.ndarray) -> np.ndarray:
    """The native Morton order in numpy: :func:`morton_codes_np`, argsorted
    stably (the native LSD radix argsort is stable).  (N,) int64."""
    return np.argsort(morton_codes_np(positions), kind="stable")


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x1FFFFF
    for shift, mask in _SPREAD:
        x = (x ^ (x << shift)) & mask
    return x


def morton_order(positions, device=None) -> torch.Tensor:
    """Permutation sorting splats into 3D Morton order, on ``device`` (CUDA
    unless told otherwise): the native formula's 63-bit codes in int64 (all
    non-negative, so signed order is code order), then a stable sort.  Equal
    to :func:`morton_order_plain`.  (N,) int64 on the device."""
    dev = resolve_device(device)
    pos = torch.as_tensor(positions, dtype=torch.float32).to(dev)
    bmin, bmax = pos.min(dim=0).values, pos.max(dim=0).values
    # The three scales in numpy: IEEE float32 division, as the extension.
    scale = _native_scale(bmin.cpu().numpy(), bmax.cpu().numpy())
    v = (pos - bmin) * torch.from_numpy(scale).to(dev)
    c = torch.clamp(v, 0.0, _COORD_MAX).to(torch.int64)
    codes = (_part1by2(c[:, 2]) << 2) | (_part1by2(c[:, 1]) << 1) | _part1by2(c[:, 0])
    return torch.sort(codes, stable=True).indices


def encode_morton2d_16x16(c: torch.Tensor) -> torch.Tensor:
    """(..., 2) coords in [0,16) -> interleaved 8-bit Morton code (hlsl:113-119)."""
    x = c[..., 0].to(torch.int64)
    y = c[..., 1].to(torch.int64)
    t = ((y & 0xF) << 8) | (x & 0xF)
    t = (t ^ (t << 2)) & 0x3333
    t = (t ^ (t << 1)) & 0x5555
    return (t | (t >> 7)) & 0xFF


def decode_morton2d_16x16(t: torch.Tensor) -> torch.Tensor:
    """8-bit Morton code -> (..., 2) coords in [0,16) (hlsl:120-127)."""
    t = t.to(torch.int64)
    t = (t & 0xFF) | ((t & 0xFE) << 7)
    t = t & 0x5555
    t = (t ^ (t >> 1)) & 0x3333
    t = (t ^ (t >> 2)) & 0x0F0F
    return torch.stack([t & 0xF, t >> 8], dim=-1)


def splat_index_to_texel(idx: torch.Tensor, tex_width: int = 2048) -> torch.Tensor:
    """Splat index -> (..., 2) texel coords in the Morton-swizzled color texture.

    (GaussianSplatting.hlsl:183-194.)  16x16 Morton blocks tiled row-major
    across a ``tex_width``-wide texture.
    """
    idx = idx.to(torch.int64)
    xy = decode_morton2d_16x16(idx)
    width = tex_width // 16
    block = idx >> 8
    x = (block % width) * 16 + xy[..., 0]
    y = (block // width) * 16 + xy[..., 1]
    return torch.stack([x, y], dim=-1)
