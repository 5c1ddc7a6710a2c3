"""Bit-packed vector codecs of the quantized asset format.

The reference's packed decoders and encoders
(package/Shaders/GaussianSplatting.hlsl:261-304,
package/Editor/GaussianSplatAssetCreator.cs:705-725).  Encode uses the
reference's ``(uint)(x * (scale + 0.5))``, which rounds to nearest for
in-range values.

Words: PyTorch has no ``uint32`` arithmetic on CUDA for every operation, so a
u32 word is the ``int32`` with the same bits (as ``io/device_asset.py``
holds them).  Encoders build words in ``int64`` and fold them into the
signed range; decoders mask after every right shift, so the sign bit is an
ordinary bit.
"""

from __future__ import annotations

import torch

from .tile_common import true_div


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """u32 values (int64, 0 .. 2^32 - 1) -> the int32 with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def as_i16(v: torch.Tensor) -> torch.Tensor:
    """u16 values (0 .. 65535) -> the int16 with the same bits."""
    return (((v + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)


def _enc(x: torch.Tensor, maxv: float) -> torch.Tensor:
    return torch.clamp(x * (maxv + 0.5), 0.0, maxv).to(torch.int64)


def _dec(enc: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    mask = (1 << bits) - 1
    return true_div(((enc.to(torch.int64) >> shift) & mask).to(torch.float32), float(mask))


def encode_11_10_11(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) floats in [0, 1] -> u32 word (GaussianSplatAssetCreator.cs:705-711)."""
    return as_i32(_enc(v[..., 0], 2047.0) | (_enc(v[..., 1], 1023.0) << 11) | (_enc(v[..., 2], 2047.0) << 21))


def decode_11_10_11(enc: torch.Tensor) -> torch.Tensor:
    """u32 word -> (..., 3) floats in [0, 1] (GaussianSplatting.hlsl:277-283)."""
    return torch.stack([_dec(enc, 0, 11), _dec(enc, 11, 10), _dec(enc, 21, 11)], dim=-1)


def encode_6_5_5(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) floats in [0, 1] -> 16-bit code in a word (AssetCreator.cs:713-719)."""
    return (_enc(v[..., 0], 63.0) | (_enc(v[..., 1], 31.0) << 6) | (_enc(v[..., 2], 31.0) << 11)).to(torch.int32)


def decode_6_5_5(enc: torch.Tensor) -> torch.Tensor:
    """Word -> (..., 3) floats in [0, 1] (GaussianSplatting.hlsl:261-267)."""
    return torch.stack([_dec(enc, 0, 6), _dec(enc, 6, 5), _dec(enc, 11, 5)], dim=-1)


def encode_5_6_5(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) floats in [0, 1] -> 16-bit code in a word, the SH Norm6 layout."""
    return (_enc(v[..., 0], 31.0) | (_enc(v[..., 1], 63.0) << 5) | (_enc(v[..., 2], 31.0) << 11)).to(torch.int32)


def decode_5_6_5(enc: torch.Tensor) -> torch.Tensor:
    """Word -> (..., 3) floats in [0, 1] (GaussianSplatting.hlsl:269-275)."""
    return torch.stack([_dec(enc, 0, 5), _dec(enc, 5, 6), _dec(enc, 11, 5)], dim=-1)


def encode_16_16_16(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) floats in [0, 1] -> (..., 2) u32 words, 48-bit Norm16."""
    x, y, z = (_enc(v[..., i], 65535.0) for i in range(3))
    return torch.stack([as_i32(x | (y << 16)), z.to(torch.int32)], dim=-1)


def decode_16_16_16(enc: torch.Tensor) -> torch.Tensor:
    """(..., 2) u32 words -> (..., 3) floats (GaussianSplatting.hlsl:285-291)."""
    w0, w1 = enc[..., 0], enc[..., 1]
    return torch.stack([_dec(w0, 0, 16), _dec(w0, 16, 16), _dec(w1, 0, 16)], dim=-1)


def encode_10_10_10_2(v: torch.Tensor) -> torch.Tensor:
    """(..., 4) floats in [0, 1] -> u32 word, the rotation codec (hlsl:301-304)."""
    x, y, z = (_enc(v[..., i], 1023.0) for i in range(3))
    return as_i32(x | (y << 10) | (z << 20) | (_enc(v[..., 3], 3.0) << 30))


def decode_10_10_10_2(enc: torch.Tensor) -> torch.Tensor:
    """u32 word -> (..., 4) floats in [0, 1] (GaussianSplatting.hlsl:293-300)."""
    return torch.stack([_dec(enc, 0, 10), _dec(enc, 10, 10), _dec(enc, 20, 10), _dec(enc, 30, 2)], dim=-1)


def f32_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 word holding the IEEE fp16 bit pattern (f32tof16)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def f16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Word holding fp16 bits in its low half -> float32 (f16tof32)."""
    return as_i16(bits.to(torch.int64) & 0xFFFF).view(torch.float16).to(torch.float32)


def float_to_sortable_uint(f: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> u32 word for radix sort keys: all bits of
    a negative flipped, the sign bit of a positive (SplatUtilities.compute:51-57)."""
    fu = f.to(torch.float32).contiguous().view(torch.int32)
    return fu ^ torch.where(fu < 0, -1, torch.iinfo(torch.int32).min).to(torch.int32)


def sortable_uint_to_float(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_to_sortable_uint`."""
    mask = torch.where(u < 0, torch.iinfo(torch.int32).min, -1).to(torch.int32)
    return (u.to(torch.int32) ^ mask).view(torch.float32)
