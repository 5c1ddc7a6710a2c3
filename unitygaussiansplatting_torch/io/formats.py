"""Asset format definitions: quantization formats, sizes, quality presets.

A copy of ``unitygaussiansplatting_tpu/io/formats.py``.  Mirror of the
reference's asset data model
(package/Runtime/GaussianSplatAsset.cs:31-101,135-203) so that blob layouts
are byte-compatible and the reference's published compression/PSNR numbers
(package/Editor/GaussianSplatAssetCreator.cs:189-228) apply directly.
"""

from __future__ import annotations

import dataclasses
import enum

CHUNK_SIZE = 256  # GaussianSplatAsset.cs:14
TEXTURE_WIDTH = 2048  # GaussianSplatAsset.cs:15
FORMAT_VERSION = 2023_10_20  # GaussianSplatAsset.cs:13


class VectorFormat(enum.IntEnum):
    """Matches VECTOR_FMT_* in HLSL (GaussianSplatAsset.cs:31-37)."""

    Float32 = 0  # 12 bytes
    Norm16 = 1  # 6 bytes: 16.16.16
    Norm11 = 2  # 4 bytes: 11.10.11
    Norm6 = 3  # 2 bytes: 6.5.5


VECTOR_SIZE = {
    VectorFormat.Float32: 12,
    VectorFormat.Norm16: 6,
    VectorFormat.Norm11: 4,
    VectorFormat.Norm6: 2,
}


class ColorFormat(enum.IntEnum):
    """GaussianSplatAsset.cs:51-57."""

    Float32x4 = 0  # 16 B/px
    Float16x4 = 1  # 8 B/px
    Norm8x4 = 2  # 4 B/px
    BC7 = 3  # 1 B/px (needs a BC7 codec, which the port does not have yet)


COLOR_SIZE = {
    ColorFormat.Float32x4: 16,
    ColorFormat.Float16x4: 8,
    ColorFormat.Norm8x4: 4,
    ColorFormat.BC7: 1,
}


class SHFormat(enum.IntEnum):
    """GaussianSplatAsset.cs:70-81."""

    Float32 = 0
    Float16 = 1
    Norm11 = 2
    Norm6 = 3
    Cluster64k = 4
    Cluster32k = 5
    Cluster16k = 6
    Cluster8k = 7
    Cluster4k = 8


SH_CLUSTER_COUNT = {
    SHFormat.Cluster64k: 64 * 1024,
    SHFormat.Cluster32k: 32 * 1024,
    SHFormat.Cluster16k: 16 * 1024,
    SHFormat.Cluster8k: 8 * 1024,
    SHFormat.Cluster4k: 4 * 1024,
}

# Per-entry strides of the SH tables, incl. padding
# (GaussianSplatAsset.cs:83-101, GaussianSplatting.hlsl:451-459).
SH_STRIDE = {
    SHFormat.Float32: 192,  # 16 x float3 (15 + padding)
    SHFormat.Float16: 96,
    SHFormat.Norm11: 60,  # 15 x uint
    SHFormat.Norm6: 32,  # 15 x ushort + pad
}


def is_cluster_format(fmt: SHFormat) -> bool:
    return fmt >= SHFormat.Cluster64k


def sh_count(fmt: SHFormat, splat_count: int) -> int:
    """Entries in the SH table (GaussianSplatAsset.cs:135-150)."""
    return SH_CLUSTER_COUNT.get(fmt, splat_count)


def texture_size(splat_count: int) -> tuple[int, int]:
    """Color texture dims: 2048 wide, height in 16-row blocks (cs:152-160)."""
    width = TEXTURE_WIDTH
    height = max(1, (splat_count + width - 1) // width)
    height = (height + 15) // 16 * 16
    return width, height


def other_stride(scale_format: VectorFormat, has_sh_index: bool) -> int:
    """Bytes per splat in the 'other' blob: rot + scale + optional SH idx."""
    return 4 + VECTOR_SIZE[scale_format] + (2 if has_sh_index else 0)


@dataclasses.dataclass(frozen=True)
class QualityPreset:
    pos: VectorFormat
    scale: VectorFormat
    color: ColorFormat
    sh: SHFormat


# Reference presets with measured ratio / PSNR
# (GaussianSplatAssetCreator.cs:195-223).  VeryLow uses BC7 like the
# reference; the port cannot encode or decode it until it has a BC7 codec.
QUALITY_PRESETS = {
    "very_low": QualityPreset(
        VectorFormat.Norm11, VectorFormat.Norm6, ColorFormat.BC7, SHFormat.Cluster4k
    ),
    "low": QualityPreset(
        VectorFormat.Norm11, VectorFormat.Norm6, ColorFormat.Norm8x4, SHFormat.Cluster16k
    ),
    "medium": QualityPreset(
        VectorFormat.Norm11, VectorFormat.Norm11, ColorFormat.Norm8x4, SHFormat.Norm6
    ),
    "high": QualityPreset(
        VectorFormat.Norm16, VectorFormat.Norm16, ColorFormat.Float16x4, SHFormat.Norm11
    ),
    "very_high": QualityPreset(
        VectorFormat.Float32, VectorFormat.Float32, ColorFormat.Float32x4, SHFormat.Float32
    ),
}


def uses_chunks(preset_or_pos: VectorFormat, scale: VectorFormat, color: ColorFormat, sh: SHFormat) -> bool:
    """Chunking is skipped only for the fully lossless configuration
    (GaussianSplatAssetCreator.cs:307-310)."""
    return not (
        preset_or_pos == VectorFormat.Float32
        and scale == VectorFormat.Float32
        and color == ColorFormat.Float32x4
        and sh == SHFormat.Float32
    )
