"""Chunked quantized splat asset: encode, decode, save, load.

The port of ``unitygaussiansplatting_tpu/io/asset.py``, numpy like it, with
blobs byte-identical to its: the five blobs ``{chk,pos,oth,col,shs}`` written
by the reference's asset creator
(package/Editor/GaussianSplatAssetCreator.cs:301-315,520-1066) and decoded by
its runtime (package/Shaders/GaussianSplatting.hlsl:394-608).

Quantization scheme (per 256-splat chunk, GaussianSplatAssetCreator.cs:520-658):
- scale is warped by pow(1/8) and opacity by SquareCentered01 before
  normalization (decode applies scale^8 / InvSquareCentered01,
  GaussianSplatting.hlsl:578-583),
- each field is normalized to [0,1] against its chunk min/max (pos min/max
  stored f32, others f16),
- normalized values are bit-packed per the VectorFormat/ColorFormat/SHFormat.

BC7 color goes through ``io/bc7.py``.  Cluster SH formats take
``sh_indices`` / ``sh_table`` from the caller (``io/kmeans.cluster_sh``, as
``io/creator.create_asset`` does).  The renderer consumes either the decoded
float arrays or the packed words on the device (``io/device_asset.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from . import formats as F
from .bc7 import decode_bc7, encode_bc7

_SQRT2 = 1.4142135623730951


def square_centered01(x):
    """``ops.activations.square_centered01`` on a numpy array, in float32."""
    x = np.asarray(x, np.float32) - np.float32(0.5)
    x = x * x * np.sign(x)
    return x * np.float32(2.0) + np.float32(0.5)


def inv_square_centered01(x):
    """``ops.activations.inv_square_centered01`` on a numpy array, in float32."""
    x = np.asarray(x, np.float32) - np.float32(0.5)
    x = x * np.float32(0.5)
    x = np.sqrt(np.abs(x)) * np.sign(x)
    return x + np.float32(0.5)


# ---------------------------------------------------------------------------
# numpy codec helpers (mirror ops/packing.py on the import path)


def _enc(x, maxv):
    return np.clip(x * (maxv + 0.5), 0.0, maxv).astype(np.uint32)


def _sat(x):
    return np.clip(x, 0.0, 1.0)


def enc_norm11(v):  # (N, 3) -> (N,) uint32
    v = _sat(v)
    return _enc(v[..., 0], 2047) | (_enc(v[..., 1], 1023) << 11) | (_enc(v[..., 2], 2047) << 21)


def dec_norm11(u):  # (N,) uint32 -> (N, 3) f32
    return np.stack(
        [
            (u & 2047) / 2047.0,
            ((u >> 11) & 1023) / 1023.0,
            ((u >> 21) & 2047) / 2047.0,
        ],
        axis=-1,
    ).astype(np.float32)


def enc_norm655(v):  # (N, 3) -> (N,) uint16
    v = _sat(v)
    return (
        _enc(v[..., 0], 63) | (_enc(v[..., 1], 31) << 6) | (_enc(v[..., 2], 31) << 11)
    ).astype(np.uint16)


def dec_norm655(u):
    u = u.astype(np.uint32)
    return np.stack(
        [(u & 63) / 63.0, ((u >> 6) & 31) / 31.0, ((u >> 11) & 31) / 31.0], axis=-1
    ).astype(np.float32)


def enc_norm565(v):  # SH Norm6 codec
    v = _sat(v)
    return (
        _enc(v[..., 0], 31) | (_enc(v[..., 1], 63) << 5) | (_enc(v[..., 2], 31) << 11)
    ).astype(np.uint16)


def dec_norm565(u):
    u = u.astype(np.uint32)
    return np.stack(
        [(u & 31) / 31.0, ((u >> 5) & 63) / 63.0, ((u >> 11) & 31) / 31.0], axis=-1
    ).astype(np.float32)


def enc_norm16x3(v):  # (N, 3) -> (N, 3) uint16
    v = _sat(v)
    return np.clip(v * 65535.5, 0, 65535).astype(np.uint16)


def dec_norm16x3(u):
    return (u / 65535.0).astype(np.float32)


def enc_quat_norm10(v):  # (N, 4) in [0,1] -> (N,) uint32
    v = _sat(v)
    return (
        _enc(v[..., 0], 1023)
        | (_enc(v[..., 1], 1023) << 10)
        | (_enc(v[..., 2], 1023) << 20)
        | (_enc(v[..., 3], 3) << 30)
    )


def dec_quat_norm10(u):
    return np.stack(
        [
            (u & 1023) / 1023.0,
            ((u >> 10) & 1023) / 1023.0,
            ((u >> 20) & 1023) / 1023.0,
            ((u >> 30) & 3) / 3.0,
        ],
        axis=-1,
    ).astype(np.float32)


def f16_pair(lo, hi):  # two f32 arrays -> uint32 (f16 bits lo | hi << 16)
    lo16 = lo.astype(np.float16).view(np.uint16).astype(np.uint32)
    hi16 = hi.astype(np.float16).view(np.uint16).astype(np.uint32)
    return lo16 | (hi16 << 16)


def f16_pair_split(u):  # uint32 -> (lo, hi) f32
    lo = (u & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = ((u >> 16) & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    return lo, hi


def pack_smallest3_np(q):
    """xyzw quaternions -> smallest-three [0,1]^4 (GaussianUtils.cs:46-76)."""
    absq = np.abs(q)
    idx = np.argmax(absq, axis=-1)
    order = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
    three = np.take_along_axis(q, order[idx], axis=-1)
    largest = np.take_along_axis(q, idx[..., None], axis=-1)
    three = three * np.where(largest >= 0, 1.0, -1.0)
    three = three * _SQRT2 * 0.5 + 0.5
    return np.concatenate([three, idx[..., None] / 3.0], axis=-1).astype(np.float32)


def unpack_smallest3_np(pq):
    """Smallest-three -> xyzw (GaussianSplatting.hlsl:219-229)."""
    idx = np.rint(pq[..., 3] * 3.0).astype(np.int64)
    three = pq[..., :3] * _SQRT2 - (1.0 / _SQRT2)
    largest = np.sqrt(np.maximum(0.0, 1.0 - np.sum(three * three, axis=-1)))
    n = pq.shape[0]
    out = np.empty((n, 4), np.float32)
    a, b, c = three[..., 0], three[..., 1], three[..., 2]
    for i, cols in enumerate([(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]):
        m = idx == i
        out[m, i] = largest[m]
        out[m, cols[0]] = a[m]
        out[m, cols[1]] = b[m]
        out[m, cols[2]] = c[m]
    return out


def morton_texel_index(n: int) -> np.ndarray:
    """Splat index -> flattened texel index in the swizzled color texture
    (GaussianSplatAssetCreator.cs:863-871)."""
    idx = np.arange(n, dtype=np.uint32)
    t = idx & 0xFF
    t = (t | (t << 7)) & 0x5555
    t = (t ^ (t >> 1)) & 0x3333
    t = (t ^ (t >> 2)) & 0x0F0F
    x16 = t & 0xF
    y16 = t >> 8
    width = F.TEXTURE_WIDTH // 16
    block = idx >> 8
    x = (block % width) * 16 + x16
    y = (block // width) * 16 + y16
    return (y * F.TEXTURE_WIDTH + x).astype(np.int64)


# ---------------------------------------------------------------------------
# Asset container


@dataclasses.dataclass
class GaussianSplatAssetData:
    """In-memory asset: metadata + the five raw blobs (reference layouts)."""

    splat_count: int
    pos_format: F.VectorFormat
    scale_format: F.VectorFormat
    color_format: F.ColorFormat
    sh_format: F.SHFormat
    bounds_min: np.ndarray  # (3,) f32
    bounds_max: np.ndarray
    chunk_blob: bytes  # empty when lossless/unchunked
    pos_blob: bytes
    other_blob: bytes
    color_blob: bytes
    sh_blob: bytes
    cameras: list | None = None
    data_hash: str = ""

    @property
    def has_chunks(self) -> bool:
        return len(self.chunk_blob) > 0

    @property
    def has_sh_index(self) -> bool:
        return F.is_cluster_format(self.sh_format)

    def total_bytes(self) -> int:
        return (
            len(self.chunk_blob)
            + len(self.pos_blob)
            + len(self.other_blob)
            + len(self.color_blob)
            + len(self.sh_blob)
        )


@dataclasses.dataclass
class InputSplats:
    """Canonical float splat arrays, the analog of ``InputSplatData``
    (GaussianFileReader.cs:17-26) after activation/linearization."""

    pos: np.ndarray  # (N, 3) f32
    rot: np.ndarray  # (N, 4) f32 smallest-three packed [0,1]
    scale: np.ndarray  # (N, 3) f32 linear scale
    color: np.ndarray  # (N, 3) f32 base color (SH0-mapped)
    opacity: np.ndarray  # (N,) f32 in [0,1]
    sh: np.ndarray  # (N, 15, 3) f32

    @property
    def count(self) -> int:
        return self.pos.shape[0]


def _encode_vector_blob(v01: np.ndarray, fmt: F.VectorFormat) -> bytes:
    if fmt == F.VectorFormat.Float32:
        return v01.astype("<f4").tobytes()
    if fmt == F.VectorFormat.Norm16:
        return enc_norm16x3(v01).astype("<u2").tobytes()
    if fmt == F.VectorFormat.Norm11:
        return enc_norm11(v01).astype("<u4").tobytes()
    if fmt == F.VectorFormat.Norm6:
        return enc_norm655(v01).astype("<u2").tobytes()
    raise ValueError(fmt)


def _decode_vector_blob(blob: memoryview, n: int, fmt: F.VectorFormat) -> np.ndarray:
    if fmt == F.VectorFormat.Float32:
        return np.frombuffer(blob, "<f4", n * 3).reshape(n, 3).astype(np.float32)
    if fmt == F.VectorFormat.Norm16:
        u = np.frombuffer(blob, "<u2", n * 3).reshape(n, 3)
        return dec_norm16x3(u)
    if fmt == F.VectorFormat.Norm11:
        return dec_norm11(np.frombuffer(blob, "<u4", n))
    if fmt == F.VectorFormat.Norm6:
        return dec_norm655(np.frombuffer(blob, "<u2", n))
    raise ValueError(fmt)


def encode_asset(
    splats: InputSplats,
    pos_format: F.VectorFormat = F.VectorFormat.Norm11,
    scale_format: F.VectorFormat = F.VectorFormat.Norm11,
    color_format: F.ColorFormat = F.ColorFormat.Norm8x4,
    sh_format: F.SHFormat = F.SHFormat.Norm6,
    sh_indices: np.ndarray | None = None,
    sh_table: np.ndarray | None = None,
    cameras: list | None = None,
    bc7_mode7: bool = True,
) -> GaussianSplatAssetData:
    """Quantize canonical splats into the chunked blob asset.

    ``sh_indices``/``sh_table`` must be provided for cluster SH formats (the
    output of ``io/kmeans.cluster_sh``); the table is stored fp16
    (GaussianSplatAssetCreator.cs:1046-1051).

    ``bc7_mode7`` controls the BC7 encoder's two-subset partition search
    (only relevant for ColorFormat.BC7): it buys ~0.7 dB of color PSNR and
    costs ~12x the encode time; pass False for fast imports.
    """
    n = splats.count
    use_chunks = F.uses_chunks(pos_format, scale_format, color_format, sh_format)
    is_cluster = F.is_cluster_format(sh_format)
    if is_cluster and (sh_indices is None or sh_table is None):
        raise ValueError("cluster SH formats need sh_indices and sh_table")

    pos = splats.pos.astype(np.float32).copy()
    scale = splats.scale.astype(np.float32).copy()
    color = splats.color.astype(np.float32).copy()
    opacity = splats.opacity.astype(np.float32).copy()
    sh = splats.sh.astype(np.float32).copy()
    bounds_min = pos.min(axis=0)
    bounds_max = pos.max(axis=0)

    chunk_blob = b""
    if use_chunks:
        # Warps before chunk normalization (GaussianSplatAssetCreator.cs:546-548).
        scale = np.power(np.maximum(scale, 0.0), 1.0 / 8.0)
        opacity = np.asarray(square_centered01(opacity))

        num_chunks = (n + F.CHUNK_SIZE - 1) // F.CHUNK_SIZE
        pad = num_chunks * F.CHUNK_SIZE - n

        def chunked(a, fill):
            if pad:
                a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            return a.reshape(num_chunks, F.CHUNK_SIZE, *a.shape[1:])

        # Padding uses the first element of the last chunk so min/max are
        # unaffected.
        cpos = chunked(pos, 0.0)
        cscl = chunked(scale, 0.0)
        ccol = chunked(color, 0.0)
        copa = chunked(opacity, 0.0)
        csh = chunked(sh, 0.0)
        if pad:
            for arr, src in ((cpos, pos), (cscl, scale), (ccol, color), (csh, sh)):
                arr[-1, -pad:] = arr[-1, 0]
            copa[-1, -pad:] = copa[-1, 0]

        eps = 1.0e-5
        pmin, pmax = cpos.min(1), cpos.max(1)
        smin, smax = cscl.min(1), cscl.max(1)
        col4 = np.concatenate([ccol, copa[..., None]], axis=-1)
        cmin, cmax = col4.min(1), col4.max(1)
        shmin = csh.min(axis=(1, 2))
        shmax = csh.max(axis=(1, 2))
        pmax = np.maximum(pmax, pmin + eps)
        smax = np.maximum(smax, smin + eps)
        cmax = np.maximum(cmax, cmin + eps)
        shmax = np.maximum(shmax, shmin + eps)

        # ChunkInfo layout, 64 B = 16 uint32 words (GaussianSplatAsset.cs:231-237):
        # [0..3] colR..colA f16 pairs, [4..9] posX/Y/Z float2 min/max,
        # [10..12] sclX/Y/Z f16 pairs, [13..15] shR/G/B f16 pairs.
        info = np.empty((num_chunks, 16), np.uint32)
        for i in range(4):
            info[:, i] = f16_pair(cmin[:, i], cmax[:, i])
        pos_pairs = np.empty((num_chunks, 3, 2), np.float32)
        pos_pairs[:, :, 0] = pmin
        pos_pairs[:, :, 1] = pmax
        info[:, 4:10] = pos_pairs.reshape(num_chunks, 6).view(np.uint32)
        for i in range(3):
            info[:, 10 + i] = f16_pair(smin[:, i], smax[:, i])
            info[:, 13 + i] = f16_pair(shmin[:, i], shmax[:, i])
        chunk_blob = info.astype("<u4").tobytes()

        # Normalize each splat to [0,1] within its chunk (cs:613-637).
        rep = lambda a: np.repeat(a, F.CHUNK_SIZE, axis=0)[:n]
        pos = (pos - rep(pmin)) / (rep(pmax) - rep(pmin))
        scale = (scale - rep(smin)) / (rep(smax) - rep(smin))
        color = (color - rep(cmin[:, :3])) / (rep(cmax[:, :3]) - rep(cmin[:, :3]))
        opacity = (opacity - rep(cmin[:, 3])) / (rep(cmax[:, 3]) - rep(cmin[:, 3]))
        if sh_format in (F.SHFormat.Norm11, F.SHFormat.Norm6):
            shmin_r = rep(shmin)[:, None, :]  # (n, 1, 3) per-channel bounds
            shmax_r = rep(shmax)[:, None, :]
            sh = (sh - shmin_r) / (shmax_r - shmin_r)

    # pos blob
    pos_blob = _encode_vector_blob(pos, pos_format)

    # other blob: rot(4B) + scale + optional SH index
    stride = F.other_stride(scale_format, is_cluster)
    other = np.zeros((n, stride), np.uint8)
    other[:, 0:4] = enc_quat_norm10(splats.rot).astype("<u4")[:, None].view(np.uint8)
    ssz = F.VECTOR_SIZE[scale_format]
    scale_bytes = np.frombuffer(_encode_vector_blob(scale, scale_format), np.uint8)
    other[:, 4 : 4 + ssz] = scale_bytes.reshape(n, ssz)
    if is_cluster:
        other[:, 4 + ssz : 6 + ssz] = (
            sh_indices.astype("<u2")[:, None].view(np.uint8)
        )
    other_blob = other.tobytes()

    # color blob: morton-swizzled texture
    width, height = F.texture_size(n)
    tex = np.zeros((width * height, 4), np.float32)
    tex[morton_texel_index(n)] = np.concatenate([color, opacity[:, None]], axis=-1)
    if color_format == F.ColorFormat.Float32x4:
        color_blob = tex.astype("<f4").tobytes()
    elif color_format == F.ColorFormat.Float16x4:
        color_blob = tex.astype("<f2").tobytes()
    elif color_format == F.ColorFormat.Norm8x4:
        t = _sat(tex)
        enc = np.clip(t * 255.5, 0, 255).astype(np.uint8)
        color_blob = enc.tobytes()
    elif color_format == F.ColorFormat.BC7:
        enc = np.clip(_sat(tex) * 255.5, 0, 255).astype(np.uint8)
        color_blob = encode_bc7(enc.reshape(height, width, 4), mode7=bc7_mode7)
    else:
        raise ValueError(color_format)

    # sh blob
    if is_cluster:
        table = sh_table.astype(np.float32).reshape(-1, 45)
        padded = np.zeros((table.shape[0], 48), np.float32)
        padded[:, :45] = table
        sh_blob = padded.astype("<f2").tobytes()
    elif sh_format == F.SHFormat.Float32:
        padded = np.zeros((n, 48), np.float32)
        padded[:, :45] = sh.reshape(n, 45)
        sh_blob = padded.astype("<f4").tobytes()
    elif sh_format == F.SHFormat.Float16:
        padded = np.zeros((n, 48), np.float32)
        padded[:, :45] = sh.reshape(n, 45)
        sh_blob = padded.astype("<f2").tobytes()
    elif sh_format == F.SHFormat.Norm11:
        sh_blob = enc_norm11(sh.reshape(n * 15, 3)).reshape(n, 15).astype("<u4").tobytes()
    elif sh_format == F.SHFormat.Norm6:
        enc = enc_norm565(sh.reshape(n * 15, 3)).reshape(n, 15)
        padded = np.zeros((n, 16), np.uint16)
        padded[:, :15] = enc
        sh_blob = padded.astype("<u2").tobytes()
    else:
        raise ValueError(sh_format)

    h = hashlib.sha256()
    for b in (chunk_blob, pos_blob, other_blob, color_blob, sh_blob):
        h.update(b)

    return GaussianSplatAssetData(
        splat_count=n,
        pos_format=pos_format,
        scale_format=scale_format,
        color_format=color_format,
        sh_format=sh_format,
        bounds_min=bounds_min,
        bounds_max=bounds_max,
        chunk_blob=chunk_blob,
        pos_blob=pos_blob,
        other_blob=other_blob,
        color_blob=color_blob,
        sh_blob=sh_blob,
        cameras=cameras,
        data_hash=h.hexdigest(),
    )


def decode_asset(asset: GaussianSplatAssetData) -> InputSplats:
    """Decode an asset back to canonical float splats.

    Mirrors LoadSplatData (GaussianSplatting.hlsl:428-608): format decode,
    chunk min/max lerp, scale^8 reconstruction, opacity inverse warp.
    """
    n = asset.splat_count
    pos = _decode_vector_blob(memoryview(asset.pos_blob), n, asset.pos_format)

    stride = F.other_stride(asset.scale_format, asset.has_sh_index)
    other = np.frombuffer(asset.other_blob, np.uint8, n * stride).reshape(n, stride)
    rot_enc = other[:, 0:4].copy().view("<u4")[:, 0]
    rot = dec_quat_norm10(rot_enc)
    ssz = F.VECTOR_SIZE[asset.scale_format]
    scale = _decode_vector_blob(
        memoryview(other[:, 4 : 4 + ssz].copy().tobytes()), n, asset.scale_format
    )
    sh_idx = None
    if asset.has_sh_index:
        sh_idx = other[:, 4 + ssz : 6 + ssz].copy().view("<u2")[:, 0].astype(np.int64)

    width, height = F.texture_size(n)
    if asset.color_format == F.ColorFormat.Float32x4:
        tex = np.frombuffer(asset.color_blob, "<f4").reshape(width * height, 4)
    elif asset.color_format == F.ColorFormat.Float16x4:
        tex = np.frombuffer(asset.color_blob, "<f2").reshape(width * height, 4).astype(np.float32)
    elif asset.color_format == F.ColorFormat.Norm8x4:
        tex = (
            np.frombuffer(asset.color_blob, np.uint8).reshape(width * height, 4) / 255.0
        )
    elif asset.color_format == F.ColorFormat.BC7:
        tex = decode_bc7(asset.color_blob, width, height).reshape(width * height, 4) / 255.0
    else:
        raise NotImplementedError(f"color decode for {asset.color_format}")
    colrgba = np.asarray(tex[morton_texel_index(n)], dtype=np.float32)
    color = colrgba[:, :3]
    opacity = colrgba[:, 3]

    fmt = asset.sh_format
    if F.is_cluster_format(fmt):
        table = (
            np.frombuffer(asset.sh_blob, "<f2")
            .reshape(-1, 48)[:, :45]
            .astype(np.float32)
            .reshape(-1, 15, 3)
        )
        sh = table[sh_idx]
    elif fmt == F.SHFormat.Float32:
        sh = np.frombuffer(asset.sh_blob, "<f4").reshape(n, 48)[:, :45].reshape(n, 15, 3)
        sh = sh.astype(np.float32)
    elif fmt == F.SHFormat.Float16:
        sh = (
            np.frombuffer(asset.sh_blob, "<f2")
            .reshape(n, 48)[:, :45]
            .astype(np.float32)
            .reshape(n, 15, 3)
        )
    elif fmt == F.SHFormat.Norm11:
        u = np.frombuffer(asset.sh_blob, "<u4").reshape(n, 15)
        sh = dec_norm11(u.reshape(-1)).reshape(n, 15, 3)
    elif fmt == F.SHFormat.Norm6:
        u = np.frombuffer(asset.sh_blob, "<u2").reshape(n, 16)[:, :15]
        sh = dec_norm565(u.reshape(-1).copy()).reshape(n, 15, 3)
    else:
        raise ValueError(fmt)

    if asset.has_chunks:
        info = np.frombuffer(asset.chunk_blob, "<u4").reshape(-1, 16)
        num_chunks = info.shape[0]
        cmin = np.empty((num_chunks, 4), np.float32)
        cmax = np.empty((num_chunks, 4), np.float32)
        for i in range(4):
            cmin[:, i], cmax[:, i] = f16_pair_split(info[:, i])
        pos_pairs = info[:, 4:10].copy().view(np.float32).reshape(num_chunks, 3, 2)
        pmin, pmax = pos_pairs[:, :, 0], pos_pairs[:, :, 1]
        smin = np.empty((num_chunks, 3), np.float32)
        smax = np.empty((num_chunks, 3), np.float32)
        shmin = np.empty((num_chunks, 3), np.float32)
        shmax = np.empty((num_chunks, 3), np.float32)
        for i in range(3):
            smin[:, i], smax[:, i] = f16_pair_split(info[:, 10 + i])
            shmin[:, i], shmax[:, i] = f16_pair_split(info[:, 13 + i])

        rep = lambda a: np.repeat(a, F.CHUNK_SIZE, axis=0)[:n]
        pos = rep(pmin) + pos * (rep(pmax) - rep(pmin))
        scale = rep(smin) + scale * (rep(smax) - rep(smin))
        scale = scale**8  # hlsl:578-581 (s *= s three times)
        color = rep(cmin[:, :3]) + color * (rep(cmax[:, :3]) - rep(cmin[:, :3]))
        opacity = rep(cmin[:, 3]) + opacity * (rep(cmax[:, 3]) - rep(cmin[:, 3]))
        opacity = np.asarray(inv_square_centered01(opacity))
        if fmt in (F.SHFormat.Norm11, F.SHFormat.Norm6):
            shmin_r = rep(shmin)[:, None, :]
            shmax_r = rep(shmax)[:, None, :]
            sh = shmin_r + sh * (shmax_r - shmin_r)

    return InputSplats(
        pos=pos.astype(np.float32),
        rot=rot,
        scale=scale.astype(np.float32),
        color=color.astype(np.float32),
        opacity=opacity.astype(np.float32),
        sh=sh.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Disk container: a directory with reference-style .bytes blobs + json meta,
# mirroring {name}_{chk,pos,oth,col,shs}.bytes (GaussianSplatAssetCreator.cs:301-305).


def save_asset(asset: GaussianSplatAssetData, folder: str, name: str) -> str:
    os.makedirs(folder, exist_ok=True)
    paths = {
        "chk": asset.chunk_blob,
        "pos": asset.pos_blob,
        "oth": asset.other_blob,
        "col": asset.color_blob,
        "shs": asset.sh_blob,
    }
    for suffix, blob in paths.items():
        if suffix == "chk" and not blob:
            continue
        with open(os.path.join(folder, f"{name}_{suffix}.bytes"), "wb") as f:
            f.write(blob)
    meta = {
        "format_version": F.FORMAT_VERSION,
        "splat_count": asset.splat_count,
        "pos_format": int(asset.pos_format),
        "scale_format": int(asset.scale_format),
        "color_format": int(asset.color_format),
        "sh_format": int(asset.sh_format),
        "bounds_min": [float(x) for x in asset.bounds_min],
        "bounds_max": [float(x) for x in asset.bounds_max],
        "cameras": asset.cameras,
        "data_hash": asset.data_hash,
    }
    meta_path = os.path.join(folder, f"{name}.asset.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return meta_path


def load_asset(meta_path: str) -> GaussianSplatAssetData:
    with open(meta_path) as f:
        meta = json.load(f)
    folder = os.path.dirname(meta_path)
    name = os.path.basename(meta_path)[: -len(".asset.json")]

    def read(suffix):
        p = os.path.join(folder, f"{name}_{suffix}.bytes")
        if not os.path.exists(p):
            return b""
        with open(p, "rb") as f:
            return f.read()

    return GaussianSplatAssetData(
        splat_count=meta["splat_count"],
        pos_format=F.VectorFormat(meta["pos_format"]),
        scale_format=F.VectorFormat(meta["scale_format"]),
        color_format=F.ColorFormat(meta["color_format"]),
        sh_format=F.SHFormat(meta["sh_format"]),
        bounds_min=np.asarray(meta["bounds_min"], np.float32),
        bounds_max=np.asarray(meta["bounds_max"], np.float32),
        chunk_blob=read("chk"),
        pos_blob=read("pos"),
        other_blob=read("oth"),
        color_blob=read("col"),
        sh_blob=read("shs"),
        cameras=meta.get("cameras"),
        data_hash=meta.get("data_hash", ""),
    )
