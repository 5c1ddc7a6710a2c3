"""Device-resident compressed assets: render straight from quantized words.

The port of ``unitygaussiansplatting_tpu/io/device_asset.py``.  The
reference keeps the *compressed* buffers on the GPU and decodes each splat
per frame inside its view-calc kernel (``LoadSplatData``,
GaussianSplatting.hlsl:428-608); that is how it renders bicycle in 1.3 GB of
VRAM against the official viewer's 4.8 GB (readme.md:83-84).

- :class:`DeviceAsset` holds the quantized fields as integer tensors on the
  device (words, not float expansions) plus the chunk table.
- :func:`decode_device` is the ``LoadSplatData`` analog: bit-field decode,
  chunk min/max lerp, scale^8, the opacity's inverse warp, the
  smallest-three quaternion unpack, the SH cluster indirection.  The
  renderer calls it every frame (``models.renderer.render_with_stats``
  takes a ``DeviceAsset``), so no float copy of the cloud lives between
  frames.
- :func:`encode_device` quantizes a cloud into a ``DeviceAsset`` on the
  device, word-compatible with ``device_asset_from_asset(encode_asset(...))``.

Words: PyTorch has no ``uint32`` arithmetic on CUDA for every operation the
codecs need, so a u32 word is held as the ``int32`` with the same bits and a
u16 word as the ``int16`` with the same bits.  Decoding masks after every
(arithmetic) right shift and after widening an ``int16``, which makes the
sign bit an ordinary bit; encoding builds each word in ``int64`` and folds
it into the signed range at the end.

Layout against the reference: color texels are de-swizzled from the 16x16
Morton texture layout once at upload and per-splat words are kept
splat-major.  BC7 color is decoded on the host at upload (``io/bc7.py``) and
held as Norm8x4 words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from ..models.gaussians import Gaussians
from ..ops import cuda_build
from ..ops.activations import square_centered01
from ..ops.packing import as_i16, as_i32
from ..ops.quaternion import pack_smallest3, unpack_smallest3
from ..ops.tile_common import true_div
from ..utils.device import resolve_device
from . import formats as F
from .asset import GaussianSplatAssetData, morton_texel_index
from .bc7 import decode_bc7

_WORD_FIELDS = ("pos_q", "rot_q", "scale_q", "color_q", "sh_q", "sh_idx", "chunk_info")


@dataclasses.dataclass
class DeviceAsset:
    """Quantized splat fields as device tensors (see the module docstring).

    u32 words are ``int32`` and u16 words ``int16`` bit patterns.
    """

    pos_q: torch.Tensor  # Norm11: (N,) i32 | Norm16: (N, 3) i16 | Norm6: (N,) i16 | Float32: (N, 3) f32
    rot_q: torch.Tensor  # (N,) i32, 10.10.10.2 smallest-three
    scale_q: torch.Tensor  # like pos_q, per scale_format
    color_q: torch.Tensor  # Norm8x4: (N,) i32 rgba | Float16x4: (N, 2) i32 | Float32x4: (N, 4) f32
    sh_q: torch.Tensor  # Norm11: (N, 15) i32 | Norm6: (N, 15) i16 | Float16: (N, 24) i32 | Float32: (N, 45) f32 | cluster: (k, 24) i32 table
    sh_idx: torch.Tensor | None  # (N,) i32 for cluster formats
    chunk_info: torch.Tensor | None  # (num_chunks, 16) i32, None when unchunked
    splat_count: int
    pos_format: F.VectorFormat
    scale_format: F.VectorFormat
    color_format: F.ColorFormat
    sh_format: F.SHFormat

    @property
    def num_splats(self) -> int:
        return self.splat_count

    def device_bytes(self) -> int:
        """Bytes the words take on the device (the reference's VRAM story)."""
        return sum(t.numel() * t.element_size() for t in self._words() if t is not None)

    def to(self, device) -> "DeviceAsset":
        return dataclasses.replace(
            self, **{f: None if t is None else t.to(device) for f, t in zip(_WORD_FIELDS, self._words())}
        )

    def _words(self):
        return [getattr(self, f) for f in _WORD_FIELDS]


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array on ``device``; u32 and u16 words as int32 / int16 bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a).to(device)


def device_asset_from_asset(asset: GaussianSplatAssetData, device=None) -> DeviceAsset:
    """Split the byte blobs into typed per-field words and upload them to
    ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    n = asset.splat_count
    pf, sf = asset.pos_format, asset.scale_format

    def vector_words(blob: bytes, fmt: F.VectorFormat, count: int, offset=0, stride=None):
        raw = np.frombuffer(blob, np.uint8)
        if stride is not None:
            raw = raw.reshape(count, stride)
        if fmt == F.VectorFormat.Float32:
            if stride:
                return raw[:, offset : offset + 12].copy().view("<f4")
            return np.frombuffer(blob, "<f4", count * 3).reshape(count, 3)
        if fmt == F.VectorFormat.Norm16:
            if stride:
                return raw[:, offset : offset + 6].copy().view("<u2")
            return np.frombuffer(blob, "<u2", count * 3).reshape(count, 3)
        if fmt == F.VectorFormat.Norm11:
            if stride:
                return raw[:, offset : offset + 4].copy().view("<u4")[:, 0]
            return np.frombuffer(blob, "<u4", count)
        if fmt == F.VectorFormat.Norm6:
            if stride:
                return raw[:, offset : offset + 2].copy().view("<u2")[:, 0]
            return np.frombuffer(blob, "<u2", count)
        raise ValueError(fmt)

    pos_q = vector_words(asset.pos_blob, pf, n)

    stride = F.other_stride(sf, asset.has_sh_index)
    other = np.frombuffer(asset.other_blob, np.uint8, n * stride).reshape(n, stride)
    rot_q = other[:, 0:4].copy().view("<u4")[:, 0]
    ssz = F.VECTOR_SIZE[sf]
    scale_q = vector_words(asset.other_blob, sf, n, offset=4, stride=stride)
    sh_idx = None
    if asset.has_sh_index:
        sh_idx = other[:, 4 + ssz : 6 + ssz].copy().view("<u2")[:, 0].astype(np.int32)

    # Color: de-swizzle the Morton texture into splat order once.
    width, height = F.texture_size(n)
    tix = morton_texel_index(n)
    if asset.color_format == F.ColorFormat.Norm8x4:
        tex = np.frombuffer(asset.color_blob, np.uint8).reshape(width * height, 4)
        color_q = tex[tix].copy().view("<u4")[:, 0]
    elif asset.color_format == F.ColorFormat.Float16x4:
        tex = np.frombuffer(asset.color_blob, np.uint8).reshape(width * height, 8)
        color_q = tex[tix].copy().view("<u4")
    elif asset.color_format == F.ColorFormat.Float32x4:
        tex = np.frombuffer(asset.color_blob, "<f4").reshape(width * height, 4)
        color_q = tex[tix].astype(np.float32)
    elif asset.color_format == F.ColorFormat.BC7:
        # Blocks decoded on the host once; the device holds Norm8x4 words (4
        # B a splat, as Norm8x4: BC7's size win is on disk here).
        tex = decode_bc7(asset.color_blob, width, height).reshape(width * height, 4)
        color_q = tex[tix].copy().view("<u4")[:, 0]
    else:
        raise NotImplementedError(asset.color_format)

    fmt = asset.sh_format
    if F.is_cluster_format(fmt):
        sh_q = np.frombuffer(asset.sh_blob, np.uint8).reshape(-1, 96).copy().view("<u4")
    elif fmt == F.SHFormat.Float32:
        sh_q = np.frombuffer(asset.sh_blob, "<f4").reshape(n, 48)[:, :45]
    elif fmt == F.SHFormat.Float16:
        sh_q = np.frombuffer(asset.sh_blob, np.uint8).reshape(n, 96).copy().view("<u4")[:, :24]
    elif fmt == F.SHFormat.Norm11:
        sh_q = np.frombuffer(asset.sh_blob, "<u4").reshape(n, 15)
    elif fmt == F.SHFormat.Norm6:
        sh_q = np.frombuffer(asset.sh_blob, "<u2").reshape(n, 16)[:, :15]
    else:
        raise ValueError(fmt)

    chunk_info = None
    if asset.has_chunks:
        chunk_info = np.frombuffer(asset.chunk_blob, "<u4").reshape(-1, 16)

    return DeviceAsset(
        pos_q=_upload(pos_q, dev),
        rot_q=_upload(rot_q, dev),
        scale_q=_upload(scale_q, dev),
        color_q=_upload(color_q, dev),
        sh_q=_upload(sh_q, dev),
        sh_idx=None if sh_idx is None else _upload(sh_idx, dev),
        chunk_info=None if chunk_info is None else _upload(chunk_info, dev),
        splat_count=n,
        pos_format=pf,
        scale_format=sf,
        color_format=asset.color_format,
        sh_format=fmt,
    )


# --- decode: the formulas of io/asset.py's numpy codecs (GaussianSplatting.hlsl:261-304),
#     in planar 1-D columns


def _bitfields(words: torch.Tensor, shifts, masks) -> list[torch.Tensor]:
    """Planar bit-field decode: ``((u >> s) & m) / m`` for each (s, m), as
    (N,) float32 columns.  ``int16`` words widen with their sign, which the
    masks drop (no field reaches past bit 15 of a u16 word)."""
    u = words.to(torch.int32)
    return [true_div(((u >> s) & m).to(torch.float32), float(m)) for s, m in zip(shifts, masks)]


def _vector_cols(q: torch.Tensor, fmt: F.VectorFormat) -> list[torch.Tensor]:
    """A packed vector field decoded to three planar (N,) columns in [0, 1]
    (or the floats themselves)."""
    if fmt == F.VectorFormat.Float32:
        return [q[:, j].to(torch.float32) for j in range(3)]
    if fmt == F.VectorFormat.Norm16:
        return [true_div((q[:, j].to(torch.int32) & 0xFFFF).to(torch.float32), 65535.0) for j in range(3)]
    if fmt == F.VectorFormat.Norm11:
        return _bitfields(q, (0, 11, 21), (2047, 1023, 2047))
    if fmt == F.VectorFormat.Norm6:
        return _bitfields(q, (0, 6, 11), (63, 31, 31))
    raise ValueError(fmt)


def _f16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """u16 values 0..65535 (in a wider integer) read as float16 bits."""
    signed = ((bits + 0x8000) & 0xFFFF) - 0x8000
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def _f16_pair_split(words: torch.Tensor):
    """An i32 word of two float16 halves -> (low half, high half) as float32."""
    return _f16_bits_to_f32(words & 0xFFFF), _f16_bits_to_f32((words >> 16) & 0xFFFF)


def _chunk_lerp(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, n: int, width: int = 1) -> torch.Tensor:
    """``lo + x * (hi - lo)`` with ``lo``/``hi`` constant over each chunk of
    256 splats, for a planar column of ``n * width`` values.  Runs at
    (chunks, 256 * width): a splat's values are contiguous in the column,
    so chunk rows stay aligned."""
    nchunks = lo.shape[0]
    x2 = nnf.pad(x, (0, (nchunks * F.CHUNK_SIZE - n) * width)).reshape(nchunks, F.CHUNK_SIZE * width)
    out = lo[:, None] + x2 * (hi - lo)[:, None]
    return out.reshape(-1)[: n * width]


def _pow8(s: torch.Tensor) -> torch.Tensor:
    """s^8 as hlsl:578-581 computes it: s *= s three times."""
    s = s * s
    s = s * s
    return s * s


@torch.no_grad()
def decode_device(da: DeviceAsset, planar_sh: bool = False, device=None) -> Gaussians:
    """Per-frame decode on ``device`` (CUDA unless told otherwise):
    ``DeviceAsset`` -> activated ``Gaussians``.

    The mirror of ``LoadSplatData`` (GaussianSplatting.hlsl:428-608).
    ``planar_sh=True`` keeps Norm11/Norm6 SH as a tuple of three planar
    (N, 15) channels, which ``ops.sh.shade_sh`` shades bit-identically to
    the interleaved form.  On CUDA the words take one launch of
    ``csrc/decode.cu`` (:func:`decode_device_cuda`, counted in
    ``cuda_build.launched["decode_launch"]``); on the CPU, :func:`decode_device_plain`.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        return decode_device_cuda(da.to(dev), planar_sh)
    return decode_device_plain(da, planar_sh, dev)


@torch.no_grad()
def decode_device_plain(da: DeviceAsset, planar_sh: bool = False, device=None) -> Gaussians:
    """Plain PyTorch version of :func:`decode_device`: the CPU path and the
    kernel's oracle.

    The per-splat math runs on planar 1-D columns, each output field stacked
    once at the end, as the JAX package does.
    """
    da = da.to(resolve_device(device))
    n = da.splat_count
    pos_cols = _vector_cols(da.pos_q, da.pos_format)
    scale_cols = _vector_cols(da.scale_q, da.scale_format)
    rot = unpack_smallest3(torch.stack(_bitfields(da.rot_q, (0, 10, 20, 30), (1023, 1023, 1023, 3)), dim=-1))

    cf = da.color_format
    if cf in (F.ColorFormat.Norm8x4, F.ColorFormat.BC7):  # BC7: Norm8x4 words since upload
        col_cols = _bitfields(da.color_q, (0, 8, 16, 24), (0xFF, 0xFF, 0xFF, 0xFF))
    elif cf == F.ColorFormat.Float16x4:
        r, g = _f16_pair_split(da.color_q[:, 0])
        b, a = _f16_pair_split(da.color_q[:, 1])
        col_cols = [r, g, b, a]
    elif cf == F.ColorFormat.Float32x4:
        col_cols = [da.color_q[:, j] for j in range(4)]
    else:
        raise NotImplementedError(cf)
    opacity = col_cols[3]

    fmt = da.sh_format
    sh_cols = None  # planar (n * 15,) channel columns for the normed formats
    if F.is_cluster_format(fmt) or fmt == F.SHFormat.Float16:
        words = da.sh_q  # (rows, 24) f16 pairs: 48 halves, 45 used
        if F.is_cluster_format(fmt):
            words = words.index_select(0, da.sh_idx.to(torch.int64))
        lo, hi = _f16_pair_split(words)
        sh = torch.stack([lo, hi], dim=-1).reshape(-1, 48)[:, :45].reshape(-1, 15, 3)
    elif fmt == F.SHFormat.Float32:
        sh = da.sh_q.reshape(n, 15, 3)
    elif fmt == F.SHFormat.Norm11:
        sh_cols = _bitfields(da.sh_q.reshape(-1), (0, 11, 21), (2047, 1023, 2047))
    elif fmt == F.SHFormat.Norm6:
        sh_cols = _bitfields(da.sh_q.reshape(-1), (0, 5, 11), (31, 63, 31))
    else:
        raise ValueError(fmt)

    if da.chunk_info is not None:
        info = da.chunk_info
        pos_pairs = info[:, 4:10].contiguous().view(torch.float32)
        pos_cols = [_chunk_lerp(pos_cols[j], pos_pairs[:, 2 * j], pos_pairs[:, 2 * j + 1], n) for j in range(3)]
        scale_cols = [_chunk_lerp(scale_cols[j], *_f16_pair_split(info[:, 10 + j]), n) for j in range(3)]
        scale_cols = [_pow8(s) for s in scale_cols]
        col_cols = [_chunk_lerp(col_cols[j], *_f16_pair_split(info[:, j]), n) for j in range(4)]
        # InvSquareCentered01 (GaussianUtils.cs:25-38, hlsl:583).
        t = col_cols[3] * 2.0 - 1.0
        opacity = torch.sign(t) * torch.sqrt(torch.abs(t)) * 0.5 + 0.5
        if sh_cols is not None:
            sh_cols = [_chunk_lerp(sh_cols[i], *_f16_pair_split(info[:, 13 + i]), n, width=15) for i in range(3)]

    if sh_cols is not None:
        if planar_sh:
            sh = tuple(col.reshape(n, 15) for col in sh_cols)
        else:
            sh = torch.stack(sh_cols, dim=-1).reshape(n, 15, 3)

    return Gaussians(
        means=torch.stack(pos_cols, dim=-1),
        rotations=rot,
        scales=torch.stack(scale_cols, dim=-1),
        opacities=opacity,
        base_color=torch.stack(col_cols[:3], dim=-1),
        sh=sh,
    )


def _word_layouts(da: DeviceAsset) -> dict:
    """``{field: (shape, dtype)}`` of the words :func:`decode_device_cuda` takes:
    the layouts :func:`device_asset_from_asset` and :func:`encode_device` make."""
    n = da.splat_count
    i32, i16, f32 = torch.int32, torch.int16, torch.float32
    vector = {F.VectorFormat.Float32: ((n, 3), f32), F.VectorFormat.Norm16: ((n, 3), i16),
              F.VectorFormat.Norm11: ((n,), i32), F.VectorFormat.Norm6: ((n,), i16)}
    color = {F.ColorFormat.Float32x4: ((n, 4), f32), F.ColorFormat.Float16x4: ((n, 2), i32),
             F.ColorFormat.Norm8x4: ((n,), i32), F.ColorFormat.BC7: ((n,), i32)}
    sh = {F.SHFormat.Float32: ((n, 45), f32), F.SHFormat.Float16: ((n, 24), i32), F.SHFormat.Norm11: ((n, 15), i32),
          F.SHFormat.Norm6: ((n, 15), i16)}
    layouts = dict(pos_q=vector[da.pos_format], rot_q=((n,), i32), scale_q=vector[da.scale_format],
                   color_q=color[da.color_format])
    if F.is_cluster_format(da.sh_format):
        layouts.update(sh_q=((da.sh_q.shape[0], 24), i32), sh_idx=((n,), i32))
    else:
        layouts["sh_q"] = sh[da.sh_format]
    if da.chunk_info is not None:  # at least a row a chunk, as _chunk_lerp needs
        layouts["chunk_info"] = ((max(da.chunk_info.shape[0], -(-n // F.CHUNK_SIZE)), 16), i32)
    return layouts


def decode_device_cuda(da: DeviceAsset, planar_sh: bool = False) -> Gaussians:
    """:func:`decode_device_plain`'s cloud from one launch of ``csrc/decode.cu``,
    bit for bit, for a ``DeviceAsset`` on the card.

    The outputs are new contiguous tensors (SH (N, 15, 3), 16-byte aligned,
    or three (N, 15) channels under ``planar_sh`` for Norm11/Norm6 SH, as
    the plain version gives them), except Float32 SH, which is the asset's
    own words viewed as (N, 15, 3), as in the plain version.  Nothing waits
    for the host.
    """
    dev = da.pos_q.device
    n = da.splat_count
    if n >= 2**31:
        raise ValueError(f"decode_device_cuda takes fewer than 2^31 splats, got {n}")
    for name, (shape, dtype) in _word_layouts(da).items():
        t = getattr(da, name)
        if t is None or (tuple(t.shape), t.dtype, t.device) != (shape, dtype, dev) or not t.is_contiguous():
            got = None if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}, contiguous {t.is_contiguous()}"
            raise ValueError(f"da.{name} must be contiguous {shape} {dtype} on {dev}, got {got}")
    sh_kind = min(int(da.sh_format), int(F.SHFormat.Cluster64k))  # csrc/decode.cu's: every cluster format is 4
    planar = planar_sh and da.sh_format in (F.SHFormat.Norm11, F.SHFormat.Norm6)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if da.sh_format == F.SHFormat.Float32:
        sh, sh_out = da.sh_q.reshape(n, 15, 3), (None, None, None)
    elif planar:
        sh = sh_out = (empty(n, 15), empty(n, 15), empty(n, 15))
    else:
        sh = empty(n, 15, 3)
        sh_out = (sh, None, None)
    g = Gaussians(means=empty(n, 3), rotations=empty(n, 4), scales=empty(n, 3), opacities=empty(n),
                  base_color=empty(n, 3), sh=sh)
    if n == 0:
        return g
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    cuda_build.launch(
        "decode", "decode_launch", dev,
        *(ptr(getattr(da, f)) for f in _WORD_FIELDS), n, int(da.pos_format), int(da.scale_format),
        int(da.color_format), sh_kind, da.sh_q.shape[0], int(planar),
        *(ptr(t) for t in (g.means, g.rotations, g.scales, g.opacities, g.base_color, *sh_out)),
    )
    return g


# --- encode on the device


def _enc(x: torch.Tensor, maxv: int) -> torch.Tensor:
    """[0, 1] -> integer code (``io/asset._enc``), as int64."""
    return torch.clamp(x * (maxv + 0.5), 0.0, float(maxv)).to(torch.int64)


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _f16_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> i32 words of their float16 bits (lo | hi << 16)."""
    return as_i32(_f16_bits(lo) | (_f16_bits(hi) << 16))


@torch.no_grad()
def encode_device(
    g: Gaussians,
    pos_format: F.VectorFormat = F.VectorFormat.Norm11,
    scale_format: F.VectorFormat = F.VectorFormat.Norm11,
    color_format: F.ColorFormat = F.ColorFormat.Norm8x4,
    sh_format: F.SHFormat = F.SHFormat.Norm6,
    device=None,
) -> DeviceAsset:
    """Quantize activated ``Gaussians`` into a :class:`DeviceAsset` on
    ``device`` (CUDA unless told otherwise), without the splats visiting
    the host.

    The host encoder's steps (``io/asset.encode_asset``, itself the analog
    of GaussianSplatAssetCreator.cs:520-833): scale^(1/8) and the opacity's
    square warp, per-256-splat chunk min/max and [0, 1] renormalization, the
    same bit codecs; the color texture's swizzle is skipped (words are
    splat-major).  scale^(1/8) is taken in float64 and rounded to float32,
    which matches the JAX package's float32 power on all but a few values.

    BC7 color and cluster SH formats raise ``NotImplementedError``, as in
    the JAX package: the host path (``io/creator.create_asset``) makes them.
    """
    if color_format == F.ColorFormat.BC7:
        raise NotImplementedError("BC7 encode is host-side (io/asset.encode_asset)")
    if F.is_cluster_format(sh_format):
        raise NotImplementedError("cluster SH needs k-means (io/creator)")

    g = g.to(resolve_device(device))
    use_chunks = F.uses_chunks(pos_format, scale_format, color_format, sh_format)
    n = g.num_splats
    pos = g.means.to(torch.float32)
    scale = g.scales.to(torch.float32)
    color = g.base_color.to(torch.float32)
    opacity = g.opacities.to(torch.float32)
    sh = g.sh.to(torch.float32)
    rot01 = torch.clamp(pack_smallest3(g.rotations.to(torch.float32)), 0.0, 1.0)
    rot_q = as_i32(
        _enc(rot01[:, 0], 1023) | (_enc(rot01[:, 1], 1023) << 10) | (_enc(rot01[:, 2], 1023) << 20)
        | (_enc(rot01[:, 3], 3) << 30)
    )

    chunk_info = None
    if use_chunks:
        scale = torch.pow(torch.clamp(scale, min=0.0).to(torch.float64), 0.125).to(torch.float32)
        opacity = square_centered01(opacity)

        num_chunks = (n + F.CHUNK_SIZE - 1) // F.CHUNK_SIZE
        pad = num_chunks * F.CHUNK_SIZE - n

        def chunked(a):
            # Tail padding repeats the last chunk's first element, so min/max
            # are unaffected (the host encoder does the same).
            if pad:
                fill = a[(num_chunks - 1) * F.CHUNK_SIZE].expand((pad,) + tuple(a.shape[1:]))
                a = torch.cat([a, fill])
            return a.reshape(num_chunks, F.CHUNK_SIZE, *a.shape[1:])

        eps = 1.0e-5
        col4 = torch.cat([color, opacity[:, None]], dim=-1)
        cpos, cscl, ccol4, csh = chunked(pos), chunked(scale), chunked(col4), chunked(sh)
        pmin, pmax = cpos.amin(1), cpos.amax(1)
        smin, smax = cscl.amin(1), cscl.amax(1)
        cmin, cmax = ccol4.amin(1), ccol4.amax(1)
        shmin, shmax = csh.amin(dim=(1, 2)), csh.amax(dim=(1, 2))
        del cpos, cscl, ccol4, csh
        pmax = torch.maximum(pmax, pmin + eps)
        smax = torch.maximum(smax, smin + eps)
        cmax = torch.maximum(cmax, cmin + eps)
        shmax = torch.maximum(shmax, shmin + eps)

        # ChunkInfo, 16 words (GaussianSplatAsset.cs:231-237): colR..colA f16
        # pairs, posX/Y/Z f32 (min, max), sclX/Y/Z and shR/G/B f16 pairs.
        pos_pairs = torch.stack([pmin, pmax], dim=-1).reshape(num_chunks, 6)
        chunk_info = torch.cat(
            [_f16_pair(cmin[:, i], cmax[:, i])[:, None] for i in range(4)]
            + [pos_pairs.contiguous().view(torch.int32)]
            + [_f16_pair(smin[:, i], smax[:, i])[:, None] for i in range(3)]
            + [_f16_pair(shmin[:, i], shmax[:, i])[:, None] for i in range(3)],
            dim=1,
        )

        def normalize(x, lo, hi):
            # Per-splat [0, 1] within the chunk, at (chunks, 256, width).
            width = x[0].numel()
            x3 = nnf.pad(x.reshape(n, width), (0, 0, 0, pad)).reshape(num_chunks, F.CHUNK_SIZE, width)
            lo3, hi3 = lo.reshape(num_chunks, 1, width), hi.reshape(num_chunks, 1, width)
            return ((x3 - lo3) / (hi3 - lo3)).reshape(-1, width)[:n].reshape(x.shape)

        pos = normalize(pos, pmin, pmax)
        scale = normalize(scale, smin, smax)
        color = normalize(color, cmin[:, :3], cmax[:, :3])
        opacity = normalize(opacity, cmin[:, 3], cmax[:, 3])
        if sh_format in (F.SHFormat.Norm11, F.SHFormat.Norm6):
            # Per-channel chunk bounds over all 15 coefficients.
            lo15 = torch.repeat_interleave(shmin, F.CHUNK_SIZE, dim=0)[:n][:, None, :]
            hi15 = torch.repeat_interleave(shmax, F.CHUNK_SIZE, dim=0)[:n][:, None, :]
            sh = (sh - lo15) / (hi15 - lo15)

    def vector_words(v01, fmt):
        v01c = torch.clamp(v01, 0.0, 1.0)
        if fmt == F.VectorFormat.Float32:
            return v01.to(torch.float32)
        if fmt == F.VectorFormat.Norm16:
            return as_i16(torch.clamp(v01c * 65535.5, 0, 65535).to(torch.int64))
        if fmt == F.VectorFormat.Norm11:
            return as_i32(_enc(v01c[:, 0], 2047) | (_enc(v01c[:, 1], 1023) << 11) | (_enc(v01c[:, 2], 2047) << 21))
        if fmt == F.VectorFormat.Norm6:
            return as_i16(_enc(v01c[:, 0], 63) | (_enc(v01c[:, 1], 31) << 6) | (_enc(v01c[:, 2], 31) << 11))
        raise ValueError(fmt)

    pos_q = vector_words(pos, pos_format)
    scale_q = vector_words(scale, scale_format)

    col4 = torch.clamp(torch.cat([color, opacity[:, None]], dim=-1), 0.0, 1.0)
    if color_format == F.ColorFormat.Norm8x4:
        codes = torch.clamp(col4 * 255.5, 0, 255).to(torch.int64)
        color_q = as_i32(codes[:, 0] | (codes[:, 1] << 8) | (codes[:, 2] << 16) | (codes[:, 3] << 24))
    elif color_format == F.ColorFormat.Float16x4:
        color_q = torch.stack([_f16_pair(col4[:, 0], col4[:, 1]), _f16_pair(col4[:, 2], col4[:, 3])], dim=-1)
    elif color_format == F.ColorFormat.Float32x4:
        color_q = torch.cat([color, opacity[:, None]], dim=-1)
    else:
        raise NotImplementedError(color_format)

    if sh_format == F.SHFormat.Float32:
        sh_q = sh.reshape(n, 45).contiguous()
    elif sh_format == F.SHFormat.Float16:
        sh48 = nnf.pad(sh.reshape(n, 45), (0, 3))
        sh_q = _f16_pair(sh48[:, 0::2], sh48[:, 1::2])
    elif sh_format == F.SHFormat.Norm11:
        s = torch.clamp(sh.reshape(n, 15, 3), 0.0, 1.0)
        sh_q = as_i32(_enc(s[..., 0], 2047) | (_enc(s[..., 1], 1023) << 11) | (_enc(s[..., 2], 2047) << 21))
    elif sh_format == F.SHFormat.Norm6:
        s = torch.clamp(sh.reshape(n, 15, 3), 0.0, 1.0)
        sh_q = as_i16(_enc(s[..., 0], 31) | (_enc(s[..., 1], 63) << 5) | (_enc(s[..., 2], 31) << 11))
    else:
        raise ValueError(sh_format)

    return DeviceAsset(
        pos_q=pos_q,
        rot_q=rot_q,
        scale_q=scale_q,
        color_q=color_q,
        sh_q=sh_q,
        sh_idx=None,
        chunk_info=chunk_info,
        splat_count=n,
        pos_format=pos_format,
        scale_format=scale_format,
        color_format=color_format,
        sh_format=sh_format,
    )
