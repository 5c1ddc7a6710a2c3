"""Niantic/Scaniverse .spz import (v2).

The port of ``unitygaussiansplatting_tpu/io/spz.py`` (numpy, as there).
Equivalent of the reference's SPZ reader
(package/Editor/Utils/SPZFileReader.cs:20-195): gzip stream with a 16-byte
``NGSP`` header followed by planar packed arrays — 24-bit fixed-point
positions, u8 alpha, u8 color, u8 log-scale (/16 - 10), u8 smallest-three
rotation xyz, u8 SH.  Vectorized numpy unpack replaces the Burst job.

(The reference unconditionally unpacks 15 SH coefficients even when the
header says fewer, reading past each splat's SH block; here coefficients
beyond the declared level are zero.)  :func:`write_spz` stamps no time into
the gzip header, so one cloud always gives the same file; the payload is the
JAX package's byte for byte.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .asset import InputSplats, pack_smallest3_np, unpack_smallest3_np

_MAGIC = 0x5053474E  # "NGSP"
_SH_COEFFS_FOR_LEVEL = {0: 0, 1: 3, 2: 8, 3: 15}


def read_spz_header(path: str) -> dict:
    with gzip.open(path, "rb") as f:
        raw = f.read(16)
    if len(raw) != 16:
        raise IOError("SPZ read error: failed to read header")
    magic, version, num_points, packed = struct.unpack("<IIII", raw)
    if magic != _MAGIC:
        raise IOError(f"SPZ read error: bad magic {magic:#x}")
    if version != 2:
        raise IOError(f"SPZ read error: unsupported version {version}")
    return {
        "num_points": num_points,
        "sh_level": packed & 0xFF,
        "fractional_bits": (packed >> 8) & 0xFF,
        "flags": (packed >> 16) & 0xFF,
    }


def read_spz(path: str) -> InputSplats:
    with gzip.open(path, "rb") as f:
        raw = f.read(16)
        magic, version, n, packed = struct.unpack("<IIII", raw)
        if magic != _MAGIC or version != 2:
            raise IOError("SPZ read error: bad magic/version")
        sh_level = packed & 0xFF
        fract_bits = (packed >> 8) & 0xFF
        if not (1 <= n <= 10_000_000):
            raise IOError(f"SPZ read error: splat count {n} out of range")
        if sh_level > 3 or fract_bits > 24:
            raise IOError("SPZ read error: bad SH level / fractional bits")
        sh_coeffs = _SH_COEFFS_FOR_LEVEL[sh_level]

        def take(count):
            b = f.read(count)
            if len(b) != count:
                raise IOError("SPZ read error: file smaller than it should be")
            return np.frombuffer(b, np.uint8)

        packed_pos = take(n * 9)
        packed_alpha = take(n)
        packed_col = take(n * 3)
        packed_scale = take(n * 3)
        packed_rot = take(n * 3)
        packed_sh = take(n * 3 * sh_coeffs)

    # 24-bit signed fixed point positions (SPZFileReader.cs:182-187).
    b = packed_pos.reshape(n, 3, 3).astype(np.int32)
    fx = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    fx = np.where(fx & 0x800000 != 0, fx | ~0xFFFFFF, fx)
    pos = fx.astype(np.float32) / (1 << fract_bits)

    scale = np.exp(packed_scale.reshape(n, 3).astype(np.float32) / 16.0 - 10.0)

    xyz = packed_rot.reshape(n, 3).astype(np.float32) / 127.5 - 1.0
    w = np.sqrt(np.maximum(0.0, 1.0 - np.sum(xyz * xyz, axis=-1)))
    q = np.concatenate([xyz, w[:, None]], axis=-1)
    q /= np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    rot = pack_smallest3_np(q)

    opacity = packed_alpha.astype(np.float32) / 255.0

    col = packed_col.reshape(n, 3).astype(np.float32) / 255.0 - 0.5
    col = col / 0.15
    color = col * 0.2820948 + 0.5

    sh = np.zeros((n, 15, 3), np.float32)
    if sh_coeffs:
        vals = (packed_sh.reshape(n, sh_coeffs, 3).astype(np.float32) - 128.0) / 128.0
        sh[:, :sh_coeffs] = vals

    return InputSplats(
        pos=pos.astype(np.float32),
        rot=rot,
        scale=scale.astype(np.float32),
        color=color.astype(np.float32),
        opacity=opacity,
        sh=sh,
    )


def write_spz(path: str, splats: InputSplats, fractional_bits: int = 12, sh_level: int = 3) -> None:
    """Write SPZ v2 (inverse of :func:`read_spz`; no reference analog —
    the reference only reads SPZ)."""
    n = splats.count
    sh_coeffs = _SH_COEFFS_FOR_LEVEL[sh_level]
    header = struct.pack(
        "<IIII", _MAGIC, 2, n, (sh_level & 0xFF) | ((fractional_bits & 0xFF) << 8)
    )

    fx = np.clip(
        np.rint(splats.pos * (1 << fractional_bits)), -(1 << 23), (1 << 23) - 1
    ).astype(np.int32)
    pos_bytes = np.stack(
        [fx & 0xFF, (fx >> 8) & 0xFF, (fx >> 16) & 0xFF], axis=-1
    ).astype(np.uint8)

    alpha = np.clip(np.rint(splats.opacity * 255.0), 0, 255).astype(np.uint8)
    col = (splats.color - 0.5) / 0.2820948 * 0.15 + 0.5
    col_bytes = np.clip(np.rint(col * 255.0), 0, 255).astype(np.uint8)
    scale_bytes = np.clip(
        np.rint((np.log(np.maximum(splats.scale, 1e-37)) + 10.0) * 16.0), 0, 255
    ).astype(np.uint8)

    q = unpack_smallest3_np(splats.rot)
    q = q * np.where(q[:, 3:4] < 0, -1.0, 1.0)  # w >= 0 so xyz determine q
    rot_bytes = np.clip(np.rint((q[:, :3] + 1.0) * 127.5), 0, 255).astype(np.uint8)

    sh_bytes = np.clip(
        np.rint(splats.sh[:, :sh_coeffs] * 128.0 + 128.0), 0, 255
    ).astype(np.uint8)

    with open(path, "wb") as raw, gzip.GzipFile(filename="", fileobj=raw, mode="wb", mtime=0) as f:
        f.write(header)
        f.write(pos_bytes.tobytes())
        f.write(alpha.tobytes())
        f.write(col_bytes.tobytes())
        f.write(scale_bytes.tobytes())
        f.write(rot_bytes.tobytes())
        f.write(sh_bytes.tobytes())
