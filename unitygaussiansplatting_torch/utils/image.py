"""Image helpers: PNG IO (dependency-free) and comparison metrics.

The port of ``unitygaussiansplatting_tpu/utils/image.py`` (numpy, as there;
the same PNG bytes)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3|4) float [0,1] or uint8 image as PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    h, w, ch = arr.shape
    color_type = {3: 2, 4: 6}[ch]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB/RGBA PNG -> (H, W, C) float32 in [0,1].

    Minimal reader: non-interlaced, bit depth 8, color type 2/6 (what
    save_png and the reference's golden images use).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = ch = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
            if depth != 8 or ctype not in (2, 6) or interlace:
                raise ValueError(f"unsupported PNG (depth={depth} ctype={ctype})")
            ch = 3 if ctype == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * ch
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # sub
            for i in range(ch, stride):
                row[i] = (int(row[i]) + int(row[i - ch])) & 0xFF
        elif ftype == 2:  # up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # average
            for i in range(stride):
                left = int(row[i - ch]) if i >= ch else 0
                row[i] = (int(row[i]) + (left + int(prev[i])) // 2) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = int(row[i - ch]) if i >= ch else 0
                b = int(prev[i])
                c = int(prev[i - ch]) if i >= ch else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (int(row[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = row
        prev = row
    return (out.reshape(h, w, ch).astype(np.float32)) / 255.0


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10.0 * np.log10(peak * peak / max(mse, 1e-20)))


def diff_pixel_count(a: np.ndarray, b: np.ndarray, tol: float = 1.0 / 255.0) -> int:
    """Pixels differing in any channel by more than tol (validator metric)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return int(np.any(d > tol, axis=-1).sum())
