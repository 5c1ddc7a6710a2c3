"""BC7 color-texture codec, numpy, with no image library.

The port of ``unitygaussiansplatting_tpu/io/bc7.py``.  The reference's
VeryLow preset compresses the color texture to BC7 in the Unity editor
(GaussianSplatAssetCreator.cs:903-932, ColorFormat.BC7 in
GaussianSplatAsset.cs:51-68) and samples it through the GPU's texture units.
Here both directions are host numpy:

- **decode** handles all eight modes of the format (Khronos Data Format
  Specification, "BC7"; D3D11 "BC7 format mode reference"): 1-3 subsets, the
  64-entry partition tables, anchor indices stored one bit short, per-endpoint
  and shared p-bits, separate alpha indices and the channel rotation of modes
  4 and 5, the 2-, 3- and 4-bit interpolation weights.  A reserved mode (an
  all-zero first byte) decodes to opaque black, as the JAX package's decoder
  (Pillow's) gives it.  The tables are written out below; the tests hold
  them and the decoder against Pillow's.
- **encode** is the JAX package's encoder, byte for byte: per 4x4 block the
  best, by reconstruction SSE, of mode 5 (RGB 7.7.7 + A 8, independent 2-bit
  color and alpha indices), mode 6 (RGBA 7.7.7.7 + p-bit, one 4-bit index
  plane) and mode 7 (two subsets searched over all 64 partitions); slabs of
  blocks are encoded on a pool of threads.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# BC7 interpolation weights (aWeight2/3/4 of the specification).
WEIGHTS2 = np.array([0, 21, 43, 64], np.int32)
WEIGHTS3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int32)
WEIGHTS4 = np.array(
    [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], np.int32
)
_WEIGHTS = {2: WEIGHTS2, 3: WEIGHTS3, 4: WEIGHTS4}
# The encoder's unit of work, and its threads (a VeryLow import's BC7
# encode of 2M splats is minutes of one core).
_SLAB_BLOCKS = 2048
_ENCODE_THREADS = min(8, os.cpu_count() or 1)

# Two-subset partitions: bit i of an entry is the subset of pixel i (row-major
# in the 4x4 block).
_P2_MASKS = (
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22,
)
# Three-subset partitions: bits 2i and 2i+1 of an entry are the subset of
# pixel i.  Mode 0 uses the first 16.
_P3_CODES = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0, 0x5A5A5050,
    0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250,
    0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500,
    0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200,
    0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
    0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600,
    0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254,
)
_PIXEL = np.arange(16)
PARTITIONS2 = ((np.array(_P2_MASKS)[:, None] >> _PIXEL) & 1).astype(np.int32)  # (64, 16)
PARTITIONS3 = ((np.array(_P3_CODES)[:, None] >> (2 * _PIXEL)) & 3).astype(np.int32)  # (64, 16)
# The anchor (the pixel whose index is stored one bit short) of subset 1 of
# a two-subset partition, and of subsets 1 and 2 of a three-subset one;
# subset 0's anchor is pixel 0.
ANCHORS2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
], np.int32)
ANCHORS3 = np.stack([
    np.array([
        3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
        3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
        8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
        3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
    ]),
    np.array([
        15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
        15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
        15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
        15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
    ]),
], axis=1).astype(np.int32)  # (64, 2)

# Per mode: subsets, partition bits, rotation bits, index-selection bits,
# color bits, alpha bits, per-endpoint p-bits, shared p-bits (one a subset),
# index bits, second index bits.
_MODES = (
    (3, 4, 0, 0, 4, 0, 1, 0, 3, 0),
    (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
    (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
    (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
    (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),
    (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
    (1, 0, 0, 0, 7, 7, 1, 0, 4, 0),
    (2, 6, 0, 0, 5, 5, 1, 0, 2, 0),
)


def _field(bits: np.ndarray, pos, n: int, width=None) -> np.ndarray:
    """The little-endian field of ``n`` bits (or of ``width`` <= ``n``, one
    a block) at bit ``pos`` (a scalar, or one position a block) of each
    block.  (B,) int32."""
    rows = np.arange(bits.shape[0])
    pos = np.broadcast_to(np.asarray(pos), rows.shape)
    out = np.zeros(rows.shape, np.int32)
    for k in range(n):
        bit = bits[rows, np.minimum(pos + k, 127)].astype(np.int32)
        out |= (bit if width is None else np.where(k < width, bit, 0)) << k
    return out


def _indices(bits: np.ndarray, start: int, nbits: int, anchor: np.ndarray) -> tuple[np.ndarray, int]:
    """The 16 ``nbits``-bit indices from bit ``start``, each anchor (B, 16)
    bool one bit short.  Returns ((B, 16) int32, the first bit after them)."""
    width = nbits - anchor.astype(np.int32)
    offset = start + np.cumsum(width, axis=1) - width
    idx = np.stack([_field(bits, offset[:, i], nbits, width[:, i]) for i in range(16)], axis=1)
    return idx, start + int(width[0].sum())


def _expand(x: np.ndarray, n: int) -> np.ndarray:
    """An ``n``-bit endpoint value to 8 bits by bit replication."""
    return (x << (8 - n)) | (x >> (2 * n - 8))


def _decode_mode(bits: np.ndarray, mode: int) -> np.ndarray:
    """(B, 128) bits of mode-``mode`` blocks -> (B, 16, 4) uint8 RGBA."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _MODES[mode]
    b = bits.shape[0]
    pos = mode + 1
    part = _field(bits, pos, pb)
    pos += pb
    rot = _field(bits, pos, rb)
    pos += rb
    isel = _field(bits, pos, isb)
    pos += isb
    ends = np.zeros((b, 2 * ns, 4), np.int32)  # endpoints s0e0, s0e1, s1e0, ...
    for c in range(3):
        for e in range(2 * ns):
            ends[:, e, c] = _field(bits, pos, cb)
            pos += cb
    for e in range(2 * ns if ab else 0):
        ends[:, e, 3] = _field(bits, pos, ab)
        pos += ab
    cbits, abits = cb, ab
    if epb or spb:
        pbits = np.stack([_field(bits, pos + e // (2 if spb else 1), 1) for e in range(2 * ns)], axis=1)
        pos += 2 * ns if epb else ns
        ends = (ends << 1) | pbits[..., None]
        cbits, abits = cb + 1, (ab + 1 if ab else 0)
    ends[..., :3] = _expand(ends[..., :3], cbits)
    ends[..., 3] = _expand(ends[..., 3], abits) if ab else 255

    if ns == 1:
        subset = np.zeros((b, 16), np.int32)
        anchor = _PIXEL[None, :] == 0
    elif ns == 2:
        subset = PARTITIONS2[part]
        anchor = (_PIXEL[None, :] == 0) | (_PIXEL[None, :] == ANCHORS2[part][:, None])
    else:
        subset = PARTITIONS3[part]
        a = ANCHORS3[part]
        anchor = (_PIXEL[None, :] == 0) | (_PIXEL[None, :] == a[:, :1]) | (_PIXEL[None, :] == a[:, 1:])
    idx, pos = _indices(bits, pos, ib, anchor)
    cw = aw = _WEIGHTS[ib][idx]
    if ib2:
        idx2, pos = _indices(bits, pos, ib2, _PIXEL[None, :].repeat(b, 0) == 0)
        w2 = _WEIGHTS[ib2][idx2]
        swap = (isel == 1)[:, None]
        cw, aw = np.where(swap, w2, cw), np.where(swap, cw, w2)
    assert pos == 128, (mode, pos)
    e0 = np.take_along_axis(ends, (2 * subset)[..., None], axis=1)  # (B, 16, 4)
    e1 = np.take_along_axis(ends, (2 * subset + 1)[..., None], axis=1)
    w = np.concatenate([np.repeat(cw[..., None], 3, axis=-1), aw[..., None]], axis=-1)
    px = ((64 - w) * e0 + w * e1 + 32) >> 6
    if rb:
        for r in (1, 2, 3):  # rotation r swaps alpha with channel r - 1
            m = rot == r
            px[m, :, r - 1], px[m, :, 3] = px[m, :, 3], px[m, :, r - 1].copy()
    return px.astype(np.uint8)


def decode_bc7(data: bytes, width: int, height: int) -> np.ndarray:
    """Decode raw BC7 blocks to (height, width, 4) uint8 RGBA."""
    if width % 4 or height % 4:
        raise ValueError(f"BC7 dimensions must be multiples of 4: {width}x{height}")
    nblocks = (width // 4) * (height // 4)
    if len(data) < nblocks * 16:
        raise ValueError(f"BC7 blob too short: {len(data)} < {nblocks * 16}")
    blocks = np.frombuffer(data, np.uint8, nblocks * 16).reshape(nblocks, 16)
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    lead = bits[:, :8]
    mode = np.where(lead.any(axis=1), lead.argmax(axis=1), 8)
    px = np.zeros((nblocks, 16, 4), np.uint8)
    px[..., 3] = 255  # a reserved mode: opaque black
    for m in range(8):
        rows = np.nonzero(mode == m)[0]
        if rows.size:
            px[rows] = _decode_mode(bits[rows], m)
    return (
        px.reshape(height // 4, width // 4, 4, 4, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(height, width, 4)
    )


def _pack_blocks_mode5(e0q, e1q, a0, a1, cidx, aidx) -> np.ndarray:
    """All mode-5 blocks at once: stored 7-bit RGB endpoints x2 + A 8 x2,
    two 2-bit index planes.  Vectorized via a (B, 128) bit matrix (the
    per-block big-int loop took minutes at 6M-splat texture sizes)."""
    b = e0q.shape[0]
    bits = np.zeros((b, 128), np.uint8)

    def put(pos: int, val: np.ndarray, n: int) -> int:
        for k in range(n):
            bits[:, pos + k] = (val >> k) & 1
        return pos + n

    bits[:, 5] = 1  # mode-5 marker (five 0 bits then a 1)
    pos = 8  # rotation bits 6-7 = 0 (alpha stays alpha)
    for c in range(3):
        pos = put(pos, e0q[:, c], 7)
        pos = put(pos, e1q[:, c], 7)
    pos = put(pos, a0, 8)
    pos = put(pos, a1, 8)
    pos = put(pos, cidx[:, 0], 1)  # anchor: 1 bit
    for i in range(1, 16):
        pos = put(pos, cidx[:, i], 2)
    pos = put(pos, aidx[:, 0], 1)  # anchor: 1 bit
    for i in range(1, 16):
        pos = put(pos, aidx[:, i], 2)
    assert pos == 128
    return bits


def _pack_blocks_mode6(e0q, e1q, p0, p1, idx) -> np.ndarray:
    """All mode-6 blocks: RGBA 7-bit endpoints x2 + per-endpoint pbits +
    one shared 4-bit index plane (anchor index stored in 3 bits)."""
    b = e0q.shape[0]
    bits = np.zeros((b, 128), np.uint8)

    def put(pos: int, val: np.ndarray, n: int) -> int:
        for k in range(n):
            bits[:, pos + k] = (val >> k) & 1
        return pos + n

    bits[:, 6] = 1  # mode-6 marker (six 0 bits then a 1)
    pos = 7
    for c in range(4):
        pos = put(pos, e0q[:, c], 7)
        pos = put(pos, e1q[:, c], 7)
    pos = put(pos, p0, 1)
    pos = put(pos, p1, 1)
    pos = put(pos, idx[:, 0], 3)  # anchor: 3 bits
    for i in range(1, 16):
        pos = put(pos, idx[:, i], 4)
    assert pos == 128
    return bits


def _fit_indices(blocks, e0, e1, weights):
    """Least-squares index per pixel along the e0->e1 segment; (B, 16)."""
    seg = (e1 - e0).astype(np.float32)
    seg_len = np.maximum(np.sum(seg * seg, axis=-1, keepdims=True), 1e-6)
    t = np.sum((blocks - e0[:, None]) * seg[:, None], axis=-1) / seg_len
    return np.argmin(
        np.abs(t[..., None] * 64.0 - weights[None, None]), axis=-1
    ).astype(np.int32)


def _refine_endpoints(vals, e0, e1, weights, iters: int = 2):
    """Alternate index-fit / weighted-least-squares endpoint refit.

    The min/max bounding box is only the initial guess: given the indices it
    induces, the optimal endpoints solve the per-block 2x2 normal equations
    of ``c_i ~= (1 - w_i) e0 + w_i e1`` (all channels share the index, so
    the 2x2 system is shared and only the RHS is per-channel).  Two
    alternations recover most of the gap to exhaustive endpoint search for
    smooth data.  Degenerate systems (single used index) keep the previous
    endpoints.  ``vals``: (B, 16, D) float; returns float (B, D) endpoints.
    """
    vals = vals.astype(np.float32)
    for _ in range(iters):
        idx = _fit_indices(vals, e0, e1, weights)
        w = weights[idx].astype(np.float32) / 64.0  # (B, 16)
        x = 1.0 - w
        sxx = np.sum(x * x, axis=-1)
        syy = np.sum(w * w, axis=-1)
        sxy = np.sum(x * w, axis=-1)
        det = sxx * syy - sxy * sxy
        bx = np.einsum("bi,bid->bd", x, vals)
        by = np.einsum("bi,bid->bd", w, vals)
        ok = (det > 1e-4)[:, None]
        inv = 1.0 / np.maximum(det, 1e-12)[:, None]
        n0 = (syy[:, None] * bx - sxy[:, None] * by) * inv
        n1 = (sxx[:, None] * by - sxy[:, None] * bx) * inv
        e0 = np.where(ok, np.clip(n0, 0.0, 255.0), e0)
        e1 = np.where(ok, np.clip(n1, 0.0, 255.0), e1)
    return e0, e1


def _quantize7(e: np.ndarray) -> np.ndarray:
    """Stored 7-bit value whose bit-replicated reconstruction
    ``(v << 1) | (v >> 6)`` is nearest to the target float."""
    t = np.clip(np.round(e), 0, 255).astype(np.int32)
    v = t >> 1
    cand = np.stack([v, np.minimum(v + 1, 127)], axis=-1)
    rec = (cand << 1) | (cand >> 6)
    pick = np.argmin(np.abs(rec - t[..., None]), axis=-1)
    return np.take_along_axis(cand, pick[..., None], axis=-1)[..., 0]


def _interp(e0, e1, idx, weights):
    """Spec interpolation: ((64 - w) * e0 + w * e1 + 32) >> 6, int arrays."""
    w = weights[idx]  # (B, 16)
    return ((64 - w[..., None]) * e0[:, None] + w[..., None] * e1[:, None] + 32) >> 6


def _pack_blocks_mode7(e0q, e1q, e2q, e3q, pbits, idx, part) -> np.ndarray:
    """All mode-7 blocks: 2 subsets, 6-bit partition, RGBA 5-bit endpoints
    (order per channel: s0e0, s0e1, s1e0, s1e1) + 4 per-endpoint pbits +
    one 2-bit index plane with two 1-bit anchors (pixel 0 and the
    partition's subset-1 anchor).  ``idx`` must already satisfy the anchor
    MSB-0 constraints."""
    b = e0q.shape[0]
    bits = np.zeros((b, 128), np.uint8)

    def put(pos: int, val: np.ndarray, n: int) -> int:
        for k in range(n):
            bits[:, pos + k] = (val >> k) & 1
        return pos + n

    bits[:, 7] = 1  # mode-7 marker (seven 0 bits then a 1)
    pos = put(8, part, 6)
    for c in range(4):
        for e in (e0q, e1q, e2q, e3q):
            pos = put(pos, e[:, c], 5)
    for j in range(4):
        pos = put(pos, pbits[:, j], 1)
    # The subset-1 anchor position varies per block (per partition), which
    # shifts every later index's bit offset — pack per anchor-position
    # group (<= 16 distinct values).
    anchor2 = ANCHORS2[part]  # (B,)
    for a2 in np.unique(anchor2):
        rows = np.nonzero(anchor2 == a2)[0]
        p2 = pos
        for i in range(16):
            n = 1 if (i == 0 or i == a2) else 2
            for k in range(n):
                bits[rows, p2 + k] = (idx[rows, i] >> k) & 1
            p2 += n
        assert p2 == 128, p2
    return bits


def _encode_mode5(blocks4: np.ndarray):
    """Mode-5 encode of (B, 16, 4) int blocks -> (bits (B, 128), recon)."""
    rgb = blocks4[..., :3]
    alpha = blocks4[..., 3:4]
    # Bounding-box initial endpoints, then alternate index-fit /
    # least-squares refit (shared index across RGB, so the refined segment
    # aligns with the block's principal color direction).
    e0f, e1f = _refine_endpoints(
        rgb, rgb.min(axis=1).astype(np.float32),
        rgb.max(axis=1).astype(np.float32), WEIGHTS2,
    )
    # The decoder reconstructs a 7-bit endpoint as (v << 1) | (v >> 6)
    # (bit replication); quantize onto and fit indices against that lattice.
    e0q = _quantize7(e0f)
    e1q = _quantize7(e1f)
    e0 = (e0q << 1) | (e0q >> 6)
    e1 = (e1q << 1) | (e1q >> 6)
    cidx = _fit_indices(rgb, e0, e1, WEIGHTS2)
    a0f, a1f = _refine_endpoints(
        alpha, alpha.min(axis=1).astype(np.float32),
        alpha.max(axis=1).astype(np.float32), WEIGHTS2,
    )
    a0 = np.clip(np.round(a0f), 0, 255).astype(np.int32)[:, 0]
    a1 = np.clip(np.round(a1f), 0, 255).astype(np.int32)[:, 0]
    aidx = _fit_indices(alpha, a0[:, None], a1[:, None], WEIGHTS2)
    # Anchor constraints: index 0 of each plane has 1 bit (must be 0 or 1).
    cswap = cidx[:, 0] > 1
    e0s = np.where(cswap[:, None], e1q, e0q)
    e1s = np.where(cswap[:, None], e0q, e1q)
    cidxs = np.where(cswap[:, None], 3 - cidx, cidx)
    aswap = aidx[:, 0] > 1
    a0s = np.where(aswap, a1, a0)
    a1s = np.where(aswap, a0, a1)
    aidxs = np.where(aswap[:, None], 3 - aidx, aidx)

    rec_rgb = _interp(
        (e0s << 1) | (e0s >> 6), (e1s << 1) | (e1s >> 6), cidxs, WEIGHTS2
    )
    rec_a = _interp(a0s[:, None], a1s[:, None], aidxs, WEIGHTS2)
    recon = np.concatenate([rec_rgb, rec_a], axis=-1)
    return _pack_blocks_mode5(e0s, e1s, a0s, a1s, cidxs, aidxs), recon


def _quantize7p(e: np.ndarray):
    """Mode-6 endpoint quantization: 7 stored bits + one pbit shared by all
    four channels of the endpoint; reconstruction is (v << 1) | p (exact
    8 bits).  Picks the pbit minimizing the endpoint's channel-sum error.
    Returns (v (B, 4), p (B,), reconstructed (B, 4))."""
    t = np.clip(np.round(e), 0, 255).astype(np.int32)  # (B, 4)
    best_err = None
    out = None
    for p in (0, 1):
        v = np.clip((t - p) >> 1, 0, 127)
        # Rounding down loses up to 1; check v and v+1 on the p-lattice.
        cand = np.stack([v, np.minimum(v + 1, 127)], axis=-1)
        rec = (cand << 1) | p
        pick = np.argmin(np.abs(rec - t[..., None]), axis=-1)
        v = np.take_along_axis(cand, pick[..., None], axis=-1)[..., 0]
        rec = (v << 1) | p
        err = np.sum((rec - t) ** 2, axis=-1)
        if best_err is None:
            best_err, out = err, (v, np.full(err.shape, p, np.int32), rec)
        else:
            m = err < best_err
            best_err = np.where(m, err, best_err)
            out = (
                np.where(m[:, None], v, out[0]),
                np.where(m, p, out[1]),
                np.where(m[:, None], rec, out[2]),
            )
    return out


def _fit_indices_masked(blocks, e0, e1, weights, mask):
    """As _fit_indices, but only mask pixels matter (others get index 0)."""
    idx = _fit_indices(blocks, e0, e1, weights)
    return np.where(mask, idx, 0)


def _refine_endpoints_masked(vals, mask, weights, iters: int = 2):
    """Masked variant of _refine_endpoints: fit one endpoint segment to the
    subset of pixels selected by ``mask`` (B, 16).  Starts from the masked
    bounding box.  Returns float (B, D) endpoint pairs."""
    vals = vals.astype(np.float32)
    m = mask.astype(np.float32)[..., None]  # (B, 16, 1)
    big = np.float32(1e9)
    e0 = np.min(np.where(m > 0, vals, big), axis=1)
    e1 = np.max(np.where(m > 0, vals, -big), axis=1)
    empty = ~mask.any(axis=1)
    e0[empty] = 0.0
    e1[empty] = 0.0
    for _ in range(iters):
        idx = _fit_indices(vals, e0, e1, weights)
        w = weights[idx].astype(np.float32) / 64.0 * m[..., 0]  # masked weights
        x = (1.0 - weights[idx].astype(np.float32) / 64.0) * m[..., 0]
        sxx = np.sum(x * x, axis=-1)
        syy = np.sum(w * w, axis=-1)
        sxy = np.sum(x * w, axis=-1)
        det = sxx * syy - sxy * sxy
        bx = np.einsum("bi,bid->bd", x, vals)
        by = np.einsum("bi,bid->bd", w, vals)
        ok = (det > 1e-4)[:, None]
        inv = 1.0 / np.maximum(det, 1e-12)[:, None]
        n0 = (syy[:, None] * bx - sxy[:, None] * by) * inv
        n1 = (sxx[:, None] * by - sxy[:, None] * bx) * inv
        e0 = np.where(ok, np.clip(n0, 0.0, 255.0), e0)
        e1 = np.where(ok, np.clip(n1, 0.0, 255.0), e1)
    return e0, e1


def _quantize5p(e: np.ndarray):
    """Mode-7 endpoint quantization: 5 stored bits + a per-endpoint pbit;
    reconstruction is val6 = (v << 1) | p, then (val6 << 2) | (val6 >> 4).
    Returns (v (B, 4), p (B,), reconstructed (B, 4))."""
    t = np.clip(np.round(e), 0, 255).astype(np.int32)
    best_err = None
    out = None
    for p in (0, 1):
        v = np.clip(((t >> 2) - p) >> 1, 0, 31)
        cand = np.stack([v, np.minimum(v + 1, 31)], axis=-1)
        v6 = (cand << 1) | p
        rec = (v6 << 2) | (v6 >> 4)
        pick = np.argmin(np.abs(rec - t[..., None]), axis=-1)
        v = np.take_along_axis(cand, pick[..., None], axis=-1)[..., 0]
        v6 = (v << 1) | p
        rec = (v6 << 2) | (v6 >> 4)
        err = np.sum((rec - t) ** 2, axis=-1)
        if best_err is None:
            best_err, out = err, (v, np.full(err.shape, p, np.int32), rec)
        else:
            m = err < best_err
            best_err = np.where(m, err, best_err)
            out = (
                np.where(m[:, None], v, out[0]),
                np.where(m, p, out[1]),
                np.where(m[:, None], rec, out[2]),
            )
    return out


def _encode_mode7(blocks4: np.ndarray, partitions=None):
    """Mode-7 encode of (B, 16, 4) int blocks -> (bits (B, 128), recon).

    2 subsets with a per-block partition search: splits bimodal blocks
    (two surfaces meeting in one chunk of Morton order) that a single
    endpoint segment cannot represent.  ``partitions``: iterable of
    partition ids to search (default: all 64)."""
    b = blocks4.shape[0]
    vals = blocks4.astype(np.float32)
    if partitions is None:
        partitions = range(64)

    best = None
    for p in partitions:
        mask1 = PARTITIONS2[p].astype(bool)[None, :].repeat(b, axis=0)
        mask0 = ~mask1
        e0f, e1f = _refine_endpoints_masked(vals, mask0, WEIGHTS2)
        e2f, e3f = _refine_endpoints_masked(vals, mask1, WEIGHTS2)
        e0q, p0, e0 = _quantize5p(e0f)
        e1q, p1, e1 = _quantize5p(e1f)
        e2q, p2, e2 = _quantize5p(e2f)
        e3q, p3, e3 = _quantize5p(e3f)
        idx0 = _fit_indices_masked(blocks4, e0, e1, WEIGHTS2, mask0)
        idx1 = _fit_indices_masked(blocks4, e2, e3, WEIGHTS2, mask1)
        a2 = ANCHORS2[p]
        # Anchor MSB-0 constraints per subset.
        swap0 = idx0[:, 0] > 1
        e0q, e1q = np.where(swap0[:, None], e1q, e0q), np.where(swap0[:, None], e0q, e1q)
        p0, p1 = np.where(swap0, p1, p0), np.where(swap0, p0, p1)
        e0, e1 = np.where(swap0[:, None], e1, e0), np.where(swap0[:, None], e0, e1)
        idx0 = np.where(swap0[:, None] & mask0, 3 - idx0, idx0)
        swap1 = idx1[:, a2] > 1
        e2q, e3q = np.where(swap1[:, None], e3q, e2q), np.where(swap1[:, None], e2q, e3q)
        p2, p3 = np.where(swap1, p3, p2), np.where(swap1, p2, p3)
        e2, e3 = np.where(swap1[:, None], e3, e2), np.where(swap1[:, None], e2, e3)
        idx1 = np.where(swap1[:, None] & mask1, 3 - idx1, idx1)
        idx = np.where(mask1, idx1, idx0)
        rec0 = _interp(e0, e1, idx, WEIGHTS2)
        rec1 = _interp(e2, e3, idx, WEIGHTS2)
        recon = np.where(mask1[..., None], rec1, rec0)
        sse = np.sum((recon - blocks4) ** 2, axis=(1, 2))
        entry = (sse, np.full(b, p, np.int32), e0q, e1q, e2q, e3q,
                 np.stack([p0, p1, p2, p3], axis=1), idx, recon)
        if best is None:
            best = entry
        else:
            better = sse < best[0]
            best = tuple(
                np.where(
                    better.reshape((-1,) + (1,) * (x.ndim - 1)), x, bx
                )
                for x, bx in zip(entry, best)
            )
    sse, part, e0q, e1q, e2q, e3q, pbits, idx, recon = best
    bits = _pack_blocks_mode7(e0q, e1q, e2q, e3q, pbits, idx, part)
    return bits, recon


def _encode_mode6(blocks4: np.ndarray):
    """Mode-6 encode of (B, 16, 4) int blocks -> (bits (B, 128), recon).

    One shared 4-bit index plane over RGBA: 16 interpolation levels (vs
    mode 5's 4) — the winner on smooth blocks with locally-flat alpha."""
    vals = blocks4.astype(np.float32)
    e0f, e1f = _refine_endpoints(
        vals, vals.min(axis=1), vals.max(axis=1), WEIGHTS4, iters=3
    )
    e0q, p0, e0 = _quantize7p(e0f)
    e1q, p1, e1 = _quantize7p(e1f)
    idx = _fit_indices(blocks4, e0, e1, WEIGHTS4)
    # Anchor: index 0 stored in 3 bits (must be < 8).
    swap = idx[:, 0] > 7
    e0s = np.where(swap[:, None], e1q, e0q)
    e1s = np.where(swap[:, None], e0q, e1q)
    p0s = np.where(swap, p1, p0)
    p1s = np.where(swap, p0, p1)
    idxs = np.where(swap[:, None], 15 - idx, idx)
    recon = _interp(
        (e0s << 1) | p0s[:, None], (e1s << 1) | p1s[:, None], idxs, WEIGHTS4
    )
    return _pack_blocks_mode6(e0s, e1s, p0s, p1s, idxs), recon


def _encode_blocks(blocks4: np.ndarray, mode7: bool) -> np.ndarray:
    """(B, 16, 4) int blocks -> (B, 128) bits of each block's best mode."""
    bits, rec = _encode_mode5(blocks4)
    sse = np.sum((rec - blocks4) ** 2, axis=(1, 2))
    candidates = [_encode_mode6(blocks4)]
    if mode7:
        candidates.append(_encode_mode7(blocks4))
    for bits_c, rec_c in candidates:
        sse_c = np.sum((rec_c - blocks4) ** 2, axis=(1, 2))
        better = sse_c < sse
        bits = np.where(better[:, None], bits_c, bits)
        sse = np.where(better, sse_c, sse)
    return bits


def encode_bc7(rgba: np.ndarray, mode7: bool = True) -> bytes:
    """Encode (H, W, 4) uint8 RGBA as BC7 (H, W % 4 == 0).

    Per block, the best of mode 5 (independent 2-bit color/alpha planes),
    mode 6 (shared 4-bit plane) and — unless ``mode7=False`` — mode 7
    (2 subsets, full 64-partition search) by reconstruction SSE.  Each block
    is encoded on its own, so slabs of ``_SLAB_BLOCKS`` blocks go to a pool
    of threads (numpy releases the interpreter lock in its loops; a slab's
    arrays stay in cache) and the bytes are those of one pass over all.
    """
    h, w, _ = rgba.shape
    if w % 4 or h % 4:
        raise ValueError(f"BC7 dimensions must be multiples of 4: {w}x{h}")
    # (nblocks, 16, 4) pixel blocks, row-major within each block.
    blocks4 = (
        rgba.reshape(h // 4, 4, w // 4, 4, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(-1, 16, 4)
        .astype(np.int32)
    )
    slabs = np.array_split(blocks4, -(-len(blocks4) // _SLAB_BLOCKS) or 1)
    with ThreadPoolExecutor(max_workers=min(len(slabs), _ENCODE_THREADS)) as pool:
        bits = np.concatenate(list(pool.map(functools.partial(_encode_blocks, mode7=mode7), slabs)))
    return np.packbits(bits, axis=1, bitorder="little").tobytes()
