"""Binning + pair-field preparation for the composite kernel.

The port of ``bin_and_prepare`` (unitygaussiansplatting_tpu/ops/pair_expand.py):

1. The per-splat pass, :func:`prepare_table`: per splat, the view-data
   rounding, the tile rect, the slot count (one sentinel slot per dead
   splat, so no run is empty), the quantized depth key and the (14, N)
   table column, plus the real pair count; then one in-place
   ``torch.cumsum`` of the slot counts gives the run bounds.  On a frame's
   route (``records``) it also writes each splat's record for K1: its
   composite fields, decoded from the configured lattices and staged as K1
   stages a pair, (N, 12).
2. K2, :func:`expand_pairs`: per slot, the fused sort key
   ``((tile << db) | depth_key) << 31 | splat`` as one int64, and, unless
   the frame reads the records, the 10 composite fields, decoded from the
   configured lattices.
3. The pair sort, :func:`sort_pairs` (this replaces the TPU package's
   two-key ``jax.lax.sort``): on CUDA a stable radix sort written by hand
   (``csrc/pair_sort.cu``) of the key's top bits, ``comp >> 31``; its last
   pass writes each sorted pair's tile and splat id
   (``TileBinning.pair_rank``), and a search over the sorted tiles gives
   ``tile_starts``.  With per-slot fields every slot is sorted, with its
   slot as its value, and a gather by the permutation sorts the fields;
   with records there is nothing to gather (K1 reads sorted pair ``j``'s
   fields from record ``pair_rank[j]``), and only the pairs of real tiles
   are sorted, counted on the card: the sentinel tile's slots (the tail
   past the demand, dead splats, K2's culls) are dropped.  The key
   is shifted by 31, not 32: keys >= 2^31 occur (db = 23 at 475 tiles), and
   a 32-bit shift would make them negative.  On the CPU,
   :func:`sort_pairs_plain`: one ``torch.sort`` of the int64 keys, the
   gather, ``searchsorted``.

A frame without autograd takes the records wherever every field depends on
the splat alone (:func:`per_splat_fields`: no center packing).  The graph
route keeps the per-slot fields, which K3 reads, and the sort's permutation
(``TileBinning.perm``: the slot of each sorted pair) and the slot runs
(``TileBinning.bounds``), for the backward, which writes each pair's
gradient back into its slot, where the runs are splat-major.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..utils.config import RasterizeConfig
from . import cuda_build
from .binning import TileBinning, depth_key_bits, pair_budget, quantize_depth, tile_grid, tile_rects
from .tile_common import (
    AX32_LO, AX32_STEP, AX32_TWO_PI, F16_MIN_NORMAL, PI, axes_u32_codes, quantize_view_fp16, true_div,
)

NUM_FIELDS = 10  # cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity
TABLE_ROWS = 14  # the 10 fields, then x0, y0, nx, depth key
# A splat's record for K1: (cx, cy, a1x/|a1|^2, a1y/|a1|^2), (a2x/|a2|^2,
# a2y/|a2|^2, opacity, 0), (r, g, b, 0).
RECORD_FLOATS = 12
SPLAT_BITS = 31  # splat id bits below the fused key in the int64 sort key
SORT_DIGIT_BITS = 8  # bits a pass of the pair sort orders

QUAD_CLIP, PACK_CENTER, PACK_AX32, PACK_AXES_F16, PACK_COLOR_F16, PACK_RGBA8 = 1, 2, 4, 8, 16, 32


def expand_flags(config: RasterizeConfig) -> int:
    """The kernels' flag word for a config.  Center packing needs the
    ellipse cull's survival bound, so it is off without alpha discard and
    quad clip (as in the TPU package)."""
    pack_center = config.pack_center_u32 and (config.alpha_discard > 0.0 or config.quad_clip)
    return (
        QUAD_CLIP * config.quad_clip
        | PACK_CENTER * pack_center
        | PACK_AX32 * config.pack_axes_u32
        | PACK_AXES_F16 * config.pack_axes_f16
        | PACK_COLOR_F16 * config.pack_color_f16
        | PACK_RGBA8 * config.pack_color_rgba8
    )


def per_splat_fields(config: RasterizeConfig) -> bool:
    """Whether every composite field of a pair depends on its splat alone,
    so that a frame may read them from one record a splat: all but center
    packing, whose center is an offset from the pair's tile."""
    return not expand_flags(config) & PACK_CENTER


def inverse_axes(a1x, a1y, a2x, a2y):
    """K1's per-pair divisions: ``a / max(|a|^2, 1e-12)`` for both axes."""
    a1_sq = torch.clamp(a1x * a1x + a1y * a1y, min=1e-12)
    a2_sq = torch.clamp(a2x * a2x + a2y * a2y, min=1e-12)
    return a1x / a1_sq, a1y / a1_sq, a2x / a2_sq, a2y / a2_sq


def splat_records_plain(table, config: RasterizeConfig):
    """Plain PyTorch version of the record the per-splat pass writes with
    ``records``: (N, 12) float32, each splat's table column decoded as K2
    decodes its slots' fields and divided as K1 stages a pair."""
    _, (a1x, a1y, a2x, a2y), (r, g, b, op) = _splat_fields(table, expand_flags(config))
    zero = torch.zeros_like(op)
    return torch.stack([table[0], table[1], *inverse_axes(a1x, a1y, a2x, a2y), op, zero, r, g, b, zero], 1)


def prepare_table_plain(proj, width: int, height: int, config: RasterizeConfig, records: bool = False):
    """Plain PyTorch version of the per-splat pass: the same function as
    :func:`prepare_table`, whole-tensor operations over the splats."""
    proj = quantize_view_fp16(proj, config)
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    db = depth_key_bits(num_tiles, config)
    x0, y0, nx, _, counts, valid = tile_rects(proj, width, height, config)
    live = valid & (counts > 0)
    counts_slots = torch.where(live, counts, 1).to(torch.int32)
    x0f = torch.where(live, x0.to(torch.float32), float(num_tiles))
    y0f = torch.where(live, y0.to(torch.float32), 0.0)
    nxf = torch.where(live, nx.to(torch.float32), 1.0)
    dqf = torch.where(live, quantize_depth(proj.depth, db), 0).to(torch.float32)  # < 2^24
    bounds = torch.cat(
        [counts_slots.new_zeros(1), torch.cumsum(counts_slots, 0, dtype=torch.int32)]
    )
    num_real = torch.sum(counts, dtype=torch.int32)
    if config.pack_axes_u32:
        tc, n1c, n2c = axes_u32_codes(proj.axis1, proj.axis2)
        zero = torch.zeros_like(tc)
        ax_rows = [tc * 1024.0 + n1c, n2c, zero, zero]
    else:
        ax_rows = [proj.axis1[:, 0], proj.axis1[:, 1], proj.axis2[:, 0], proj.axis2[:, 1]]
    table = torch.stack(
        [
            proj.center[:, 0], proj.center[:, 1], *ax_rows,
            proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
            torch.where(live, proj.opacity, 0.0),
            x0f, y0f, nxf, dqf,
        ]
    )
    # Dead-splat geometry can be NaN (behind-camera projections).
    table = torch.where(torch.isfinite(table), table, 0.0).contiguous().detach()
    if records:
        return table, bounds, num_real, splat_records_plain(table, config)
    return table, bounds, num_real


def scan_bounds(bounds):
    """The run bounds from ``(0, slot counts...)``: one inclusive
    ``torch.cumsum``, in place.  A library scan outside any kernel, as the
    TPU package leaves its ``jnp.cumsum`` to XLA."""
    return bounds.cumsum_(0)


def prepare_table(proj, width: int, height: int, config: RasterizeConfig, records: bool = False):
    """Per-splat inputs of K2: ``(table (14, N) f32, bounds (N+1,) i32,
    num_real () i32)``; splat ``i`` owns slots ``[bounds[i], bounds[i+1])``.
    With ``records`` a fourth output, K1's per-splat record (N, 12) f32
    (:func:`splat_records_plain`), which needs :func:`per_splat_fields`.

    Table rows: cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity (0 for dead
    splats), x0, y0, nx, depth key; with ``pack_axes_u32`` rows 2/3 hold the
    axis codes ``theta*1024 + n1`` and ``n2`` and rows 4/5 are 0.  Dead
    splats point at the sentinel tile (x0 = num_tiles).

    Replaces the XLA prelude of the TPU package's ``bin_and_prepare``
    (unitygaussiansplatting_tpu/ops/pair_expand.py:579-653).  One CUDA
    thread per splat (``csrc/pair_table.cu``) reads the projection's columns
    at their strides (views need no copy) and writes the table column, the
    slot count into ``bounds[1 + i]`` and its block's real pairs into
    ``num_real``; :func:`scan_bounds` then turns the counts into the run
    bounds.  Bound on the H100 by bytes (45 read and 60 written per splat,
    48 more with the record).  CPU tensors take :func:`prepare_table_plain`;
    CUDA tensors launch the kernel.
    """
    if records and not per_splat_fields(config):
        raise ValueError("records need fields that depend on the splat alone; center packing makes the "
                         "center depend on the tile")
    dev = proj.depth.device
    if dev.type == "cpu":
        return prepare_table_plain(proj, width, height, config, records)
    if dev.type != "cuda":
        raise ValueError(f"prepare_table runs on CPU or CUDA tensors, got {dev}")
    n = proj.depth.shape[0]
    if proj.depth.dim() != 1 or n >= 2**31:
        raise ValueError(f"proj.depth must be (N,) with N < 2^31, got {tuple(proj.depth.shape)}")
    op = cuda_build.operand
    cols = [
        *op(proj.center, "proj.center", (n, 2), dev), *op(proj.axis1, "proj.axis1", (n, 2), dev),
        *op(proj.axis2, "proj.axis2", (n, 2), dev), *op(proj.color, "proj.color", (n, 3), dev),
        *op(proj.opacity, "proj.opacity", (n,), dev), *op(proj.depth, "proj.depth", (n,), dev),
        *op(proj.valid, "proj.valid", (n,), dev, torch.bool),
    ]
    tiles_x, tiles_y = tile_grid(width, height, config)
    table = torch.empty((TABLE_ROWS, n), dtype=torch.float32, device=dev)
    bounds = torch.empty(n + 1, dtype=torch.int32, device=dev)
    num_real = torch.zeros((), dtype=torch.int32, device=dev)
    record = torch.empty((n, RECORD_FLOATS), dtype=torch.float32, device=dev) if records else None
    cuda_build.launch(
        "pair_table", "pair_table_launch", dev,
        *cols, n, tiles_x, tiles_y, config.tile_w, config.tile_h, depth_key_bits(tiles_x * tiles_y, config),
        config.alpha_discard, expand_flags(config), table.data_ptr(), bounds.data_ptr(), num_real.data_ptr(),
        record.data_ptr() if records else None,
    )
    if records:
        return table, scan_bounds(bounds), num_real, record
    return table, scan_bounds(bounds), num_real


# ---------------------------------------------------------------------------
# K2 and its plain version.


def _f16_round_trip(x):
    r = x.to(torch.float16).to(torch.float32)
    return torch.where(torch.abs(r) < F16_MIN_NORMAL, torch.copysign(torch.zeros_like(x), x), r)


def _unorm8_round_trip(x, scale: float):
    code = torch.floor(x * scale + 0.5).to(torch.int32) & 0xFF
    return true_div(code.to(torch.float32), scale)


def _qcap(op, alpha_discard: float):
    if alpha_discard > 0.0:
        return torch.clamp(torch.log(true_div(torch.clamp(op, min=1e-30), alpha_discard)), min=0.0)
    return torch.full_like(op, 1e30)


def _center_frame(a1x, a1y, a2x, a2y, op, config: RasterizeConfig):
    n1 = torch.sqrt(torch.clamp(a1x * a1x + a1y * a1y, min=1e-12))
    n2 = torch.sqrt(torch.clamp(a2x * a2x + a2y * a2y, min=1e-12))
    u1x, u1y = a1x / n1, a1y / n1
    sg = torch.where(a2y * u1x - a2x * u1y >= 0.0, 1.0, -1.0)
    u2x, u2y = -sg * u1y, sg * u1x
    qb = torch.sqrt(torch.clamp(_qcap(op, config.alpha_discard) * 1.0002 + 1e-3, min=0.0))
    if config.quad_clip:
        qb = torch.clamp(qb, max=2.001)
    tw, th = config.tile_w, config.tile_h
    half1 = 0.5 * (torch.abs(u1x) * tw + torch.abs(u1y) * th)
    half2 = 0.5 * (torch.abs(u2x) * tw + torch.abs(u2y) * th)
    r1 = qb * n1 + half1 + 0.51
    r2 = qb * n2 + half2 + 0.51 + 0.002 * r1
    return u1x, u1y, u2x, u2y, r1, r2


def _min_abs_q(ax, ay, inv, dx_lo, dx_hi, dy_lo, dy_hi):
    tx_min = torch.minimum(dx_lo * ax, dx_hi * ax)
    tx_max = torch.maximum(dx_lo * ax, dx_hi * ax)
    ty_min = torch.minimum(dy_lo * ay, dy_hi * ay)
    ty_max = torch.maximum(dy_lo * ay, dy_hi * ay)
    q_min = (tx_min + ty_min) * inv
    q_max = (tx_max + ty_max) * inv
    return torch.clamp(torch.maximum(q_min, -q_max), min=0.0)


def _splat_fields(table, flags: int):
    """What K2 derives from a splat's table column for any of its tiles:
    ``(axes, field_axes, colors)``, the decoded axes (a1x, a1y, a2x, a2y),
    the axes after the pack round trips, and (r, g, b, opacity) after them;
    each a (N,) tensor, computed once a splat."""
    if flags & PACK_AX32:
        tcv = torch.floor(table[2] * (1.0 / 1024.0))
        n1cv = table[2] - tcv * 1024.0
        theta = tcv * (AX32_TWO_PI / 4096.0) - PI
        ct, st = torch.cos(theta), torch.sin(theta)
        n1v = torch.exp2(AX32_LO + n1cv * AX32_STEP)
        n2v = torch.exp2(AX32_LO + table[3] * AX32_STEP)
        axes = (n1v * ct, n1v * st, n2v * st, -n2v * ct)
    else:
        axes = (table[2], table[3], table[4], table[5])
    field_axes = tuple(_f16_round_trip(a) for a in axes) if flags & PACK_AXES_F16 and not flags & PACK_AX32 else axes
    if flags & PACK_RGBA8:
        colors = tuple(_unorm8_round_trip(c, 127.5) for c in table[6:9]) + (_unorm8_round_trip(table[9], 255.0),)
    elif flags & PACK_COLOR_F16:
        colors = tuple(_f16_round_trip(c) for c in table[6:10])
    else:
        colors = tuple(table[6:10])
    return axes, field_axes, colors


def expand_pairs_plain(table, bounds, k: int, width: int, height: int, config: RasterizeConfig,
                       keys_only: bool = False):
    """Plain PyTorch version of K2: the same function, vectorized over slots."""
    n = table.shape[1]
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    db = depth_key_bits(num_tiles, config)
    flags = expand_flags(config)
    dev = table.device
    slots = torch.arange(k, device=dev, dtype=torch.int64)
    b64 = bounds.to(torch.int64)
    live = slots < b64[n]
    splat = torch.searchsorted(b64, slots, right=True) - 1
    idx = torch.clamp(splat, max=n - 1)
    col = table[:, idx]  # (14, k)
    j = slots - b64[idx]
    nx = torch.clamp(col[12].to(torch.int64), min=1)
    tq = torch.div(j, nx, rounding_mode="floor")
    tx = col[10].to(torch.int64) + (j - tq * nx)
    ty = col[11].to(torch.int64) + tq
    tile = ty * tiles_x + tx
    dq = col[13].to(torch.int64)
    cx, cy, op = col[0], col[1], col[9]
    splat_axes, splat_field_axes, splat_colors = _splat_fields(table, flags)
    a1x, a1y, a2x, a2y = (a[idx] for a in splat_axes)

    # Ellipse-interval cull to the sentinel tile.
    tw, th = config.tile_w, config.tile_h
    qcap = _qcap(op, config.alpha_discard)
    inv1 = 1.0 / torch.clamp(a1x * a1x + a1y * a1y, min=1e-12)
    inv2 = 1.0 / torch.clamp(a2x * a2x + a2y * a2y, min=1e-12)
    txf, tyf = tx.to(torch.float32), ty.to(torch.float32)
    dx_lo = txf * tw + 0.5 - cx
    dx_hi = txf * tw + (tw - 0.5) - cx
    dy_lo = tyf * th + 0.5 - cy
    dy_hi = tyf * th + (th - 0.5) - cy
    mqx = _min_abs_q(a1x, a1y, inv1, dx_lo, dx_hi, dy_lo, dy_hi)
    mqy = _min_abs_q(a2x, a2y, inv2, dx_lo, dx_hi, dy_lo, dy_hi)
    touches = mqx * mqx + mqy * mqy <= qcap * 1.0002 + 1e-3
    if flags & QUAD_CLIP:
        touches &= (mqx <= 2.001) & (mqy <= 2.001)
    tile_i = torch.where(touches, tile, num_tiles)
    key = (tile_i << db) | dq
    sentinel = ((num_tiles << db) << SPLAT_BITS) | n
    comp = torch.where(live, (key << SPLAT_BITS) | splat, sentinel)
    if keys_only:
        return comp, None

    axes = [a[idx] for a in splat_field_axes]
    colors = [c[idx] for c in splat_colors]
    if flags & PACK_CENTER:
        tcx = (tile_i % tiles_x).to(torch.float32) * tw + 0.5 * tw
        tcy = torch.div(tile_i, tiles_x, rounding_mode="floor").to(torch.float32) * th + 0.5 * th
        u1x, u1y, u2x, u2y, r1, r2 = _center_frame(a1x, a1y, a2x, a2y, op, config)
        dxc, dyc = cx - tcx, cy - tcy
        s1 = dxc * u1x + dyc * u1y
        s2 = dxc * u2x + dyc * u2y
        q1 = torch.clamp(torch.floor(s1 / r1 * 2047.0 + 0.5) + 2048.0, 0.0, 4095.0)
        q2 = torch.clamp(torch.floor(s2 / r2 * 65535.0 + 0.5) + 65536.0, 0.0, 131071.0)
        u1x, u1y, u2x, u2y, r1, r2 = _center_frame(*axes, colors[3], config)
        ds1 = (q1 - 2048.0) * true_div(r1, 2047.0)
        ds2 = (q2 - 65536.0) * true_div(r2, 65535.0)
        center = [tcx + ds1 * u1x + ds2 * u2x, tcy + ds1 * u1y + ds2 * u2y]
    else:
        center = [cx, cy]
    fields = torch.stack(center + axes + colors)
    fields = torch.where(live, fields, 0.0)
    return comp, fields


def expand_pairs(table, bounds, k: int, width: int, height: int, config: RasterizeConfig,
                 keys_only: bool = False):
    """K2: expand per-splat rows into ``k`` (splat, tile) slots.

    Returns ``(comp (k,) int64, fields (10, k) float32)`` in slot order, or
    ``(comp, None)`` with ``keys_only`` (a frame that reads the per-splat
    records); see ``csrc/pair_expand.cu`` for the layout.  Replaces the
    Pallas kernel ``_expand_kernel``
    (unitygaussiansplatting_tpu/ops/pair_expand.py:90).  Bound on the H100
    by bytes (60 B per splat read, 48 B per slot written, 8 keys only).  A
    block of 256 threads walks 8 windows of 512 slots, two a thread with
    coalesced 16- and 8-byte stores; the window's splats are staged and
    derived once each in shared memory, and each slot does only its tile's
    work.  CPU tensors take :func:`expand_pairs_plain`; CUDA
    tensors launch the kernel.
    """
    if table.dim() != 2 or table.shape[0] != TABLE_ROWS or table.dtype != torch.float32:
        raise ValueError(f"table must be ({TABLE_ROWS}, N) float32, got {tuple(table.shape)} {table.dtype}")
    n = table.shape[1]
    if n < 1 or bounds.shape != (n + 1,) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be ({n + 1},) int32 with N >= 1, got {tuple(bounds.shape)} {bounds.dtype}")
    if bounds.device != table.device:
        raise ValueError("table and bounds must be on one device")
    if table.device.type == "cpu":
        return expand_pairs_plain(table, bounds, k, width, height, config, keys_only)
    if table.device.type != "cuda":
        raise ValueError(f"expand_pairs runs on CPU or CUDA tensors, got {table.device}")
    if not (table.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("table and bounds must be contiguous")
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    comp = torch.empty(k, dtype=torch.int64, device=table.device)
    fields = None if keys_only else torch.empty((NUM_FIELDS, k), dtype=torch.float32, device=table.device)
    cuda_build.launch(
        "pair_expand", "expand_pairs_launch", table.device,
        table.data_ptr(), bounds.data_ptr(), n, k, tiles_x, num_tiles,
        config.tile_w, config.tile_h, depth_key_bits(num_tiles, config), config.alpha_discard,
        expand_flags(config), comp.data_ptr(), None if keys_only else fields.data_ptr(),
    )
    return comp, fields


def expand_probe_plain(k: int, device, keys_only: bool = False):
    """Plain PyTorch version of the K2 grid probe: K2's outputs, all zero."""
    comp = torch.zeros(k, dtype=torch.int64, device=device)
    return comp, None if keys_only else torch.zeros((NUM_FIELDS, k), dtype=torch.float32, device=device)


def expand_probe(k: int, device, keys_only: bool = False):
    """K2's launch with none of its work: ``(comp (k,) int64, fields (10, k)
    float32 or None)``, zeros written in K2's launch geometry and store
    widths, to all of K2's outputs or (``keys_only``) the keys alone.

    A measurement tool, on no path of the system: its time is K2's floor of
    launch + stores.  Replaces the no-op Pallas kernels of
    tools/tpu_jobs/475_expand_overhead.py (:117 and :146).  Bound on the H100
    by bytes (48 or 8 per slot written).  The CPU takes
    :func:`expand_probe_plain`; a CUDA device launches the kernel.
    """
    device = torch.device(device)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if device.type == "cpu":
        return expand_probe_plain(k, device, keys_only)
    if device.type != "cuda":
        raise ValueError(f"expand_probe runs on CPU or CUDA, got {device}")
    comp = torch.empty(k, dtype=torch.int64, device=device)
    fields = None if keys_only else torch.empty((NUM_FIELDS, k), dtype=torch.float32, device=device)
    cuda_build.launch(
        "expand_probe", "expand_probe_launch", device,
        k, int(keys_only), comp.data_ptr(), None if keys_only else fields.data_ptr(),
    )
    return comp, fields


def sort_key_bits(num_tiles: int, db: int) -> int:
    """Bits of the pair sort's key ``comp >> SPLAT_BITS``: the tile (the
    sentinel ``num_tiles`` the largest) above ``db`` depth bits."""
    return num_tiles.bit_length() + db


def sort_passes(num_tiles: int, db: int) -> int:
    """Radix passes of the pair sort on CUDA: one an 8-bit digit of the key."""
    return -(-sort_key_bits(num_tiles, db) // SORT_DIGIT_BITS)


def sort_pairs_plain(comp, fields, num_tiles: int, db: int, demand=None):
    """Plain PyTorch version of :func:`sort_pairs`: one stable ``torch.sort``
    of the int64 keys, the gather of the fields by its permutation (neither
    kept without fields), and ``searchsorted`` over the sorted keys for the
    tile starts.  Every slot is sorted: ``demand`` is not read (every slot
    at or past it is in the sentinel tile, so the outputs on ``[0,
    tile_starts[num_tiles])`` are the kernels' either way)."""
    comp_s, perm = torch.sort(comp, stable=True)
    fields_s, perm = (None, None) if fields is None else (fields.index_select(1, perm), perm)
    tile_keys = (torch.arange(num_tiles + 1, device=comp.device, dtype=torch.int64) << db) << SPLAT_BITS
    tile_starts = torch.searchsorted(comp_s, tile_keys).to(torch.int32)
    pair_tile = (comp_s >> (SPLAT_BITS + db)).to(torch.int32)
    pair_rank = (comp_s & ((1 << SPLAT_BITS) - 1)).to(torch.int32)
    return fields_s, tile_starts, perm, pair_tile, pair_rank


def sort_keys_cuda(comp, num_tiles: int, db: int, with_perm: bool = True, demand=None):
    """The pair sort's kernels (``csrc/pair_sort.cu``) on K2's int64 keys
    ``comp`` (K,), a CUDA tensor: ``(tile_starts (T+1,) i32, perm (K,) i64,
    pair_tile (K,) i32, pair_rank (K,) i32)``.

    The splat id below bit 31 never falls as the slot rises (slots are
    splat-major), so a stable sort of ``comp >> 31``, the
    :func:`sort_key_bits` bits of (tile | depth), gives
    ``torch.sort(comp, stable=True)``'s order: one upsweep (every pass's
    digit histogram), :func:`sort_passes` passes of 8-bit digits (the last
    writes each pair's tile and splat id), then a search for each tile's
    first pair.  Bound on the H100 by bytes.

    ``with_perm``: every slot sorted, each with its slot as its value, and
    every output as :func:`sort_pairs_plain` gives it, ``perm`` the slot of
    each sorted pair.  Without it (the record route) ``perm`` is None and
    only the R pairs of real tiles are sorted: the slots below ``demand``
    (a () int32 CUDA tensor, the slot demand ``bounds[N]``; None: all K)
    whose tile is below ``num_tiles``.  R is counted on the card, and
    ``tile_starts`` is the plain version's (``tile_starts[num_tiles]`` = R);
    ``pair_tile`` and ``pair_rank`` are the plain version's on ``[0, R)``
    and left unwritten past it.
    """
    k = comp.shape[0]
    dev = comp.device
    if k >= 2**31 or sort_key_bits(num_tiles, db) > 32:
        raise ValueError(f"the pair sort takes K < 2^31 and keys of <= 32 bits, got K={k}, "
                         f"{sort_key_bits(num_tiles, db)} bits ({num_tiles} tiles, db={db})")
    if dev.type != "cuda" or not comp.is_contiguous():
        raise ValueError(f"comp must be a contiguous CUDA tensor, got one on {dev}")
    if demand is not None and (demand.shape != () or demand.dtype != torch.int32 or demand.device != dev):
        raise ValueError(f"demand must be a () int32 tensor on {dev}, got {tuple(demand.shape)} {demand.dtype} on "
                         f"{demand.device}")
    passes, radix = sort_passes(num_tiles, db), 1 << SORT_DIGIT_BITS
    tiles = -(-k // cuda_build.library("pair_sort").pair_sort_tile_keys())
    # Scratch: the keys' and values' double buffers, each slot's splat id
    # (with the permutation), every pass's histogram and tile counter and
    # the record route's R, the look-back words.
    keys = torch.empty((2, k), dtype=torch.int32, device=dev)
    vals = torch.empty((2, k), dtype=torch.int32, device=dev)
    splats = torch.empty(k, dtype=torch.int32, device=dev) if with_perm else None
    state = torch.empty(passes * (radix + 1) + 1, dtype=torch.int32, device=dev)
    lookback = torch.empty((2, tiles, radix), dtype=torch.int64, device=dev)
    perm = torch.empty(k, dtype=torch.int64, device=dev) if with_perm else None
    pair_tile = torch.empty(k, dtype=torch.int32, device=dev)
    pair_rank = torch.empty(k, dtype=torch.int32, device=dev)
    tile_starts = torch.empty(num_tiles + 1, dtype=torch.int32, device=dev)
    demand_ptr = None if with_perm or demand is None else demand.data_ptr()
    cuda_build.launch("pair_sort", "pair_sort_upsweep_launch", dev,
                      comp.data_ptr(), k, demand_ptr, int(not with_perm), num_tiles, db, passes, state.data_ptr(),
                      lookback.data_ptr(), tiles)
    for p in range(passes):
        cuda_build.launch(
            "pair_sort", "pair_sort_pass_launch", dev,
            comp.data_ptr(), keys.data_ptr(), vals.data_ptr(), splats.data_ptr() if with_perm else None, k,
            demand_ptr, num_tiles, p, passes, db, state.data_ptr(), lookback.data_ptr(), tiles,
            perm.data_ptr() if with_perm else None, pair_tile.data_ptr(), pair_rank.data_ptr(),
        )
    cuda_build.launch("pair_sort", "pair_sort_starts_launch", dev,
                      pair_tile.data_ptr(), k, None if with_perm else state[-1:].data_ptr(), num_tiles,
                      tile_starts.data_ptr())
    return tile_starts, perm, pair_tile, pair_rank


def sort_pairs(comp, fields, num_tiles: int, db: int, demand=None):
    """Sort slots by K2's int64 key and gather their fields.

    Returns ``(sorted fields (10, K), tile_starts (T+1,) i32, perm (K,) i64,
    pair_tile (K,) i32, pair_rank (K,) i32)``: ``perm[j]`` is the slot of
    sorted pair ``j``, ``pair_tile`` its tile (``num_tiles``: the sentinel)
    and ``pair_rank`` its splat id (N for unused slots).  Ties in the key
    are never-used tail slots or repeated culls of one splat, whose fields
    are equal; the sort is stable, so ``perm`` is the one order.  ``fields``
    None (a frame that reads the per-splat records through ``pair_rank``):
    no per-slot data to move, so nothing is gathered and no permutation is
    kept: the first and third outputs are None.

    Replaces no TPU kernel (the TPU package's sort is XLA's
    ``jax.lax.sort``).  CUDA tensors launch :func:`sort_keys_cuda`'s
    kernels, then gather the fields by ``perm``; CPU tensors take
    :func:`sort_pairs_plain`.  Without ``fields`` on CUDA the kernels sort
    only the pairs of real tiles, of the slots below ``demand`` (() int32,
    ``bounds[N]``; None: all K): ``pair_tile`` and ``pair_rank`` past
    ``tile_starts[num_tiles]`` are left unwritten there, and every reader
    (K1, :func:`~.rasterize_cuda.composite_tiles_plain`) reads only
    ``[0, tile_starts[num_tiles])``.
    """
    k = comp.shape[0]
    if comp.dim() != 1 or comp.dtype != torch.int64:
        raise ValueError(f"comp must be (K,) int64, got {tuple(comp.shape)} {comp.dtype}")
    if fields is not None and (fields.shape != (NUM_FIELDS, k) or fields.device != comp.device):
        raise ValueError(f"fields must be ({NUM_FIELDS}, {k}) on {comp.device}, got {tuple(fields.shape)} on "
                         f"{fields.device}")
    if comp.device.type == "cpu":
        return sort_pairs_plain(comp, fields, num_tiles, db, demand)
    if comp.device.type != "cuda":
        raise ValueError(f"sort_pairs runs on CPU or CUDA tensors, got {comp.device}")
    tile_starts, perm, pair_tile, pair_rank = sort_keys_cuda(comp, num_tiles, db, fields is not None, demand)
    fields_s = None if fields is None else fields.index_select(1, perm)
    return fields_s, tile_starts, perm, pair_tile, pair_rank


def bin_and_prepare(proj, width: int, height: int, config: RasterizeConfig = RasterizeConfig(),
                    records: bool = False):
    """Fused binning + pair-field preparation.

    Returns ``(TileBinning, fields, num_real () int32)``;
    ``binning.num_pairs`` is the slot demand including one sentinel slot per
    dead splat, ``binning.pair_rank`` the splat id per sorted pair (N for
    unused slots).  ``fields`` is (10, K) float32 in sorted pair order: K2
    writes them per slot and the sort gathers them.  With ``records`` (a
    frame without autograd, where :func:`per_splat_fields` holds) it is the
    (N, 12) float32 per-splat record instead, written by the per-splat pass:
    K2 writes keys only, nothing is gathered, and the composite reads sorted
    pair ``j``'s fields at row ``binning.pair_rank[j]``
    (``composite_tiles(..., pair_rank=binning.pair_rank)``); the sort keeps
    no permutation then (``binning.perm`` None), as nothing per slot is
    moved, and sorts only the pairs of real tiles: ``binning.pair_tile`` and
    ``binning.pair_rank`` hold them on ``[0, binning.tile_starts[T])`` and
    are left unwritten past it on CUDA.
    """
    n = proj.depth.shape[0]
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    db = depth_key_bits(num_tiles, config)
    k = pair_budget(n, config)
    table, bounds, num_real, *record = prepare_table(proj, width, height, config, records)
    comp, fields = expand_pairs(table, bounds, k, width, height, config, keys_only=records)
    with record_function("splat_sort"):
        fields_s, tile_starts, perm, pair_tile, pair_rank = sort_pairs(comp, fields, num_tiles, db, bounds[-1])
    binning = TileBinning(
        pair_rank=pair_rank,
        pair_tile=pair_tile,
        tile_starts=tile_starts,
        num_pairs=bounds[-1],
        perm=perm,
        bounds=bounds,
    )
    return binning, record[0] if records else fields_s, num_real
