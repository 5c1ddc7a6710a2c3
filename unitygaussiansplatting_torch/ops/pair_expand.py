"""Binning + pair-field preparation for the composite kernel.

The port of ``bin_and_prepare`` (unitygaussiansplatting_tpu/ops/pair_expand.py):

1. The per-splat pass, :func:`prepare_table`: per splat, the view-data
   rounding, the tile rect, the slot count (one sentinel slot per dead
   splat, so no run is empty), the quantized depth key and the (14, N)
   table column, plus the real pair count; then one in-place
   ``torch.cumsum`` of the slot counts gives the run bounds.
2. K2, :func:`expand_pairs`: per slot, the fused sort key
   ``((tile << db) | depth_key) << 31 | splat`` as one int64 and the 10
   composite fields, decoded from the configured lattices.
3. One ``torch.sort`` of the int64 keys (this replaces the TPU package's
   two-key ``jax.lax.sort``), then a gather of the fields.  The key is
   shifted by 31, not 32: keys >= 2^31 occur (db = 23 at 475 tiles), and a
   32-bit shift would make them negative.
4. ``tile_starts`` from one ``searchsorted`` over the sorted keys.

The sort's permutation (``TileBinning.perm``: the slot of each sorted pair)
and the slot runs (``TileBinning.bounds``) are kept for the backward, which
writes each pair's gradient back into its slot, where the runs are
splat-major.
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
SPLAT_BITS = 31  # splat id bits below the fused key in the int64 sort key

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


def prepare_table_plain(proj, width: int, height: int, config: RasterizeConfig):
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
    table = torch.where(torch.isfinite(table), table, 0.0).contiguous()
    return table.detach(), bounds, num_real


def _column(x, name: str, n: int, width: int | None, device):
    """``(data_ptr, *strides)`` of one projected column, checked."""
    want = (n,) if width is None else (n, width)
    dtype = torch.bool if name == "valid" else torch.float32
    if x.shape != want or x.dtype != dtype or x.device != device:
        raise ValueError(f"proj.{name} must be {want} {dtype} on {device}, got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")
    return x.data_ptr(), *x.stride()


def scan_bounds(bounds):
    """The run bounds from ``(0, slot counts...)``: one inclusive
    ``torch.cumsum``, in place.  A library scan outside any kernel, as the
    TPU package leaves its ``jnp.cumsum`` to XLA."""
    return bounds.cumsum_(0)


def prepare_table(proj, width: int, height: int, config: RasterizeConfig):
    """Per-splat inputs of K2: ``(table (14, N) f32, bounds (N+1,) i32,
    num_real () i32)``; splat ``i`` owns slots ``[bounds[i], bounds[i+1])``.

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
    bounds.  Bound on the H100 by bytes (45 read and 60 written per splat).
    CPU tensors take :func:`prepare_table_plain`; CUDA tensors launch the
    kernel.
    """
    dev = proj.depth.device
    if dev.type == "cpu":
        return prepare_table_plain(proj, width, height, config)
    if dev.type != "cuda":
        raise ValueError(f"prepare_table runs on CPU or CUDA tensors, got {dev}")
    n = proj.depth.shape[0]
    if proj.depth.dim() != 1 or n >= 2**31:
        raise ValueError(f"proj.depth must be (N,) with N < 2^31, got {tuple(proj.depth.shape)}")
    cols = [
        *_column(proj.center, "center", n, 2, dev), *_column(proj.axis1, "axis1", n, 2, dev),
        *_column(proj.axis2, "axis2", n, 2, dev), *_column(proj.color, "color", n, 3, dev),
        *_column(proj.opacity, "opacity", n, None, dev), *_column(proj.depth, "depth", n, None, dev),
        *_column(proj.valid, "valid", n, None, dev),
    ]
    tiles_x, tiles_y = tile_grid(width, height, config)
    table = torch.empty((TABLE_ROWS, n), dtype=torch.float32, device=dev)
    bounds = torch.empty(n + 1, dtype=torch.int32, device=dev)
    num_real = torch.zeros((), dtype=torch.int32, device=dev)
    lib = cuda_build.library("pair_table")
    status = lib.pair_table_launch(
        *cols, n, tiles_x, tiles_y, config.tile_w, config.tile_h, depth_key_bits(tiles_x * tiles_y, config),
        config.alpha_discard, expand_flags(config), table.data_ptr(), bounds.data_ptr(), num_real.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, "pair_table", status, "prepare_table")
    prepare_table.launches += 1
    return table, scan_bounds(bounds), num_real


prepare_table.launches = 0


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


def expand_pairs_plain(table, bounds, k: int, width: int, height: int, config: RasterizeConfig):
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
    if flags & PACK_AX32:
        tcv = torch.floor(col[2] * (1.0 / 1024.0))
        n1cv = col[2] - tcv * 1024.0
        theta = tcv * (AX32_TWO_PI / 4096.0) - PI
        ct, st = torch.cos(theta), torch.sin(theta)
        n1v = torch.exp2(AX32_LO + n1cv * AX32_STEP)
        n2v = torch.exp2(AX32_LO + col[3] * AX32_STEP)
        a1x, a1y, a2x, a2y = n1v * ct, n1v * st, n2v * st, -n2v * ct
    else:
        a1x, a1y, a2x, a2y = col[2], col[3], col[4], col[5]

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

    if flags & PACK_AX32:
        axes = [a1x, a1y, a2x, a2y]
    elif flags & PACK_AXES_F16:
        axes = [_f16_round_trip(a) for a in (a1x, a1y, a2x, a2y)]
    else:
        axes = [a1x, a1y, a2x, a2y]
    if flags & PACK_RGBA8:
        colors = [_unorm8_round_trip(c, 127.5) for c in col[6:9]] + [_unorm8_round_trip(op, 255.0)]
    elif flags & PACK_COLOR_F16:
        colors = [_f16_round_trip(c) for c in (col[6], col[7], col[8], op)]
    else:
        colors = [col[6], col[7], col[8], op]
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


def expand_pairs(table, bounds, k: int, width: int, height: int, config: RasterizeConfig):
    """K2: expand per-splat rows into ``k`` (splat, tile) slots.

    Returns ``(comp (k,) int64, fields (10, k) float32)`` in slot order; see
    ``csrc/pair_expand.cu`` for the layout.  Replaces the Pallas kernel
    ``_expand_kernel`` (unitygaussiansplatting_tpu/ops/pair_expand.py:90).
    Bound on the H100 by bytes (60 B per splat read, 48 B per slot
    written).  A block of 256 threads walks 8 windows of 512 slots, two a
    thread with coalesced 16- and 8-byte stores; the window's splats are
    staged and derived once each in shared memory, and each slot does only
    its tile's work.  CPU tensors take :func:`expand_pairs_plain`; CUDA
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
        return expand_pairs_plain(table, bounds, k, width, height, config)
    if table.device.type != "cuda":
        raise ValueError(f"expand_pairs runs on CPU or CUDA tensors, got {table.device}")
    if not (table.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("table and bounds must be contiguous")
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    comp = torch.empty(k, dtype=torch.int64, device=table.device)
    fields = torch.empty((NUM_FIELDS, k), dtype=torch.float32, device=table.device)
    lib = cuda_build.library("pair_expand")
    status = lib.expand_pairs_launch(
        table.data_ptr(), bounds.data_ptr(), n, k, tiles_x, num_tiles,
        config.tile_w, config.tile_h, depth_key_bits(num_tiles, config), config.alpha_discard,
        expand_flags(config), comp.data_ptr(), fields.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    cuda_build.check(lib, "pair_expand", status, "expand_pairs")
    expand_pairs.launches += 1
    return comp, fields


expand_pairs.launches = 0


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
    lib = cuda_build.library("expand_probe")
    status = lib.expand_probe_launch(
        k, int(keys_only), comp.data_ptr(), None if keys_only else fields.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(lib, "expand_probe", status, "expand_probe")
    expand_probe.launches += 1
    return comp, fields


expand_probe.launches = 0


def sort_pairs(comp, fields, num_tiles: int, db: int):
    """Sort slots by the int64 key and gather their fields.

    Returns ``(sorted comp, sorted fields (10, K), tile_starts (T+1,) i32,
    perm (K,) i64)``; ``perm[j]`` is the slot of sorted pair ``j``.
    Ties in the key are never-used tail slots or repeated culls of one
    splat, whose fields are equal, so the result does not depend on the
    sort's tie order.
    """
    comp_s, perm = torch.sort(comp, stable=True)
    fields_s = fields.index_select(1, perm)
    tile_keys = (torch.arange(num_tiles + 1, device=comp.device, dtype=torch.int64) << db) << SPLAT_BITS
    tile_starts = torch.searchsorted(comp_s, tile_keys).to(torch.int32)
    return comp_s, fields_s, tile_starts, perm


def bin_and_prepare(proj, width: int, height: int, config: RasterizeConfig = RasterizeConfig()):
    """Fused binning + pair-field preparation.

    Returns ``(TileBinning, fields (10, K) float32 in sorted pair order,
    num_real () int32)``; ``binning.num_pairs`` is the slot demand including
    one sentinel slot per dead splat, ``binning.pair_rank`` the splat id per
    sorted pair (N for unused slots).
    """
    n = proj.depth.shape[0]
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    db = depth_key_bits(num_tiles, config)
    k = pair_budget(n, config)
    table, bounds, num_real = prepare_table(proj, width, height, config)
    comp, fields = expand_pairs(table, bounds, k, width, height, config)
    with record_function("splat_sort"):
        comp_s, fields_s, tile_starts, perm = sort_pairs(comp, fields, num_tiles, db)
    binning = TileBinning(
        pair_rank=(comp_s & ((1 << SPLAT_BITS) - 1)).to(torch.int32),
        pair_tile=(comp_s >> (SPLAT_BITS + db)).to(torch.int32),
        tile_starts=tile_starts,
        num_pairs=bounds[-1],
        perm=perm,
        bounds=bounds,
    )
    return binning, fields_s, num_real
