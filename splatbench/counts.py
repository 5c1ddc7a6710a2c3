"""The yardstick of the roofline and mfu metrics: the least time of each
stage of a frame and of a train step on one H100 SXM.

A stage's least time is the larger of its bytes at 3.35 TB/s and its
instructions at 33.5e12 a second, the H100 SXM's published peaks (NVIDIA
data sheet, at 700 W: HBM3 3.35 TB/s; 67 TFLOP/s float32, which counts a
fused multiply-add as two operations; the port's kernels are built with
``--fmad=false``, so each counted operation is one issued instruction).
Each stage's input is read once and its output written once, at the
frame's pair demand, not at the program's pair budget.  The data-dependent
counts (the demand, the evaluations up to each pixel's own saturation, the
evaluations a pixel keeps) come from ``reference.render.Work``, never from
the program's outputs, so the count reads the same work whatever
implements it.

Frozen copies, taken when this benchmark was written (they equal the
program's today, which ``tests/test_splatbench_counts.py`` checks): the
bytes model of ``unitygaussiansplatting_torch/utils/profiling.py``
(``binning_bytes``, ``phase_roofline``; the sort's eight radix passes over
64-bit keys and their int64 indices are assumed, not traced) and the
instructions the composite functions need per evaluation, counted by hand
from the functions in ``chip_smoke.py``.  The program may change its own
copies later; these stay, because they are the yardstick.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 33.5e12

NUM_FIELDS = 10  # a pair's fields: cx, cy, a1x, a1y, a2x, a2y, r, g, b, opacity
TABLE_ROWS = 14  # the per-splat table: the 10 fields, then x0, y0, nx, depth key
SORT_KEY_BITS, SORT_BITS_PER_PASS = 64, 8

# K1, per evaluated (pair, pixel): d 2, q 6, |q|^2 3, expf 8, x opacity 1,
# the clip 2, the discard test 1, the quad tests 2 = 25; per kept: the
# weight 2, three color sums 6, the product of (1 - alpha) 2 = 10.
K1_INSTR_PER_EVAL = 25
K1_INSTR_PER_KEPT = 10
# K3, per evaluation: d 2, q 6, |q|^2 3, expf 8, x opacity 1, the min 1,
# the discard test 1, the quad tests 2 = 24; per kept: t_i and w 2, D.c 5,
# the prefix 2, the suffix 2, 1 - alpha 1, its clamp 1 and reciprocal 4,
# the product 1, three color sums 6, the clip test 1, dL/dalpha 5, gx and
# gy 6, six geometric sums 10, the opacity sum 2 = 48.
K3_INSTR_PER_EVAL = 24
K3_INSTR_PER_KEPT = 48

SH_FLOATS = {0: 0, 1: 9, 2: 24, 3: 45}
SPLAT_FLOATS = 3 + 4 + 3 + 1 + 3  # means, rotations, scales, opacity, base color (without SH)
PROJ_BYTES = (1 + 2 + 2 + 2 + 3 + 3 + 1) * 4 + 1  # projected splat: 14 float32 and the valid byte
PAIR_GRAD_FLOATS = 10  # a pair's gradient: center 2, axes 4, color 3, opacity 1


def least_s(nbytes: float, instructions: float = 0.0) -> float:
    """The least seconds of a stage on the card."""
    return max(nbytes / HBM_BYTES_PER_S, instructions / INSTR_PER_S)


def binning_bytes(n: int, k: int) -> dict:
    """The per-splat pass and K2 at ``n`` splats and ``k`` pairs: the pass
    reads the projected view fields (center, axes, color, opacity, depth,
    the valid byte) and writes the table, the ``n + 1`` run bounds and the
    real-pair count; K2 reads the table and the bounds and writes an int64
    key and ``NUM_FIELDS`` float32 fields a pair."""
    view_in = (2 + 2 + 2 + 3 + 1 + 1) * 4 + 1
    table_and_bounds = n * TABLE_ROWS * 4 + (n + 1) * 4
    return {"per_splat_pass": n * view_in + table_and_bounds + 4, "k2": table_and_bounds + k * (8 + NUM_FIELDS * 4)}


def splat_bytes(n: int, sh_order: int) -> int:
    """An activated cloud of ``n`` splats, float32."""
    return n * (SPLAT_FLOATS + SH_FLOATS[sh_order]) * 4


def tile_bytes(width: int, height: int, tile_w: int, tile_h: int) -> int:
    """The composite's tile buffer: every tile and the sentinel tile, RGBA float32."""
    tiles = math.ceil(width / tile_w) * math.ceil(height / tile_h)
    return (tiles + 1) * 4 * tile_w * tile_h * 4


def frame_least(n: int, work, width: int, height: int, tile_w: int, tile_h: int, sh_order: int,
                asset_bytes: int | None = None) -> dict:
    """Least seconds of each stage of a forward frame.

    ``work`` is the frame's ``reference.render.Work``; ``asset_bytes`` the
    quantized asset's bytes when the frame decodes one."""
    k = work.demand
    binning = binning_bytes(n, k)
    tiles = tile_bytes(width, height, tile_w, tile_h)
    passes = math.ceil(SORT_KEY_BITS / SORT_BITS_PER_PASS)
    fields = k * NUM_FIELDS * 4
    out = {}
    if asset_bytes is not None:
        out["decode"] = least_s(asset_bytes + splat_bytes(n, sh_order))
    out["project"] = least_s(splat_bytes(n, sh_order) + n * PROJ_BYTES)
    out["bin"] = least_s(binning["per_splat_pass"] + binning["k2"] + 2 * n * 4 + passes * 2 * k * (8 + 8)
                         + k * 8 + 2 * fields)
    out["k1"] = least_s(fields + tiles, work.evals * K1_INSTR_PER_EVAL + work.kept * K1_INSTR_PER_KEPT)
    out["untile"] = least_s(tiles + height * width * 4 * 4)
    return out


def step_least(n: int, work, width: int, height: int, tile_w: int, tile_h: int, sh_order: int) -> dict:
    """Least seconds of each stage of a train step: the forward frame, then
    the loss (the image and the target read, the image's gradient written),
    the projection's backward (its bytes: the projected gradients and the
    cloud read, the raw gradients written), K3, K4 and Adam (parameters,
    gradients and both moments read; parameters and moments written)."""
    out = frame_least(n, work, width, height, tile_w, tile_h, sh_order)
    k = work.demand
    tiles = tile_bytes(width, height, tile_w, tile_h)
    cloud = splat_bytes(n, sh_order)
    pair_grads = k * PAIR_GRAD_FLOATS * 4
    out["loss"] = least_s(height * width * (4 + 3 + 4) * 4)
    out["project_bwd"] = least_s(n * PAIR_GRAD_FLOATS * 4 + 2 * cloud)
    out["k3"] = least_s(k * NUM_FIELDS * 4 + 2 * tiles + pair_grads,
                        work.evals * K3_INSTR_PER_EVAL + work.kept * K3_INSTR_PER_KEPT)
    out["k4"] = least_s(pair_grads + (n + 1) * 4 + n * PAIR_GRAD_FLOATS * 4)
    out["adam"] = least_s(7 * cloud)
    return out
