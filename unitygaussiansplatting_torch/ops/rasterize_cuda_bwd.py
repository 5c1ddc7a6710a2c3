"""Backward composite (K3) and run reduce (K4): per-splat gradients of a frame.

The port of ``unitygaussiansplatting_tpu/ops/rasterize_pallas_bwd.py``:

- :func:`composite_bwd` (K3) replaces ``_bwd_kernel``/``composite_pallas_bwd``.
  One thread block per (tile, segment) replays the forward walk from K1's
  :class:`Checkpoints` and writes each pair's ten field gradients into the
  pair's slot (``TileBinning.perm``).  The TPU kernel carries its state from
  one grid step to the next; here K1 saves it at the start of every
  ``SEGMENT_STEPS``-th step of each tile's walk, so the steps of one tile run
  on many SMs at once.
- The TPU package's ``steps_to_pair_gradients`` has no counterpart: on the
  TPU two grid steps share a pair block where a tile boundary falls inside
  it, and the fold adds them.  Here a pair belongs to exactly one tile and
  one segment, and no two steps share anything, so there is nothing to
  fold.  Its grouping sort by splat (``pair_gradients_to_splats``) is gone
  too: writing to slots, which K2 made splat-major, groups the pairs.
- :func:`run_reduce` (K4) replaces ``_run_reduce_kernel``/``_run_reduce``:
  segmented sums over each splat's run of slots, on the f32 and on the bf16
  path.  The TPU package's f32 path takes the same sums as differences of one
  cumulative sum (``pair_gradients_to_splats``), the same function with
  rounding that grows with K; K4 adds each run on its own.

The math (standard 3DGS compositing gradients) is in ``csrc/composite_bwd.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.config import RasterizeConfig
from . import cuda_build
from .binning import tile_grid
from .pair_expand import NUM_FIELDS


# Steps per segment of a tile's walk: K1 saves each pixel's state at the start
# of every SEGMENT_STEPS-th step, and K3 runs one block per segment.  16 steps
# of the headline's 256 pairs make the longest block 4,096 pairs.
SEGMENT_STEPS = 16


class Checkpoints(NamedTuple):
    """K1's state at the start of each segment of each tile's walk.

    ``state`` (segments, 4, P) float32: per pixel the transmittance as a
    product of the steps' prod(1 - alpha) (K3's own rule) and the three color
    sums, at the segment's first step; only segments the walk reached are
    written.  ``seg_starts`` (T+1,) int32: tile t's segments are
    ``[seg_starts[t], seg_starts[t+1])``.  ``pairs_done`` (T,) int32: the
    pairs K1 composited per tile (K1's own ``pairs_done``), which tells K3
    which segments have a checkpoint.  ``segment_steps``: steps per segment;
    one segment longer than any tile's walk makes K3 walk each tile whole.
    """

    state: torch.Tensor
    seg_starts: torch.Tensor
    pairs_done: torch.Tensor
    segment_steps: int


def segment_starts(tile_starts, chunk: int, segment_steps: int):
    """(T+1,) int32 first segment of each tile, on tile_starts' device: tile t
    walks the steps ``tile_starts[t] // chunk .. (tile_starts[t+1] - 1) //
    chunk``, cut into segments of ``segment_steps``."""
    s, e = tile_starts[:-1].to(torch.int64), tile_starts[1:].to(torch.int64)
    first, last = torch.div(s, chunk, rounding_mode="floor"), torch.div(e - 1, chunk, rounding_mode="floor")
    steps = torch.where(e > s, last - first + 1, 0)
    segs = torch.div(steps + segment_steps - 1, segment_steps, rounding_mode="floor")
    return torch.cat([segs.new_zeros(1), torch.cumsum(segs, 0)]).to(torch.int32)


def segment_capacity(k: int, num_tiles: int, chunk: int, segment_steps: int) -> int:
    """Segments of any frame of ``k`` sorted pairs over ``num_tiles`` tiles:
    neighbouring tiles share at most one step, so all tiles walk at most
    ceil(k / chunk) + T steps, and each tile rounds up once."""
    steps = -(-k // chunk) + num_tiles
    return -(-steps // segment_steps) + num_tiles


def segment_pairs(tile_starts, checkpoints: Checkpoints, chunk: int):
    """Per segment slot of ``checkpoints.state``: ``(tile (S,) int64, pairs
    (S,) int64)``, the segment's tile and the pairs of it before K1's exit
    (-1 for slots past the frame's segments)."""
    state, seg_starts, fwd_done, steps = checkpoints
    num_tiles = tile_starts.shape[0] - 1
    ids = torch.arange(state.shape[0], device=state.device, dtype=torch.int32)
    tile = torch.clamp(torch.searchsorted(seg_starts, ids, right=True) - 1, max=num_tiles - 1)
    s, e = tile_starts[tile].to(torch.int64), tile_starts[tile + 1].to(torch.int64)
    seg_first = torch.div(s, chunk, rounding_mode="floor") + (ids - seg_starts[tile]).to(torch.int64) * steps
    lo = torch.maximum(seg_first * chunk, s)
    hi = torch.minimum(torch.minimum((seg_first + steps) * chunk, e), s + fwd_done[tile])
    pairs = torch.where(ids < seg_starts[-1], torch.clamp(hi - lo, min=0), -1)
    return tile, pairs


def _pair_gradients(sums, a1x, a1y, a2x, a2y):
    """The ten per-pair field gradients from the ten per-pair pixel sums
    (sum gx, gy, gx dx, gx dy, gy dx, gy dy, w D_r, w D_g, w D_b, dexp)."""
    sgx, sgy, sgx_dx, sgx_dy, sgy_dx, sgy_dy = sums[:6]
    inv1 = 1.0 / torch.clamp(a1x * a1x + a1y * a1y, min=1e-12)
    inv2 = 1.0 / torch.clamp(a2x * a2x + a2y * a2y, min=1e-12)
    sgx_qx = (a1x * sgx_dx + a1y * sgx_dy) * inv1  # sum gx * qx
    sgy_qy = (a2x * sgy_dx + a2y * sgy_dy) * inv2
    return torch.stack([
        -(a1x * inv1) * sgx - (a2x * inv2) * sgy,
        -(a1y * inv1) * sgx - (a2y * inv2) * sgy,
        (sgx_dx - 2.0 * sgx_qx * a1x) * inv1,
        (sgx_dy - 2.0 * sgx_qx * a1y) * inv1,
        (sgy_dx - 2.0 * sgy_qy * a2x) * inv2,
        (sgy_dy - 2.0 * sgy_qy * a2y) * inv2,
        *sums[6:],
    ])


def to_bf16(grads):
    """Round to bf16, nearest even, with -0 as +0 (the kernel's output)."""
    return torch.where(grads == 0.0, 0.0, grads).to(torch.bfloat16)


# K3 against its plain version: the same (pair, pixel) terms summed in
# another order (per thread, warp shuffles, warps vs cumprod/cumsum and
# tensor sums), relative to each field's max.  bf16: each rounds its own f32
# sum, so at most the neighbouring bf16 value, except where a sum near zero
# (large terms cancelling) already meets the f32 bar: there the rounding of
# its terms is many bf16 steps of the small result.
K3_REL_TO_MAX = 2e-5
K3_BF16_ULPS = 1


def bf16_order(g):
    """bfloat16 tensor -> int64 integers ordered like its values."""
    bits = g.view(torch.int16).to(torch.int64) & 0xFFFF
    return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)


def k3_distance(got, want):
    """How far K3's gradients ``got`` lie from ``want`` (its plain version's,
    same dtype), as ``(distance, limit)``: float32, the largest difference
    relative to its field's max, limit ``K3_REL_TO_MAX``; bfloat16, the most
    bf16 steps apart among entries outside that bar, limit ``K3_BF16_ULPS``."""
    scale = want.float().abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    rel = (got.float() - want.float()).abs() / scale
    if got.dtype == torch.bfloat16:
        steps = (bf16_order(got) - bf16_order(want)).abs()
        return float(torch.where(rel <= K3_REL_TO_MAX, 0, steps).max()), K3_BF16_ULPS
    return float(rel.max()), K3_REL_TO_MAX


def composite_bwd_plain(fields, tile_starts, raw, dout, perm, width: int, height: int,
                        config: RasterizeConfig, checkpoints: Checkpoints):
    """Plain PyTorch version of K3: the same steps, per tile, in a Python loop.

    Per step the (pairs, pixels) alphas, the exclusive prefix product of
    ``1 - alpha`` (``torch.cumprod``), the prefix of u (``torch.cumsum``) and
    the per-pair pixel sums are whole-tensor operations; the exit tests the
    carried transmittance before each step.  Each segment starts from its
    checkpoint (K1's), as the kernel's blocks do: T from the saved product,
    the prefix of u as D . (saved color sums); the walk stops at a segment K1
    never reached.
    """
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    th, tw, c = config.tile_h, config.tile_w, config.chunk_size
    npix = th * tw
    dev = fields.device
    k = fields.shape[1]
    out = torch.zeros((NUM_FIELDS, k), dtype=torch.float32, device=dev)
    pairs_done = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    a1x, a1y, a2x, a2y = fields[2], fields[3], fields[4], fields[5]
    a1_sq = torch.clamp(a1x * a1x + a1y * a1y, min=1e-12)
    a2_sq = torch.clamp(a2x * a2x + a2y * a2y, min=1e-12)
    ux, uy, vx, vy = a1x / a1_sq, a1y / a1_sq, a2x / a2_sq, a2y / a2_sq
    lane = torch.arange(npix, device=dev)
    lane_x = (lane % tw).to(torch.float32)
    lane_y = torch.div(lane, tw, rounding_mode="floor").to(torch.float32)
    starts = tile_starts.tolist()
    seg_first, fwd_done = checkpoints.seg_starts.tolist(), checkpoints.pairs_done.tolist()
    seg_steps = checkpoints.segment_steps
    for t in range(num_tiles):
        s, e = starts[t], starts[t + 1]
        if e <= s:
            continue
        px = (t % tiles_x) * float(tw) + lane_x + 0.5
        py = (t // tiles_x) * float(th) + lane_y + 0.5
        d_r, d_g, d_b, d_a = dout[t]
        d_ctot = d_r * raw[t, 0] + d_g * raw[t, 1] + d_b * raw[t, 2]
        d_at = d_a * (1.0 - raw[t, 3])
        done = 0
        for step, blk in enumerate(range(s // c, (e - 1) // c + 1)):
            lo, hi = max(s, blk * c), min(e, (blk + 1) * c)
            if step % seg_steps == 0:
                if lo - s >= fwd_done[t]:
                    break  # K1 stopped before this segment
                state = checkpoints.state[seg_first[t] + step // seg_steps]
                trans = state[0]
                pref = d_r * state[1] + d_g * state[2] + d_b * state[3]
            if not bool(torch.max(trans) >= config.transmittance_eps):
                break
            w = slice(lo, hi)
            dx = px[None, :] - fields[0, w, None]
            dy = py[None, :] - fields[1, w, None]
            qx = dx * ux[w, None] + dy * uy[w, None]
            qy = dx * vx[w, None] + dy * vy[w, None]
            expp = torch.exp(-(qx * qx + qy * qy))
            alpha_raw = expp * fields[9, w, None]
            alpha = torch.clamp(alpha_raw, max=config.alpha_max)
            keep = alpha >= config.alpha_discard
            if config.quad_clip:
                keep &= (torch.abs(qx) <= 2.0) & (torch.abs(qy) <= 2.0)
            alpha = torch.where(keep, alpha, 0.0)
            one_minus = 1.0 - alpha
            cum = torch.cumprod(one_minus, dim=0)
            t_i = trans[None, :] * torch.cat([torch.ones_like(cum[:1]), cum[:-1]])
            wgt = t_i * alpha
            e_dc = fields[6, w, None] * d_r + fields[7, w, None] * d_g + fields[8, w, None] * d_b
            pref_u = pref[None, :] + torch.cumsum(wgt * e_dc, dim=0)
            inv_om = 1.0 / torch.clamp(one_minus, min=1e-6)
            dalpha = t_i * e_dc - (d_ctot[None, :] - pref_u) * inv_om + d_at[None, :] * inv_om
            dalpha = torch.where(keep & ~(alpha_raw > config.alpha_max), dalpha, 0.0)
            gx = dalpha * (-2.0 * qx) * alpha
            gy = dalpha * (-2.0 * qy) * alpha
            sums = [
                gx.sum(1), gy.sum(1), (gx * dx).sum(1), (gx * dy).sum(1), (gy * dx).sum(1),
                (gy * dy).sum(1), (wgt * d_r).sum(1), (wgt * d_g).sum(1), (wgt * d_b).sum(1),
                (dalpha * expp).sum(1),
            ]
            out[:, perm[w]] = _pair_gradients(sums, a1x[w], a1y[w], a2x[w], a2y[w])
            pref = pref_u[-1]
            trans = trans * cum[-1]
            done += hi - lo
        pairs_done[t] = done
    if config.pack_grads_bf16:
        out = to_bf16(out)
    return out, pairs_done


def composite_bwd(fields, tile_starts, raw, dout, perm, width: int, height: int,
                  config: RasterizeConfig, checkpoints: Checkpoints):
    """K3: per-pair gradients of the ten composite fields, in slot order.

    ``fields`` (10, K) float32 and ``tile_starts`` (T+1,) int32 as K1 took
    them; ``raw`` (T+1, 4, P) K1's output; ``dout`` (T+1, 4, P) the upstream
    gradient in the same tile layout (:func:`rasterize_cuda.tile_layout`);
    ``perm`` (K,) int64 the slot of each sorted pair; ``checkpoints`` K1's
    (``composite_tiles(..., checkpoints=True)``).
    Returns ``(grads (10, K), pairs_done (T,) int32)``: float32, or bfloat16
    with ``config.pack_grads_bf16``; slots of pairs the walk never reached
    (after a tile's exit, culled, unused) hold 0.  ``pairs_done`` counts the
    pairs each tile walked before K3's own exit.  Replaces the Pallas kernel
    ``_bwd_kernel`` (unitygaussiansplatting_tpu/ops/rasterize_pallas_bwd.py:76).
    Bound on the H100 by instruction issue (the function is 24 instructions
    per evaluated pair and pixel, 48 more where the pixel keeps the pair);
    one block per (tile, segment),
    heaviest segment first; see ``csrc/composite_bwd.cu``.  CPU tensors take
    :func:`composite_bwd_plain`; CUDA tensors launch the kernel.
    """
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    npix = config.tile_w * config.tile_h
    if fields.dim() != 2 or fields.shape[0] != NUM_FIELDS or fields.dtype != torch.float32:
        raise ValueError(f"fields must be ({NUM_FIELDS}, K) float32, got {tuple(fields.shape)} {fields.dtype}")
    k = fields.shape[1]
    if tile_starts.shape != (num_tiles + 1,) or tile_starts.dtype != torch.int32:
        raise ValueError(f"tile_starts must be ({num_tiles + 1},) int32, got {tuple(tile_starts.shape)} {tile_starts.dtype}")
    for name, x in (("raw", raw), ("dout", dout)):
        if x.shape != (num_tiles + 1, 4, npix) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be ({num_tiles + 1}, 4, {npix}) float32, got {tuple(x.shape)} {x.dtype}")
    if perm.shape != (k,) or perm.dtype != torch.int64:
        raise ValueError(f"perm must be ({k},) int64, got {tuple(perm.shape)} {perm.dtype}")
    state, seg_starts, fwd_done, steps = checkpoints
    if state.dim() != 3 or state.shape[1:] != (4, npix) or state.dtype != torch.float32:
        raise ValueError(f"checkpoint state must be (S, 4, {npix}) float32, got {tuple(state.shape)} {state.dtype}")
    if seg_starts.shape != (num_tiles + 1,) or seg_starts.dtype != torch.int32:
        raise ValueError(f"seg_starts must be ({num_tiles + 1},) int32, got {tuple(seg_starts.shape)}")
    if fwd_done.shape != (num_tiles,) or fwd_done.dtype != torch.int32:
        raise ValueError(f"checkpoint pairs_done must be ({num_tiles},) int32, got {tuple(fwd_done.shape)}")
    if steps < 1:
        raise ValueError(f"segment_steps must be >= 1, got {steps}")
    tensors = [fields, tile_starts, raw, dout, perm, state, seg_starts, fwd_done]
    if any(x.device != fields.device for x in tensors):
        raise ValueError("fields, tile_starts, raw, dout, perm and the checkpoints must be on one device")
    if fields.device.type == "cpu":
        return composite_bwd_plain(fields, tile_starts, raw, dout, perm, width, height, config, checkpoints)
    if fields.device.type != "cuda":
        raise ValueError(f"composite_bwd runs on CPU or CUDA tensors, got {fields.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("fields, tile_starts, raw, dout, perm and the checkpoints must be contiguous")
    lib = cuda_build.library("composite_bwd")
    if lib.composite_bwd_pixels_per_thread(npix) == 0:
        raise ValueError(f"tile of {npix} pixels: the kernel needs a multiple of 32 up to 8192")
    seg_tile, seg_walk = segment_pairs(tile_starts, checkpoints, config.chunk_size)
    seg_order = torch.argsort(seg_walk, descending=True, stable=True).to(torch.int32)
    seg_tile = seg_tile.to(torch.int32)
    bf16 = bool(config.pack_grads_bf16)
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    grads = torch.zeros((NUM_FIELDS, k), dtype=out_dtype, device=fields.device)
    pairs_done = torch.zeros(num_tiles, dtype=torch.int32, device=fields.device)
    cuda_build.launch(
        "composite_bwd", "composite_bwd_launch", fields.device,
        fields.data_ptr(), k, tile_starts.data_ptr(), num_tiles, tiles_x,
        config.tile_w, config.tile_h, config.chunk_size, config.transmittance_eps,
        config.alpha_discard, config.alpha_max, int(config.quad_clip),
        raw.data_ptr(), dout.data_ptr(), perm.data_ptr(), int(bf16),
        grads.data_ptr(), pairs_done.data_ptr(), seg_order.data_ptr(), seg_tile.data_ptr(),
        seg_starts.data_ptr(), state.shape[0], steps, state.data_ptr(), fwd_done.data_ptr(),
    )
    return grads, pairs_done


def run_reduce_plain(grads, bounds):
    """Plain PyTorch version of K4: each run summed in slot order.

    Step ``j`` adds the ``j``-th slot of every run longer than ``j``, so every
    sum is taken in the kernel's order and the result has the kernel's bits.
    """
    k = grads.shape[1]
    n = bounds.shape[0] - 1
    g = grads.to(torch.float32)
    b = torch.clamp(bounds.to(torch.int64), max=k)
    starts, lens = b[:-1], b[1:] - b[:-1]
    out = torch.zeros((NUM_FIELDS, n), dtype=torch.float32, device=grads.device)
    if n == 0:
        return out
    lens_sorted, order = torch.sort(lens, descending=True)
    longest = int(lens_sorted[0])
    # live[j]: how many runs are longer than j (a prefix of `order`).
    live = torch.searchsorted(-lens_sorted, -torch.arange(longest, device=grads.device), right=False)
    for j, count in enumerate(live.tolist()):
        ids = order[:count]
        out[:, ids] += g[:, starts[ids] + j]
    return out


def run_reduce(grads, bounds):
    """K4: per-splat sums ``(10, N)`` float32 of slot-ordered pair gradients.

    ``grads`` (10, K) float32 or bfloat16 (K3's output); ``bounds`` (N+1,)
    int32, splat ``i`` owning slots ``[bounds[i], bounds[i+1])``, clipped to
    K.  Replaces the Pallas kernel ``_run_reduce_kernel``
    (unitygaussiansplatting_tpu/ops/rasterize_pallas_bwd.py:413).  Bound on
    the H100 by bytes; one thread per splat.  CPU tensors take
    :func:`run_reduce_plain`; CUDA tensors launch the kernel.
    """
    if grads.dim() != 2 or grads.shape[0] != NUM_FIELDS or grads.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grads must be ({NUM_FIELDS}, K) float32 or bfloat16, got {tuple(grads.shape)} {grads.dtype}")
    if bounds.dim() != 1 or bounds.shape[0] < 1 or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be (N+1,) int32, got {tuple(bounds.shape)} {bounds.dtype}")
    if bounds.device != grads.device:
        raise ValueError("grads and bounds must be on one device")
    if grads.device.type == "cpu":
        return run_reduce_plain(grads, bounds)
    if grads.device.type != "cuda":
        raise ValueError(f"run_reduce runs on CPU or CUDA tensors, got {grads.device}")
    if not (grads.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("grads and bounds must be contiguous")
    n = bounds.shape[0] - 1
    out = torch.empty((NUM_FIELDS, n), dtype=torch.float32, device=grads.device)
    if n == 0:
        return out
    cuda_build.launch(
        "run_reduce", "run_reduce_launch", grads.device,
        grads.data_ptr(), grads.shape[1], int(grads.dtype == torch.bfloat16), bounds.data_ptr(), n, out.data_ptr(),
    )
    return out
