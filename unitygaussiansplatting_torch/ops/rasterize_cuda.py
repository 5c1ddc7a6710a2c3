"""Tile composite (K1) and the forward rasterizer around it.

``composite_tiles`` is the port of the Pallas kernel ``_kernel``
(unitygaussiansplatting_tpu/ops/rasterize_pallas.py:134) with its schedule
(``build_schedule``) folded into the kernel: a thread-block cluster per tile,
its CTAs splitting the tile's pixels, walks the tile's sorted pair range in
steps cut at global multiples of ``chunk_size`` and takes the per-step exit
together.  On request it saves the state K3 starts its segments from.
:class:`Rasterize` runs binning (K2 + sort) and K1 and untiles the result;
its backward runs the backward composite (K3) and the run reduce (K4) of
``rasterize_cuda_bwd``.
"""

from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from ..utils.config import RasterizeConfig
from . import cuda_build
from .binning import tile_grid
from .pair_expand import NUM_FIELDS, bin_and_prepare
from .projection import ProjectedSplats
from .rasterize_cuda_bwd import (
    SEGMENT_STEPS, Checkpoints, composite_bwd, run_reduce, segment_capacity, segment_starts,
)


def composite_tiles_plain(fields, tile_starts, width: int, height: int, config: RasterizeConfig,
                          checkpoints: bool = False, segment_steps: int = SEGMENT_STEPS):
    """Plain PyTorch version of K1: the same steps, per tile, in a Python loop.

    Per step the (pairs, pixels) alphas, the exclusive prefix product of
    ``1 - alpha`` along the pairs (``torch.cumprod``) and the weighted color
    sums are whole-tensor operations; the early exit reads the tile's max
    transmittance before each step.  Returns what :func:`composite_tiles`
    returns, the :class:`Checkpoints` at every ``segment_steps``-th step with
    ``checkpoints``.
    """
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    th, tw, c = config.tile_h, config.tile_w, config.chunk_size
    npix = th * tw
    dev = fields.device
    raw = torch.zeros((num_tiles + 1, 4, npix), dtype=torch.float32, device=dev)
    if checkpoints:
        seg_starts = segment_starts(tile_starts, c, segment_steps)
        seg_first = seg_starts.tolist()
        cap = segment_capacity(fields.shape[1], num_tiles, c, segment_steps)
        state = torch.zeros((cap, 4, npix), dtype=torch.float32, device=dev)
    pairs_done = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    a1x, a1y, a2x, a2y = fields[2], fields[3], fields[4], fields[5]
    a1_sq = torch.clamp(a1x * a1x + a1y * a1y, min=1e-12)
    a2_sq = torch.clamp(a2x * a2x + a2y * a2y, min=1e-12)
    ux, uy, vx, vy = a1x / a1_sq, a1y / a1_sq, a2x / a2_sq, a2y / a2_sq
    lane = torch.arange(npix, device=dev)
    lane_x = (lane % tw).to(torch.float32)
    lane_y = torch.div(lane, tw, rounding_mode="floor").to(torch.float32)
    starts = tile_starts.tolist()
    for t in range(num_tiles):
        s, e = starts[t], starts[t + 1]
        if e <= s:
            continue
        px = (t % tiles_x) * float(tw) + lane_x + 0.5
        py = (t // tiles_x) * float(th) + lane_y + 0.5
        cov = torch.zeros(npix, dtype=torch.float32, device=dev)
        tprod = torch.ones(npix, dtype=torch.float32, device=dev)
        rgb = torch.zeros((3, npix), dtype=torch.float32, device=dev)
        done = 0
        for step, blk in enumerate(range(s // c, (e - 1) // c + 1)):
            trans = 1.0 - cov
            if not bool(torch.max(trans) >= config.transmittance_eps):
                break
            if checkpoints and step % segment_steps == 0:
                state[seg_first[t] + step // segment_steps] = torch.cat([tprod[None], rgb])
            lo, hi = max(s, blk * c), min(e, (blk + 1) * c)
            w = slice(lo, hi)
            dx = px[None, :] - fields[0, w, None]
            dy = py[None, :] - fields[1, w, None]
            qx = dx * ux[w, None] + dy * uy[w, None]
            qy = dx * vx[w, None] + dy * vy[w, None]
            alpha = torch.exp(-(qx * qx + qy * qy)) * fields[9, w, None]
            alpha = torch.clamp(alpha, 0.0, config.alpha_max)
            keep = alpha >= config.alpha_discard
            if config.quad_clip:
                keep &= (torch.abs(qx) <= 2.0) & (torch.abs(qy) <= 2.0)
            alpha = torch.where(keep, alpha, 0.0)
            cum = torch.cumprod(1.0 - alpha, dim=0)
            excl = torch.cat([torch.ones_like(cum[:1]), cum[:-1]])
            wgt = excl * alpha * trans[None, :]
            rgb += torch.sum(wgt[None] * fields[6:9, w, None], dim=1)
            cov = 1.0 - trans * cum[-1]
            tprod = tprod * cum[-1]
            done += hi - lo
        raw[t, :3] = rgb
        raw[t, 3] = cov
        pairs_done[t] = done
    ckpt = Checkpoints(state, seg_starts, pairs_done, segment_steps) if checkpoints else None
    return raw, pairs_done, ckpt


@functools.cache
def _check_clusters(device: int, npix: int, chunk: int) -> None:
    """Raise unless card ``device`` can place at least one of K1's clusters;
    asked once per card, tile size and stage size."""
    lib = cuda_build.library("composite_fwd")
    with torch.cuda.device(device):
        found = lib.composite_fwd_max_active_clusters(npix, chunk)
    if found < 0:
        cuda_build.check(lib, "composite_fwd", -found, "composite_tiles (cluster occupancy)")
    if found == 0:
        raise RuntimeError(f"composite_tiles: the card cannot place a cluster of "
                           f"{lib.composite_fwd_cluster_size(npix)} CTAs for a tile of {npix} pixels")


def composite_tiles(fields, tile_starts, width: int, height: int, config: RasterizeConfig,
                    checkpoints: bool = False, segment_steps: int = SEGMENT_STEPS):
    """K1: composite every tile's depth-sorted pairs.

    ``fields`` (10, K) float32 in sorted pair order, ``tile_starts`` (T+1,)
    int32.  Returns ``(raw (T+1, 4, P) float32, pairs_done (T,) int32,
    checkpoints)``: premultiplied rgb + coverage per tile pixel (row T, the
    sentinel tile, is zero), the pairs each tile composited before its early
    exit, and with ``checkpoints`` the :class:`Checkpoints` that K3 starts its
    segments of ``segment_steps`` steps from (else None; their
    ``pairs_done`` is the same tensor).  Replaces the Pallas kernel
    ``_kernel`` (unitygaussiansplatting_tpu/ops/rasterize_pallas.py:134).
    Bound on the H100 by instruction issue (the function is 25 instructions
    per pair and pixel evaluated, an accurate expf among them, and 10 more
    where the pixel keeps the pair).  A cluster of up to 8 CTAs per tile
    splits its pixels, so the busiest tile runs on several SMs, and clusters
    start heaviest tile first; the per-pair divisions are hoisted into the
    shared-memory staging.  CPU tensors take :func:`composite_tiles_plain`;
    CUDA tensors launch the kernel.
    """
    if segment_steps < 1:
        raise ValueError(f"segment_steps must be >= 1, got {segment_steps}")
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    if fields.dim() != 2 or fields.shape[0] != NUM_FIELDS or fields.dtype != torch.float32:
        raise ValueError(f"fields must be ({NUM_FIELDS}, K) float32, got {tuple(fields.shape)} {fields.dtype}")
    if tile_starts.shape != (num_tiles + 1,) or tile_starts.dtype != torch.int32:
        raise ValueError(f"tile_starts must be ({num_tiles + 1},) int32, got {tuple(tile_starts.shape)} {tile_starts.dtype}")
    if tile_starts.device != fields.device:
        raise ValueError("fields and tile_starts must be on one device")
    if fields.device.type == "cpu":
        return composite_tiles_plain(fields, tile_starts, width, height, config, checkpoints, segment_steps)
    if fields.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on CPU or CUDA tensors, got {fields.device}")
    if not (fields.is_contiguous() and tile_starts.is_contiguous()):
        raise ValueError("fields and tile_starts must be contiguous")
    npix = config.tile_w * config.tile_h
    lib = cuda_build.library("composite_fwd")
    if lib.composite_fwd_pixels_per_thread(npix) == 0:
        raise ValueError(f"tile of {npix} pixels: the kernel needs a multiple of 32, at most 8192 a CTA")
    _check_clusters(fields.device.index, npix, config.chunk_size)
    dev = fields.device
    raw = torch.zeros((num_tiles + 1, 4, npix), dtype=torch.float32, device=dev)
    pairs_done = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    tile_order = torch.argsort(tile_starts[1:] - tile_starts[:-1], descending=True, stable=True).to(torch.int32)
    seg_starts = state = None
    if checkpoints:
        seg_starts = segment_starts(tile_starts, config.chunk_size, segment_steps)
        cap = segment_capacity(fields.shape[1], num_tiles, config.chunk_size, segment_steps)
        state = torch.empty((cap, 4, npix), dtype=torch.float32, device=dev)
    status = lib.composite_fwd_launch(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(), tile_order.data_ptr(), num_tiles,
        tiles_x, config.tile_w, config.tile_h, config.chunk_size, config.transmittance_eps,
        config.alpha_discard, config.alpha_max, int(config.quad_clip),
        raw.data_ptr(), pairs_done.data_ptr(), seg_starts.data_ptr() if checkpoints else None,
        segment_steps, state.data_ptr() if checkpoints else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, "composite_fwd", status, "composite_tiles")
    composite_tiles.launches += 1
    ckpt = Checkpoints(state, seg_starts, pairs_done, segment_steps) if checkpoints else None
    return raw, pairs_done, ckpt


composite_tiles.launches = 0


def untile(raw, width: int, height: int, config: RasterizeConfig):
    """(T+1, 4, P) tile-major buffer -> (H, W, 4) image."""
    th, tw = config.tile_h, config.tile_w
    tiles_x, tiles_y = tile_grid(width, height, config)
    img = raw[: tiles_x * tiles_y].reshape(tiles_y, tiles_x, 4, th, tw)
    img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * th, tiles_x * tw, 4)
    return img[:height, :width]


def tile_layout(img, width: int, height: int, config: RasterizeConfig):
    """Inverse of :func:`untile`: (H, W, 4) image -> (T+1, 4, P) tile-major
    buffer, zero for padding pixels and for the sentinel tile (row T)."""
    th, tw = config.tile_h, config.tile_w
    tiles_x, tiles_y = tile_grid(width, height, config)
    padded = torch.nn.functional.pad(img, (0, 0, 0, tiles_x * tw - width, 0, tiles_y * th - height))
    t = padded.reshape(tiles_y, th, tiles_x, tw, 4).permute(0, 2, 4, 1, 3)
    t = t.reshape(tiles_x * tiles_y, 4, th * tw)
    return torch.cat([t, t.new_zeros((1, 4, th * tw))])


class Rasterize(torch.autograd.Function):
    """Bin (K2 + sort) and composite (K1): ``(image (H, W, 4), slot demand
    () int32)``.

    The port of the TPU package's ``rasterize_tiles_pallas_diff`` custom VJP
    (``_diff_fwd``/``_diff_bwd``).  The backward lays the image gradient out
    in tiles, runs K3 (per-pair gradients written into the pairs' slots) and
    K4 (per-splat sums over the splat-major slot runs), and returns the
    gradients of ``center``, ``axis1``, ``axis2``, ``color`` and ``opacity``.
    ``depth``, ``conic`` and ``valid`` get none: binning is not
    differentiable, and the composite reads the axes, not the conic.  K1
    saves K3's checkpoints, and the forward keeps what the backward reads,
    only when ``need_grad``.
    """

    @staticmethod
    def forward(ctx, center, axis1, axis2, color, opacity, depth, valid, conic, width, height, config,
                need_grad):
        proj = ProjectedSplats(depth, center, axis1, axis2, conic, color, opacity, valid)
        with record_function("splat_bin"):
            binning, fields, _ = bin_and_prepare(proj, width, height, config)
        ctx.mark_non_differentiable(binning.num_pairs)
        if not need_grad:
            raw, _, _ = composite_tiles(fields, binning.tile_starts, width, height, config)
            return untile(raw, width, height, config), binning.num_pairs
        raw, _, ckpt = composite_tiles(fields, binning.tile_starts, width, height, config, checkpoints=True)
        ctx.save_for_backward(fields, binning.tile_starts, raw, binning.perm, binning.bounds,
                              ckpt.state, ckpt.seg_starts, ckpt.pairs_done)
        ctx.frame = (width, height, config, ckpt.segment_steps)
        return untile(raw, width, height, config), binning.num_pairs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_img, _grad_demand):
        fields, tile_starts, raw, perm, bounds, state, seg_starts, fwd_done = ctx.saved_tensors
        width, height, config, segment_steps = ctx.frame
        dout = tile_layout(grad_img.to(torch.float32), width, height, config)
        ckpt = Checkpoints(state, seg_starts, fwd_done, segment_steps)
        dpairs, _ = composite_bwd(fields, tile_starts, raw, dout, perm, width, height, config, ckpt)
        dsplat = run_reduce(dpairs, bounds)  # (10, N)
        return (
            dsplat[0:2].T, dsplat[2:4].T, dsplat[4:6].T, dsplat[6:9].T, dsplat[9],
            None, None, None, None, None, None, None,
        )


def rasterize(proj: ProjectedSplats, width: int, height: int, config: RasterizeConfig):
    """Differentiable rasterization through :class:`Rasterize`; ``(image, demand)``."""
    inputs = (proj.center, proj.axis1, proj.axis2, proj.color, proj.opacity)
    need_grad = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    return Rasterize.apply(
        *inputs, proj.depth, proj.valid, proj.conic, width, height, config, need_grad,
    )
