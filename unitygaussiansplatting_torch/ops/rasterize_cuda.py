"""Tile composite (K1) and the forward rasterizer around it.

``composite_tiles`` is the port of the Pallas kernel ``_kernel``
(unitygaussiansplatting_tpu/ops/rasterize_pallas.py:134) with its schedule
(``build_schedule``) folded into the kernel: one thread block per tile walks
the tile's sorted pair range in steps cut at global multiples of
``chunk_size``.  :class:`Rasterize` runs binning (K2 + sort) and K1 and
untiles the result; it is forward only.
"""

from __future__ import annotations

import torch

from ..utils.config import RasterizeConfig
from . import cuda_build
from .binning import tile_grid
from .pair_expand import NUM_FIELDS, bin_and_prepare
from .projection import ProjectedSplats


def composite_tiles_plain(fields, tile_starts, width: int, height: int, config: RasterizeConfig):
    """Plain PyTorch version of K1: the same steps, per tile, in a Python loop.

    Per step the (pairs, pixels) alphas, the exclusive prefix product of
    ``1 - alpha`` along the pairs (``torch.cumprod``) and the weighted color
    sums are whole-tensor operations; the early exit reads the tile's max
    transmittance before each step.
    """
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    th, tw, c = config.tile_h, config.tile_w, config.chunk_size
    npix = th * tw
    dev = fields.device
    raw = torch.zeros((num_tiles + 1, 4, npix), dtype=torch.float32, device=dev)
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
        rgb = torch.zeros((3, npix), dtype=torch.float32, device=dev)
        done = 0
        for blk in range(s // c, (e - 1) // c + 1):
            trans = 1.0 - cov
            if not bool(torch.max(trans) >= config.transmittance_eps):
                break
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
            done += hi - lo
        raw[t, :3] = rgb
        raw[t, 3] = cov
        pairs_done[t] = done
    return raw, pairs_done


def composite_tiles(fields, tile_starts, width: int, height: int, config: RasterizeConfig):
    """K1: composite every tile's depth-sorted pairs.

    ``fields`` (10, K) float32 in sorted pair order, ``tile_starts`` (T+1,)
    int32.  Returns ``(raw (T+1, 4, P) float32, pairs_done (T,) int32)``:
    premultiplied rgb + coverage per tile pixel (row T, the sentinel tile, is
    zero) and the pairs each tile composited before its early exit.
    Replaces the Pallas kernel ``_kernel``
    (unitygaussiansplatting_tpu/ops/rasterize_pallas.py:134).  Bound on the
    H100 by fp32 operations (~30, one of them an exp, per pair and pixel
    evaluated); the per-pair divisions are hoisted into the shared-memory
    staging so the per-pixel loop is multiply-adds and one expf.  CPU tensors take
    :func:`composite_tiles_plain`; CUDA tensors launch the kernel.
    """
    tiles_x, tiles_y = tile_grid(width, height, config)
    num_tiles = tiles_x * tiles_y
    if fields.dim() != 2 or fields.shape[0] != NUM_FIELDS or fields.dtype != torch.float32:
        raise ValueError(f"fields must be ({NUM_FIELDS}, K) float32, got {tuple(fields.shape)} {fields.dtype}")
    if tile_starts.shape != (num_tiles + 1,) or tile_starts.dtype != torch.int32:
        raise ValueError(f"tile_starts must be ({num_tiles + 1},) int32, got {tuple(tile_starts.shape)} {tile_starts.dtype}")
    if tile_starts.device != fields.device:
        raise ValueError("fields and tile_starts must be on one device")
    if fields.device.type == "cpu":
        return composite_tiles_plain(fields, tile_starts, width, height, config)
    if fields.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on CPU or CUDA tensors, got {fields.device}")
    if not (fields.is_contiguous() and tile_starts.is_contiguous()):
        raise ValueError("fields and tile_starts must be contiguous")
    npix = config.tile_w * config.tile_h
    lib = cuda_build.library("composite_fwd")
    if lib.composite_fwd_pixels_per_thread(npix) == 0:
        raise ValueError(f"tile of {npix} pixels: the kernel needs a multiple of 32 up to 8192")
    raw = torch.zeros((num_tiles + 1, 4, npix), dtype=torch.float32, device=fields.device)
    pairs_done = torch.empty(num_tiles, dtype=torch.int32, device=fields.device)
    status = lib.composite_fwd_launch(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(), num_tiles, tiles_x,
        config.tile_w, config.tile_h, config.chunk_size, config.transmittance_eps,
        config.alpha_discard, config.alpha_max, int(config.quad_clip),
        raw.data_ptr(), pairs_done.data_ptr(),
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    cuda_build.check(lib, "composite_fwd", status, "composite_tiles")
    composite_tiles.launches += 1
    return raw, pairs_done


composite_tiles.launches = 0


def untile(raw, width: int, height: int, config: RasterizeConfig):
    """(T+1, 4, P) tile-major buffer -> (H, W, 4) image."""
    th, tw = config.tile_h, config.tile_w
    tiles_x, tiles_y = tile_grid(width, height, config)
    img = raw[: tiles_x * tiles_y].reshape(tiles_y, tiles_x, 4, th, tw)
    img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * th, tiles_x * tw, 4)
    return img[:height, :width]


class Rasterize(torch.autograd.Function):
    """Bin (K2 + sort) and composite (K1): ``(image (H, W, 4), slot demand
    () int32)``, as a forward-only autograd node.

    Its backward raises: the backward composite and run-reduce kernels (the
    TPU package's K3/K4, rasterize_pallas_bwd.py) are the port's next slice.
    Returning an image that silently carries no gradient would be worse.
    """

    @staticmethod
    def forward(ctx, center, axis1, axis2, color, opacity, depth, valid, conic, width, height, config):
        proj = ProjectedSplats(depth, center, axis1, axis2, conic, color, opacity, valid)
        binning, fields, _ = bin_and_prepare(proj, width, height, config)
        raw, _ = composite_tiles(fields, binning.tile_starts, width, height, config)
        ctx.mark_non_differentiable(binning.num_pairs)
        return untile(raw, width, height, config), binning.num_pairs

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the cuda backend is forward only: the backward composite and run-reduce "
            "kernels (K3/K4) come with the port's training slice"
        )


def rasterize(proj: ProjectedSplats, width: int, height: int, config: RasterizeConfig):
    """Forward rasterization through :class:`Rasterize`; ``(image, demand)``."""
    return Rasterize.apply(
        proj.center, proj.axis1, proj.axis2, proj.color, proj.opacity, proj.depth,
        proj.valid, proj.conic, width, height, config,
    )
