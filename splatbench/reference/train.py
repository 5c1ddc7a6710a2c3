"""Plain reference of a 3DGS train step: the frame, the loss (L1 and
D-SSIM, Kerbl et al. 2023), the gradients of the six raw fields, and Adam.

The frame's gradient is autograd's through ``render.composite``, taken in
blocks of tiles: a forward without gradients gives the image and each
tile's walk, the loss gives the image's gradient, and each block of tiles
is composited again with gradients on and differentiated at once, its
saved tensors freed before the next.  The projected fields collect the
blocks' gradients, and autograd takes them back through the projection
and the activations to the raw fields.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import render as R

RAW_FIELDS = ("means", "rotations_wxyz", "log_scales", "opacity_logits", "sh0", "sh")
GRAD_FIELDS = ("center", "axis1", "axis2", "color", "opacity")
# Tile-steps composited with gradients at once: autograd keeps about a
# dozen (chunk, pixels) tensors a tile-step.
BLOCK_TILE_STEPS = 384


def _window(dtype, device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g).to(dtype)[None, None]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images: an 11x11 Gaussian window (sigma
    1.5), zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    win = _window(a.dtype, a.device)

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[:, None], win, padding=5)[:, 0].permute(1, 2, 0)

    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a * mu_a
    var_b = filt(b * b) - mu_b * mu_b
    cov = filt(a * b) - mu_a * mu_b
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def loss_fn(rgba: torch.Tensor, target: torch.Tensor, background, ssim_weight: float) -> torch.Tensor:
    """(1 - w) L1 + w (1 - SSIM) / 2 of the frame over ``background``."""
    bg = torch.as_tensor(background, dtype=rgba.dtype, device=rgba.device)
    img = rgba[..., :3] + (1.0 - rgba[..., 3:4]) * bg
    target = target.to(rgba.dtype)
    l1 = torch.mean(torch.abs(img - target))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(img, target)) / 2.0


def _blocks(steps: torch.Tensor, limit: int) -> list[torch.Tensor]:
    """Tiles in blocks of at most ``limit`` tile-steps, in order of their walks."""
    order = torch.argsort(steps, descending=True).tolist()
    walks = steps.tolist()
    blocks, cur, used = [], [], 0
    for t in order:
        if walks[t] == 0:
            continue
        if cur and used + walks[t] > limit:
            blocks.append(cur)
            cur, used = [], 0
        cur.append(t)
        used += walks[t]
    if cur:
        blocks.append(cur)
    return [torch.tensor(b, device=steps.device) for b in blocks]


def frame_gradients(raw: dict, view, target, ras: R.Raster, background, ssim_weight: float):
    """Loss and the gradient of every raw field for one view.

    ``raw`` holds the six fields as leaves (their dtype is the step's);
    returns ``(loss, {field: gradient})``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    pr = R.round_view(R.project(R.activate(leaves, leaves["means"].dtype), view, ras), ras)
    splat, starts = R.tile_pairs(pr, ras)
    flat = {k: pr[k].detach().requires_grad_(True) for k in GRAD_FIELDS}
    fixed = dict(flat, valid=pr["valid"], depth=pr["depth"].detach())
    with torch.no_grad():
        rgba, steps = R.composite(fixed, splat, starts, ras)
    img = R.untile(rgba, ras).requires_grad_(True)
    loss = loss_fn(img, target, background, ssim_weight)
    (dimg,) = torch.autograd.grad(loss, img)
    dtiles = R.tiled(dimg, ras)
    for block in _blocks(steps, BLOCK_TILE_STEPS):
        out, _ = R.composite(fixed, splat, starts, ras, tiles=block)
        torch.autograd.backward(out, dtiles[block])
        del out
    torch.autograd.backward([pr[k] for k in GRAD_FIELDS], [flat[k].grad for k in GRAD_FIELDS])
    return loss.detach(), {k: leaves[k].grad for k in RAW_FIELDS}


class Adam:
    """Adam as ``torch.optim.Adam`` states it (betas 0.9, 0.999; bias-corrected
    moments; ``eps`` added to the corrected root), one learning rate a field."""

    def __init__(self, params: dict, eps: float, betas=(0.9, 0.999)):
        self.eps, self.b1, self.b2 = eps, betas[0], betas[1]
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lrs: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1**self.t
        c2 = 1.0 - self.b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / (c2**0.5) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lrs[k] / c1)
