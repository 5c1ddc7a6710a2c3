"""Debug render modes: points, index colors, splat boxes, chunk bounds.

The reference's debug visualizations (GaussianSplatRenderer.cs:217-224
RenderMode, the GaussianDebugRenderPoints/Boxes shaders): quick visual
fixtures that bypass the tile pipeline, to tell decode errors from
projection or compositing errors (SURVEY.md §4.3).  Scatters rather than
draws: debug paths, not hot paths.  Each mode runs on ``device`` (CUDA unless
told otherwise) and returns an (H, W, 3) image there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.projection import project_splats
from ..ops.tile_common import true_div
from ..utils.config import RenderSettings
from ..utils.device import resolve_device
from .camera import Camera
from .gaussians import Gaussians

# Splats a step of render_debug_boxes tests against every pixel at once.
BOX_CHUNK = 64


def _index_color(idx: torch.Tensor) -> torch.Tensor:
    """Hash a splat index into a stable debug color (the index-as-color mode,
    GaussianDebugRenderPoints.shader:31-58): the JAX package's uint32
    product ``idx * 2654435761`` with wraparound, in int64 (idx < 2^31, so
    it does not overflow), masked to 32 bits and then to its low 24."""
    h = ((idx.to(torch.int64) * 2654435761) & 0xFFFFFFFF) & 0xFFFFFF
    channels = [(h >> shift) & 0xFF for shift in (0, 8, 16)]
    return true_div(torch.stack(channels, dim=-1).to(torch.float32), 255.0)


def _background(camera: Camera, background, device) -> torch.Tensor:
    img = torch.zeros((camera.height, camera.width, 3), dtype=torch.float32, device=device)
    return img + torch.as_tensor(background, dtype=torch.float32).to(device)


def _pixel_centers(g: Gaussians, camera: Camera):
    """Rounded pixel of each splat center (int64) and whether the splat is
    in front of the camera (view z > 1e-6)."""
    view = camera.world_to_view(g.means)
    valid = view[:, 2] > 1e-6
    pix = torch.round(camera.view_to_pixel(view))  # half to even, as jnp.round
    # Behind the camera pix may be anything; off-screen it may pass int32.
    pix = torch.where(valid[:, None], pix, 0.0).clamp(-(2.0**30), 2.0**30).to(torch.int64)
    return pix[:, 0], pix[:, 1], valid


def _set_last_wins(img: torch.Tensor, x, y, ok, color) -> torch.Tensor:
    """``img.at[ys, xs].set(where(ok, color, img[ys, xs]))`` with the JAX
    package's CPU scatter semantics: rows not ``ok`` write the old value at
    (0, 0), and where rows share a pixel the highest row index wins.  The
    winner is made explicit (an ``amax`` of row indices per pixel, then a
    gather), so the image is the same on every device."""
    h, w, _ = img.shape
    n = x.shape[0]
    if n == 0:
        return img
    flat = img.reshape(h * w, 3)
    target = torch.where(ok, y * w + x, 0)
    values = torch.where(ok[:, None], color, flat[target])
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=img.device)
    winner.scatter_reduce_(0, target, torch.arange(n, device=img.device), reduce="amax")
    written = values[winner.clamp(min=0)]
    return torch.where((winner >= 0)[:, None], written, flat).reshape(h, w, 3)


def render_debug_points(
    g: Gaussians,
    camera: Camera,
    point_size: int = 2,
    by_index: bool = False,
    background=(0.0, 0.0, 0.0),
    device=None,
) -> torch.Tensor:
    """Splat centers as fixed-size squares (the DebugPoints mode)."""
    dev = resolve_device(device)
    g, camera = g.to(dev), camera.to(dev)
    x0, y0, valid = _pixel_centers(g, camera)
    color = _index_color(torch.arange(g.num_splats, device=dev)) if by_index else g.base_color
    img = _background(camera, background, dev)
    for dy in range(point_size):
        for dx in range(point_size):
            x = x0 + dx - point_size // 2
            y = y0 + dy - point_size // 2
            ok = valid & (x >= 0) & (x < camera.width) & (y >= 0) & (y < camera.height)
            img = _set_last_wins(img, x, y, ok, color)
    return img


def render_debug_boxes(
    g: Gaussians,
    camera: Camera,
    settings: RenderSettings = RenderSettings(),
    background=(0.0, 0.0, 0.0),
    device=None,
) -> torch.Tensor:
    """Each splat's +-2 sigma screen AABB as a translucent overlay (the
    DebugBoxes mode, in screen space): ``0.1 * color`` added per covered
    pixel in splat order, then clipped to [0, 1].  O(N * H * W): a debug
    path for small scenes, its coverage tested :data:`BOX_CHUNK` splats at a
    time.

    The sums round as the JAX package's CPU build rounds them, which the
    committed golden records: its compiled scan adds red and green as one
    fused multiply-add and blue as a rounded product, then a sum.  Every sum
    is a multiple of 0.1/255, so its u8 value often sits on a rounding tie
    and the last bit decides it.  Red and green add in float64 here (the
    product is exact there, so the sum rounds once, as a fused add does).
    """
    dev = resolve_device(device)
    g, camera = g.to(dev), camera.to(dev)
    proj = project_splats(g, camera, settings)
    rx = 2.0 * (torch.abs(proj.axis1[:, 0]) + torch.abs(proj.axis2[:, 0]))
    ry = 2.0 * (torch.abs(proj.axis1[:, 1]) + torch.abs(proj.axis2[:, 1]))
    ys = torch.arange(camera.height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(camera.width, dtype=torch.float32, device=dev) + 0.5
    colors = _index_color(torch.arange(g.num_splats, device=dev))
    tenth = float(np.float32(0.1))
    img = _background(camera, background, dev)
    for lo in range(0, g.num_splats, BOX_CHUNK):
        sl = slice(lo, lo + BOX_CHUNK)
        in_x = torch.abs(xs[None, :] - proj.center[sl, 0, None]) <= rx[sl, None]  # (C, W)
        in_y = (torch.abs(ys[None, :] - proj.center[sl, 1, None]) <= ry[sl, None]) & proj.valid[sl, None]
        covered = (in_y[:, :, None] & in_x[:, None, :])[..., None] * colors[sl, None, None, :]  # (C, H, W, 3)
        fused = covered[..., :2].double() * tenth
        rounded = covered[..., 2:] * 0.1
        for j in range(covered.shape[0]):  # in splat order
            img = torch.cat([(img[..., :2].double() + fused[j]).float(), img[..., 2:] + rounded[j]], dim=-1)
    return torch.clamp(img, 0.0, 1.0)


def render_debug_chunk_bounds(
    g: Gaussians, camera: Camera, chunk_size: int = 256, background=(0.0, 0.0, 0.0), device=None
) -> torch.Tensor:
    """Splat centers as single pixels colored per chunk of ``chunk_size``
    splats (the DebugChunkBounds mode; chunks follow the import's Morton
    order)."""
    dev = resolve_device(device)
    g, camera = g.to(dev), camera.to(dev)
    x, y, valid = _pixel_centers(g, camera)
    color = _index_color(torch.div(torch.arange(g.num_splats, device=dev), chunk_size, rounding_mode="floor"))
    ok = valid & (x >= 0) & (x < camera.width) & (y >= 0) & (y < camera.height)
    return _set_last_wins(_background(camera, background, dev), x, y, ok, color)
