"""Plain reference of a splat frame: activation, projection with SH, tile
binning in depth order, and the front-to-back composite.

Semantics (the reference viewer's, as the port's configuration states
them): a splat covers the tiles of its opacity-aware ellipse bounds; each
tile composites its splats in the order of the top ``depth_bits`` bits of
their float32 view depth, ties by splat index; a pixel's alpha is the
quad-clipped Gaussian, clamped at ``alpha_max``, discarded under
``alpha_discard``; projected color and opacity are rounded through float16
(the packed view data, ``SplatUtilities.compute:247-248``); a tile stops
once every pixel's transmittance is under ``transmittance_eps`` (checked
every ``chunk`` splats).

Everything runs in the dtype of the cloud it is given: float32 is the
reference, bfloat16 the control (``dtype`` below).  ``composite`` is one
functional loop over all tiles at once, the tiles that are done dropped at
every step; with gradients on, the caller runs it in blocks of tiles so
that autograd's saved tensors fit (``train.frame_gradients``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

SH_C0 = 0.2820948
SH_C1 = 0.4886025
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (-0.5900436, 2.8906114, -0.4570458, 0.3731763, -0.4570458, 1.4453057, -0.5900436)
COV2D_LOWPASS = 0.3
CLAMP_FACTOR = 1.3
MIN_LAMBDA = 0.1
MAX_AXIS_LEN = 4096.0
OPACITY_CLAMP = 65000.0
F16_MIN_NORMAL = 6.103515625e-05
SPLAT_BITS = 23  # splat index bits of the sort key: clouds of up to 8,388,608 splats


@dataclasses.dataclass(frozen=True)
class Raster:
    """A frame's size and the composite's constants (a configuration file's
    ``raster`` and size keys)."""

    width: int
    height: int
    fov_y_deg: float
    sh_order: int = 3
    tile_w: int = 64
    tile_h: int = 32
    chunk: int = 128
    transmittance_eps: float = 1e-4
    alpha_discard: float = 1.0 / 255.0
    alpha_max: float = 0.9999
    quad_clip: bool = True
    color_f16: bool = True

    @property
    def tiles(self) -> tuple[int, int]:
        return -(-self.width // self.tile_w), -(-self.height // self.tile_h)

    @property
    def depth_bits(self) -> int:
        tx, ty = self.tiles
        return min(32 - max(int(tx * ty + 1).bit_length(), 1), 24)

    @classmethod
    def from_config(cls, cfg: dict) -> "Raster":
        return cls(width=cfg["width"], height=cfg["height"], fov_y_deg=cfg["fov_y_deg"],
                   sh_order=cfg["sh_degree"], **cfg.get("raster", {}))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded (a divisor tensor, not a reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def activate(raw: dict, dtype=torch.float32) -> dict:
    """3DGS PLY fields -> the activated cloud (``GaussianFileReader.cs:210-240``)."""
    q = raw["rotations_wxyz"].to(dtype)
    q = q / torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=1e-24))
    return dict(
        means=raw["means"].to(dtype),
        rotations=torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1),  # xyzw
        scales=torch.abs(torch.exp(raw["log_scales"].to(dtype))),
        opacities=1.0 / (1.0 + torch.exp(-raw["opacity_logits"].to(dtype))),
        base_color=raw["sh0"].to(dtype) * SH_C0 + 0.5,
        sh=raw["sh"].to(dtype),
    )


def _shade(base, sh, d, order: int):
    """SH shading of degrees 1..``order`` (``GaussianSplatting.hlsl:130-179``), clamped at 0."""
    res = base
    if order >= 1:
        x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        res = res + SH_C1 * (-sh[:, 0] * y + sh[:, 1] * z - sh[:, 2] * x)
        if order >= 2:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            res = res + ((SH_C2[0] * xy) * sh[:, 3] + (SH_C2[1] * yz) * sh[:, 4]
                         + (SH_C2[2] * (2 * zz - xx - yy)) * sh[:, 5] + (SH_C2[3] * xz) * sh[:, 6]
                         + (SH_C2[4] * (xx - yy)) * sh[:, 7])
            if order >= 3:
                res = res + ((SH_C3[0] * y * (3 * xx - yy)) * sh[:, 8] + (SH_C3[1] * xy * z) * sh[:, 9]
                             + (SH_C3[2] * y * (4 * zz - xx - yy)) * sh[:, 10]
                             + (SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)) * sh[:, 11]
                             + (SH_C3[4] * x * (4 * zz - xx - yy)) * sh[:, 12]
                             + (SH_C3[5] * z * (xx - yy)) * sh[:, 13]
                             + (SH_C3[6] * x * (xx - 3 * yy)) * sh[:, 14])
    return torch.clamp(res, min=0.0)


def project(g: dict, view, ras: Raster) -> dict:
    """The per-splat view calculation (``SplatUtilities.compute:189-252``):
    view position, EWA screen covariance and its axes, SH color, opacity.
    ``view`` is a (4, 4) world->view matrix (host or device)."""
    dt, dev = g["means"].dtype, g["means"].device
    m = torch.as_tensor(view, dtype=torch.float32).to(dev).to(dt)
    tan_fovy = math.tan(0.5 * math.radians(ras.fov_y_deg))
    tan_fovx = tan_fovy * (ras.width / ras.height)
    focal = ras.width / (2.0 * tan_fovx)
    p = g["means"]
    vp = [p[:, 0] * m[i, 0] + p[:, 1] * m[i, 1] + p[:, 2] * m[i, 2] + m[i, 3] for i in range(3)]
    vx, vy, depth = vp
    valid = depth > 1e-8
    # A culled splat takes no part in the frame, so its gradient is nought:
    # its depth is replaced by 1 in the projection, whose outputs it never
    # reaches, so that no infinity (a depth of exactly 0) turns into NaN.
    z = torch.where(valid, depth, 1.0)
    cx = (vx / (z * tan_fovx) * 0.5 + 0.5) * ras.width
    cy = (0.5 - vy / (z * tan_fovy) * 0.5) * ras.height

    x, y, zq, w = g["rotations"].unbind(-1)
    s0, s1, s2 = g["scales"].unbind(-1)
    r = [[1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq), 2 * (x * zq + w * y)],
         [2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - w * x)],
         [2 * (x * zq - w * y), 2 * (y * zq + w * x), 1 - 2 * (x * x + y * y)]]
    mm = [[r[i][0] * s0, r[i][1] * s1, r[i][2] * s2] for i in range(3)]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    vxx, vxy, vxz = dot(mm[0], mm[0]), dot(mm[0], mm[1]), dot(mm[0], mm[2])
    vyy, vyz, vzz = dot(mm[1], mm[1]), dot(mm[1], mm[2]), dot(mm[2], mm[2])
    tx = torch.clamp(vx / z, -CLAMP_FACTOR * tan_fovx, CLAMP_FACTOR * tan_fovx) * z
    ty = torch.clamp(vy / z, -CLAMP_FACTOR * tan_fovy, CLAMP_FACTOR * tan_fovy) * z
    inv_z = 1.0 / z
    j00, j02, j12 = focal * inv_z, -focal * tx * (inv_z * inv_z), -focal * ty * (inv_z * inv_z)
    t0 = [j00 * m[0, k] + j02 * m[2, k] for k in range(3)]
    t1 = [j00 * m[1, k] + j12 * m[2, k] for k in range(3)]

    def quad(a, b):
        return (a[0] * (vxx * b[0] + vxy * b[1] + vxz * b[2]) + a[1] * (vxy * b[0] + vyy * b[1] + vyz * b[2])
                + a[2] * (vxz * b[0] + vyz * b[1] + vzz * b[2]))

    cxx = quad(t0, t0) + COV2D_LOWPASS
    cyy = quad(t1, t1) + COV2D_LOWPASS
    cxy = -quad(t0, t1)
    mid = 0.5 * (cxx + cyy)
    radius = torch.sqrt(torch.clamp(((cxx - cyy) * 0.5) * ((cxx - cyy) * 0.5) + cxy * cxy, min=1e-24))
    lam1 = mid + radius
    lam2 = torch.clamp(mid - radius, min=MIN_LAMBDA)
    ex, ey = cxy, lam1 - cxx
    norm = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-30))
    ok = norm > 1e-12
    nrm = torch.clamp(norm, min=1e-12)
    exn, eyn = torch.where(ok, ex / nrm, 1.0), torch.where(ok, ey / nrm, 0.0)
    len1 = torch.clamp(torch.sqrt(2.0 * lam1), max=MAX_AXIS_LEN)
    len2 = torch.clamp(torch.sqrt(2.0 * lam2), max=MAX_AXIS_LEN)

    rot = m[:3, :3]
    cam = -(rot[0] * m[0, 3] + rot[1] * m[1, 3] + rot[2] * m[2, 3])  # -R^T t
    d = p - cam
    d = d / torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-24))
    color = _shade(g["base_color"], g["sh"], d, ras.sh_order)
    opacity = torch.clamp(g["opacities"], max=OPACITY_CLAMP)
    return dict(depth=depth, center=torch.stack([cx, cy], -1), axis1=torch.stack([len1 * exn, len1 * eyn], -1),
                axis2=torch.stack([len2 * eyn, -(len2 * exn)], -1), color=color, opacity=opacity, valid=valid)


def round_view(pr: dict, ras: Raster) -> dict:
    """Color and opacity through float16, subnormals flushed, gradients
    straight through (the packed view data)."""
    if not ras.color_f16:
        return pr

    def f16(x):
        r = x.to(torch.float16).to(x.dtype)
        r = torch.where(torch.abs(r) < F16_MIN_NORMAL, 0.0, r)
        return x + (r - x).detach()

    return dict(pr, color=f16(pr["color"]), opacity=f16(pr["opacity"]))


def tile_pairs(pr: dict, ras: Raster):
    """Every (splat, tile) pair of the frame in compositing order.

    Returns ``(splat (K,) int64, tile_starts (T + 1,) int64)``: the pairs
    of tile ``t`` are ``[tile_starts[t], tile_starts[t + 1])``, in depth
    order.  ``K`` is the frame's pair demand."""
    tiles_x, tiles_y = ras.tiles
    num_tiles = tiles_x * tiles_y
    n = pr["depth"].shape[0]
    if n >= 1 << SPLAT_BITS:
        raise ValueError(f"{n} splats: the reference's sort key holds {1 << SPLAT_BITS}")
    with torch.no_grad():
        a1, a2 = pr["axis1"].float(), pr["axis2"].float()
        op = pr["opacity"].float()
        rho = torch.sqrt(torch.clamp(torch.log(_div(torch.clamp(op, min=1e-30), ras.alpha_discard)), min=0.0))
        rx = rho * torch.sqrt(a1[:, 0] ** 2 + a2[:, 0] ** 2) * 1.0001 + 0.01
        ry = rho * torch.sqrt(a1[:, 1] ** 2 + a2[:, 1] ** 2) * 1.0001 + 0.01
        if ras.quad_clip:
            rx = torch.minimum(rx, 2.0 * (torch.abs(a1[:, 0]) + torch.abs(a2[:, 0])) + 0.01)
            ry = torch.minimum(ry, 2.0 * (torch.abs(a1[:, 1]) + torch.abs(a2[:, 1])) + 0.01)
        valid = pr["valid"] & (op >= ras.alpha_discard)
        cx, cy = pr["center"][:, 0].float(), pr["center"][:, 1].float()

        def cell(v, size, end, plus=0):
            t = torch.clamp(torch.floor(_div(v, size)) + plus, 0, end)
            return torch.nan_to_num(t, nan=0.0).to(torch.int64)

        x0, x1 = cell(cx - rx, ras.tile_w, tiles_x), cell(cx + rx, ras.tile_w, tiles_x, 1)
        y0, y1 = cell(cy - ry, ras.tile_h, tiles_y), cell(cy + ry, ras.tile_h, tiles_y, 1)
        nx, ny = torch.clamp(x1 - x0, min=0), torch.clamp(y1 - y0, min=0)
        counts = torch.where(valid, nx * ny, 0)
        ids = torch.nonzero(counts > 0).squeeze(1)
        c = counts[ids]
        splat = torch.repeat_interleave(ids, c)
        first = torch.repeat_interleave(torch.cumsum(c, 0) - c, c)
        j = torch.arange(splat.shape[0], device=splat.device) - first
        q = torch.div(j, nx[splat], rounding_mode="floor")
        tile = (y0[splat] + q) * tiles_x + x0[splat] + (j - q * nx[splat])
        raw = pr["depth"].float().contiguous().view(torch.int32)
        dq = (torch.clamp(raw, min=0) >> (32 - ras.depth_bits)).to(torch.int64)
        key = (tile << (24 + SPLAT_BITS)) | (dq[splat] << SPLAT_BITS) | splat
        key, order = torch.sort(key)
        splat = splat[order]
        starts = torch.searchsorted(key >> (24 + SPLAT_BITS), torch.arange(num_tiles + 1, device=key.device))
    return splat, starts


@dataclasses.dataclass
class Work:
    """What a frame's composite must do, counted per pixel up to the pixel's
    own saturation: ``evals`` the (pair, pixel) evaluations of pairs that
    reach the tile, ``kept`` those the pixel keeps (alpha at or above the
    discard, inside the quad); ``demand`` the frame's (splat, tile) pairs."""

    demand: int = 0
    evals: int = 0
    kept: int = 0


def composite(pr: dict, splat, starts, ras: Raster, tiles=None, work: Work | None = None):
    """Composite the pairs of ``tiles`` (all when None), front to back.

    Returns ``(rgba (len(tiles), 4, P), steps (len(tiles),))``: premultiplied
    color and coverage of each tile's pixels (row-major in the tile) and the
    chunks each tile walked.  Functional, so autograd can differentiate it;
    ``work`` (float32, no gradient) counts what the frame needs."""
    dev, dt = pr["center"].device, pr["center"].dtype
    tiles_x, _ = ras.tiles
    tw, c = ras.tile_w, ras.chunk
    npix = ras.tile_h * tw
    if tiles is None:
        tiles = torch.arange(starts.shape[0] - 1, device=dev)
    nt = tiles.shape[0]
    k = splat.shape[0]
    a1, a2 = pr["axis1"], pr["axis2"]
    a1sq = torch.clamp(a1[:, 0] * a1[:, 0] + a1[:, 1] * a1[:, 1], min=1e-12)
    a2sq = torch.clamp(a2[:, 0] * a2[:, 0] + a2[:, 1] * a2[:, 1], min=1e-12)
    per_splat = torch.stack([pr["center"][:, 0], pr["center"][:, 1], a1[:, 0] / a1sq, a1[:, 1] / a1sq,
                             a2[:, 0] / a2sq, a2[:, 1] / a2sq, pr["color"][:, 0], pr["color"][:, 1],
                             pr["color"][:, 2], torch.where(pr["valid"], pr["opacity"], 0.0)], dim=1)
    lane = torch.arange(npix, device=dev)
    px0 = (lane % tw).to(dt) + 0.5
    py0 = torch.div(lane, tw, rounding_mode="floor").to(dt) + 0.5
    lo, hi = starts[tiles], starts[tiles + 1]
    px = (tiles % tiles_x).to(dt)[:, None] * float(tw) + px0
    py = torch.div(tiles, tiles_x, rounding_mode="floor").to(dt)[:, None] * float(ras.tile_h) + py0
    trans = torch.ones((nt, npix), dtype=dt, device=dev)
    rgb = torch.zeros((nt, 3, npix), dtype=dt, device=dev)
    steps = torch.zeros(nt, dtype=torch.int64, device=dev)
    act = torch.arange(nt, device=dev)
    pos = lo.clone()
    lanes = torch.arange(c, device=dev)
    while True:
        with torch.no_grad():
            alive = (pos[act] < hi[act]) & (trans[act].amax(1) >= ras.transmittance_eps)
            act = act[alive]
        if act.numel() == 0:
            break
        idx = pos[act][:, None] + lanes
        live = idx < hi[act][:, None]
        f = per_splat[splat[torch.where(live, idx, 0).clamp(max=k - 1)]]  # (na, C, 10)
        dx = px[act][:, None, :] - f[..., 0:1]
        dy = py[act][:, None, :] - f[..., 1:2]
        qx = dx * f[..., 2:3] + dy * f[..., 3:4]
        qy = dx * f[..., 4:5] + dy * f[..., 5:6]
        alpha = torch.clamp(torch.exp(-(qx * qx + qy * qy)) * f[..., 9:10], 0.0, ras.alpha_max)
        keep = (alpha >= ras.alpha_discard) & live[..., None]
        if ras.quad_clip:
            keep = keep & (torch.abs(qx) <= 2.0) & (torch.abs(qy) <= 2.0)
        alpha = torch.where(keep, alpha, 0.0)
        cum = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        t_in = trans[act]
        w = excl * alpha * t_in[:, None, :]
        rgb = rgb.index_put((act,), rgb[act] + torch.bmm(f[..., 6:9].transpose(1, 2), w))
        trans = trans.index_put((act,), t_in * cum[:, -1])
        if work is not None:
            with torch.no_grad():
                reaches = keep.any(dim=2, keepdim=True)  # the pair touches a pixel of the tile
                ev = (t_in[:, None, :] * excl >= ras.transmittance_eps) & reaches
                work.evals += int(ev.sum())
                work.kept += int((ev & keep).sum())
        with torch.no_grad():
            pos[act] += c
            steps[act] += 1
    return torch.cat([rgb, (1.0 - trans)[:, None, :]], dim=1), steps


def untile(rgba: torch.Tensor, ras: Raster) -> torch.Tensor:
    """(T, 4, P) tiles -> (H, W, 4) image."""
    tiles_x, tiles_y = ras.tiles
    img = rgba.reshape(tiles_y, tiles_x, 4, ras.tile_h, ras.tile_w).permute(0, 3, 1, 4, 2)
    return img.reshape(tiles_y * ras.tile_h, tiles_x * ras.tile_w, 4)[: ras.height, : ras.width]


def tiled(img: torch.Tensor, ras: Raster) -> torch.Tensor:
    """(H, W, 4) image -> (T, 4, P) tiles, zero past the frame's edge."""
    tiles_x, tiles_y = ras.tiles
    pad = torch.nn.functional.pad(img, (0, 0, 0, tiles_x * ras.tile_w - ras.width,
                                        0, tiles_y * ras.tile_h - ras.height))
    t = pad.reshape(tiles_y, ras.tile_h, tiles_x, ras.tile_w, 4).permute(0, 2, 4, 1, 3)
    return t.reshape(tiles_x * tiles_y, 4, ras.tile_h * ras.tile_w)


@torch.no_grad()
def render(g: dict, view, ras: Raster, work: Work | None = None):
    """The frame of an activated cloud ``g`` from ``view``: (H, W, 4)
    premultiplied linear RGBA in the cloud's dtype."""
    pr = round_view(project(g, view, ras), ras)
    splat, starts = tile_pairs(pr, ras)
    if work is not None:
        work.demand += int(splat.shape[0])
    rgba, _ = composite(pr, splat, starts, ras, work=work)
    return untile(rgba, ras)
