"""Plain reference of a frame of several splat objects, each under its own
object->world model matrix.

Semantics (the reference viewer's ``GaussianSplatRenderSystem``,
GaussianSplatRenderer.cs:73-169, and ``CSCalcViewData``,
SplatUtilities.compute:189-252, as SURVEY.md describes them):

- the objects are ordered by explicit render order (higher first), then by
  the view depth of their origin (nearest first), then by index;
- each object is projected under its model matrix: its mean goes through
  the model into the world and then through the view; its covariance goes
  through the model-view matrix; its SH direction is the camera->splat
  direction taken into object space by the inverse of the model's linear
  part, then normalised;
- each object is binned, depth-sorted and composited alone, with
  ``render.py``'s tiles and composite;
- the objects' frames composite front to back into one target ("under"
  blending: what comes later goes behind what is drawn).

Departures from that description:

- the view position (depth and screen center) is the object-space mean
  through the model-view matrix ``V @ M``, as the covariance's view
  position is (``CalcCovariance2D`` takes ``_MatrixMV``, and the reference
  viewer's sort key ``CSCalcDistances`` too); the reference viewer's clip
  position takes the world position through the view, ``V (M p)``.  The
  two are the same value rounded otherwise, and a rounding of a center by
  ~1e-4 px flips a pixel's quad clip or alpha discard: on 100k splats at
  400x266 on the CPU that moved frames by 1.3e-3 against the port, over the cell's
  limit, where ``V @ M`` leaves only the composite's exit;
- the inverse model "rotation" is the inverse of the whole (3, 3) linear
  part, so a uniformly scaled model is allowed (the normalisation takes the
  scale out again);
- the projected color and opacity go through float16 (``render.round_view``)
  and the objects' frames composite in float32 (the reference viewer's
  target is ``R16G16B16A16_SFloat``).

Everything runs in the dtype of the clouds it is given (float32 the
reference, bfloat16 the control), on their device.  The 4x4 and 3x3
matrix products and the inverse are ``torch`` calls with TF32 off, as the
port makes them; the rest is written out a component at a time.  It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from . import render as ref


def _affine(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``p @ m[:3, :3].T + m[:3, 3]``, a component at a time."""
    return torch.stack([p[:, 0] * m[i, 0] + p[:, 1] * m[i, 1] + p[:, 2] * m[i, 2] + m[i, 3] for i in range(3)], -1)


def project(g: dict, view, model, ras: ref.Raster) -> dict:
    """``render.project`` of an object under the (4, 4) ``model`` matrix:
    view position, EWA screen covariance and its axes, SH color, opacity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt, dev = g["means"].dtype, g["means"].device
    v = torch.as_tensor(view, dtype=torch.float32).to(dev).to(dt)
    mo = torch.as_tensor(model, dtype=torch.float32).to(dev).to(dt)
    mv = v @ mo  # the model-view matrix
    tan_fovy = math.tan(0.5 * math.radians(ras.fov_y_deg))
    tan_fovx = tan_fovy * (ras.width / ras.height)
    focal = ras.width / (2.0 * tan_fovx)
    world = _affine(g["means"], mo)
    vx, vy, depth = _affine(g["means"], mv).unbind(-1)
    valid = depth > 1e-8
    z = torch.where(valid, depth, 1.0)
    cx = (vx / (z * tan_fovx) * 0.5 + 0.5) * ras.width
    cy = (0.5 - vy / (z * tan_fovy) * 0.5) * ras.height

    # The object-space covariance R S S R^T, taken to the view by the
    # model-view matrix and to the screen by the EWA Jacobian.
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
    tx = torch.clamp(vx / z, -ref.CLAMP_FACTOR * tan_fovx, ref.CLAMP_FACTOR * tan_fovx) * z
    ty = torch.clamp(vy / z, -ref.CLAMP_FACTOR * tan_fovy, ref.CLAMP_FACTOR * tan_fovy) * z
    inv_z = 1.0 / z
    j00, j02, j12 = focal * inv_z, -focal * tx * (inv_z * inv_z), -focal * ty * (inv_z * inv_z)
    t0 = [j00 * mv[0, k] + j02 * mv[2, k] for k in range(3)]
    t1 = [j00 * mv[1, k] + j12 * mv[2, k] for k in range(3)]

    def quad(a, b):
        return (a[0] * (vxx * b[0] + vxy * b[1] + vxz * b[2]) + a[1] * (vxy * b[0] + vyy * b[1] + vyz * b[2])
                + a[2] * (vxz * b[0] + vyz * b[1] + vzz * b[2]))

    cxx = quad(t0, t0) + ref.COV2D_LOWPASS
    cyy = quad(t1, t1) + ref.COV2D_LOWPASS
    cxy = -quad(t0, t1)
    mid = 0.5 * (cxx + cyy)
    radius = torch.sqrt(torch.clamp(((cxx - cyy) * 0.5) * ((cxx - cyy) * 0.5) + cxy * cxy, min=1e-24))
    lam1 = mid + radius
    lam2 = torch.clamp(mid - radius, min=ref.MIN_LAMBDA)
    ex, ey = cxy, lam1 - cxx
    norm = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-30))
    ok = norm > 1e-12
    nrm = torch.clamp(norm, min=1e-12)
    exn, eyn = torch.where(ok, ex / nrm, 1.0), torch.where(ok, ey / nrm, 0.0)
    len1 = torch.clamp(torch.sqrt(2.0 * lam1), max=ref.MAX_AXIS_LEN)
    len2 = torch.clamp(torch.sqrt(2.0 * lam2), max=ref.MAX_AXIS_LEN)

    cam = -(v[:3, :3].T @ v[:3, 3])  # -R^T t: the camera in the world
    inv = torch.linalg.inv(mo[:3, :3].float()).to(dt)
    d = (world - cam) @ inv.T  # into object space
    d = d / torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-24))
    color = ref._shade(g["base_color"], g["sh"], d, ras.sh_order)
    opacity = torch.clamp(g["opacities"], max=ref.OPACITY_CLAMP)
    return dict(depth=depth, center=torch.stack([cx, cy], -1), axis1=torch.stack([len1 * exn, len1 * eyn], -1),
                axis2=torch.stack([len2 * eyn, -(len2 * exn)], -1), color=color, opacity=opacity, valid=valid)


@torch.no_grad()
def render_object(g: dict, view, model, ras: ref.Raster, work: ref.Work | None = None) -> torch.Tensor:
    """One object's frame under ``model``: (H, W, 4) premultiplied RGBA in
    the cloud's dtype, by ``render.py``'s tiles and composite."""
    pr = ref.round_view(project(g, view, model, ras), ras)
    splat, starts = ref.tile_pairs(pr, ras)
    if work is not None:
        work.demand += int(splat.shape[0])
    rgba, _ = ref.composite(pr, splat, starts, ras, work=work)
    return ref.untile(rgba, ras)


def object_order(view, models, render_order) -> list[int]:
    """The objects' indices in compositing order: higher render order first,
    then the nearer origin, then the lower index.  An origin's view depth is
    taken in float32 on the host, each product and sum rounded in the order
    ``x v20 + y v21 + z v22 + v23``: two origins that the layout puts at the
    same depth mathematically (the ring's poses at 90 and 270 degrees) then
    fall in the order their float32 matrices give, on both sides."""
    v = torch.as_tensor(view, dtype=torch.float32).cpu()
    depth = []
    for m in models:
        o = torch.as_tensor(m, dtype=torch.float32).cpu()[:3, 3]
        depth.append(float(o[0] * v[2, 0] + o[1] * v[2, 1] + o[2] * v[2, 2] + v[2, 3]))
    return sorted(range(len(models)), key=lambda i: (-render_order[i], depth[i], i))


@torch.no_grad()
def under(frames: list[torch.Tensor]) -> torch.Tensor:
    """Front-to-back "under" composite of premultiplied frames, front first."""
    accum = torch.zeros_like(frames[0])
    for f in frames:
        accum = accum + (1.0 - accum[..., 3:4]) * f
    return accum
