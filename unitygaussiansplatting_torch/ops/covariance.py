"""3D covariance, EWA screen-space projection and screen-axis decomposition.

The covariance math of GaussianSplatting.hlsl:29-108 and the 2x2
eigen-decomposition of SplatUtilities.compute:107-162: composable functions
over leading batch dims (:func:`covariance3d`, :func:`ewa_project`,
:func:`conic`, :func:`gaussian_power`), and the projection's fused form on
planar (N,) columns, which repeats them term for term.  Every product is
written out elementwise: no matrix product, so no TF32 or library summation
order enters the pixel-scale values.

Plain PyTorch, and the projection's CPU and autograd path: on CUDA tensors
that need no autograd graph ``projection.project_splats`` takes the
``project_geom`` kernel of ``csrc/project.cu`` instead, which repeats
:func:`project_covariance_planar` and :func:`_decompose` operation for
operation and equals them bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .quaternion import quat_to_rotation_matrix

# Low-pass filter on the screen covariance diagonal (hlsl:86-88).
COV2D_LOWPASS = 0.3
# View-space position clamp factor for off-screen splats (hlsl:61-68).
CLAMP_FACTOR = 1.3
# Minor eigenvalue floor / axis length cap (SplatUtilities.compute:154-158).
MIN_LAMBDA = 0.1
MAX_AXIS_LEN = 4096.0


def covariance3d(rot_xyzw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rotation quaternion + linear scale -> 3D covariance ``(xx, xy, xz, yy,
    yz, zz)`` of Sigma = (R S)(R S)^T (GaussianSplatting.hlsl:29-53)."""
    m = quat_to_rotation_matrix(rot_xyzw) * scale[..., None, :]  # R @ diag(s)
    m0, m1, m2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    return torch.stack([dot(m0, m0), dot(m0, m1), dot(m0, m2), dot(m1, m1), dot(m1, m2), dot(m2, m2)], dim=-1)


def cov3d_to_matrix(cov6: torch.Tensor) -> torch.Tensor:
    """Packed 6-vector -> symmetric (..., 3, 3) matrix."""
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)
    return torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1), torch.stack([xz, yz, zz], -1)], dim=-2
    )


def ewa_project(
    view_pos: torch.Tensor,
    cov6: torch.Tensor,
    view_rot: torch.Tensor,
    focal: float,
    tan_fovx: float,
    tan_fovy: float,
) -> torch.Tensor:
    """EWA splatting (Zwicker et al. 2002, eq. 31) as the reference does it
    (GaussianSplatting.hlsl:56-90): the view position clamped to 1.3x the
    frustum tangent, the 2x3 Jacobian with one focal length, the world->view
    rotation ``view_rot`` ((3, 3) or (..., 3, 3)) folded in, the 0.3 low-pass.
    Returns pixel-space (y-down) ``(cxx, cxy, cyy)``: the off-diagonal's sign
    is flipped against the y-up NDC result."""
    z = view_pos[..., 2]
    lim_x = CLAMP_FACTOR * tan_fovx
    lim_y = CLAMP_FACTOR * tan_fovy
    tx = torch.clamp(view_pos[..., 0] / z, -lim_x, lim_x) * z
    ty = torch.clamp(view_pos[..., 1] / z, -lim_y, lim_y) * z
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    j00 = focal * inv_z
    j02 = -focal * tx * inv_z2
    j12 = -focal * ty * inv_z2
    w = view_rot.expand(view_pos.shape[:-1] + (3, 3))
    t0 = j00[..., None] * w[..., 0, :] + j02[..., None] * w[..., 2, :]
    t1 = j00[..., None] * w[..., 1, :] + j12[..., None] * w[..., 2, :]
    vxx, vxy, vxz, vyy, vyz, vzz = cov6.unbind(-1)

    def quad(a, b):
        return (
            a[..., 0] * (vxx * b[..., 0] + vxy * b[..., 1] + vxz * b[..., 2])
            + a[..., 1] * (vxy * b[..., 0] + vyy * b[..., 1] + vyz * b[..., 2])
            + a[..., 2] * (vxz * b[..., 0] + vyz * b[..., 1] + vzz * b[..., 2])
        )

    return torch.stack([quad(t0, t0) + COV2D_LOWPASS, -quad(t0, t1), quad(t1, t1) + COV2D_LOWPASS], dim=-1)


def conic(cov2d: torch.Tensor) -> torch.Tensor:
    """2D covariance ``(cxx, cxy, cyy)`` -> conic ``(a, b, c)``, the inverse
    (GaussianSplatting.hlsl:92-96)."""
    cxx, cxy, cyy = cov2d.unbind(-1)
    inv_det = 1.0 / (cxx * cyy - cxy * cxy)
    return torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)


def gaussian_power(conic_abc: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Log-density of the screen Gaussian at pixel offset ``d``
    (GaussianSplatting.hlsl:105-108)."""
    a, b, c = conic_abc.unbind(-1)
    dx, dy = d[..., 0], d[..., 1]
    return -0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy


class ScreenAxes(NamedTuple):
    axis1: torch.Tensor  # (..., 2) major axis, length sqrt(2*lambda1) px
    axis2: torch.Tensor  # (..., 2) minor axis, length sqrt(2*lambda2) px


def decompose_covariance2d(cov2d: torch.Tensor) -> ScreenAxes:
    """Eigen-decompose a pixel-space 2D covariance ``(cxx, cxy, cyy)`` into
    screen axes (the antimatter15/splat closed form,
    SplatUtilities.compute:147-159)."""
    cxx, cxy, cyy = cov2d.unbind(-1)
    axis1, axis2 = _decompose(cxx, cxy, cyy)
    return ScreenAxes(axis1, axis2)


def _decompose(cxx, cxy, cyy):
    mid = 0.5 * (cxx + cyy)
    # Floors inside the square roots keep gradients finite for isotropic
    # covariances; they shift values by at most 1e-12.
    radius = torch.sqrt(
        torch.clamp(((cxx - cyy) * 0.5) * ((cxx - cyy) * 0.5) + cxy * cxy, min=1e-24)
    )
    lam1 = mid + radius
    lam2 = torch.clamp(mid - radius, min=MIN_LAMBDA)
    vx = cxy
    vy = lam1 - cxx
    norm = torch.sqrt(torch.clamp(vx * vx + vy * vy, min=1e-30))
    ok = norm > 1e-12
    nrm = torch.clamp(norm, min=1e-12)
    vxn = torch.where(ok, vx / nrm, 1.0)
    vyn = torch.where(ok, vy / nrm, 0.0)
    len1 = torch.clamp(torch.sqrt(2.0 * lam1), max=MAX_AXIS_LEN)
    len2 = torch.clamp(torch.sqrt(2.0 * lam2), max=MAX_AXIS_LEN)
    axis1 = torch.stack([len1 * vxn, len1 * vyn], dim=-1)
    axis2 = torch.stack([len2 * vyn, -(len2 * vxn)], dim=-1)
    return axis1, axis2


def project_covariance_planar(
    rot_xyzw: torch.Tensor,  # (N, 4)
    scale: torch.Tensor,  # (N, 3)
    splat_scale2,  # scalar cov scale factor
    view_pos: torch.Tensor,  # (N, 3)
    view_rot: torch.Tensor,  # (3, 3) world->view rotation
    focal: float,
    tan_fovx: float,
    tan_fovy: float,
) -> tuple[ScreenAxes, torch.Tensor]:
    """covariance3d -> ewa_project -> decompose on planar columns.

    Returns (ScreenAxes, cov2d (N, 3) pixel-space ``(cxx, cxy, cyy)``).
    """
    x, y, z, w = rot_xyzw.unbind(-1)
    s0, s1, s2 = scale.unbind(-1)
    # R rows (GaussianSplatting.hlsl:36-44).
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    # M = R diag(s); Sigma = M M^T, scaled by splat_scale^2.
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    vxx = (m00 * m00 + m01 * m01 + m02 * m02) * splat_scale2
    vxy = (m00 * m10 + m01 * m11 + m02 * m12) * splat_scale2
    vxz = (m00 * m20 + m01 * m21 + m02 * m22) * splat_scale2
    vyy = (m10 * m10 + m11 * m11 + m12 * m12) * splat_scale2
    vyz = (m10 * m20 + m11 * m21 + m12 * m22) * splat_scale2
    vzz = (m20 * m20 + m21 * m21 + m22 * m22) * splat_scale2

    # EWA Jacobian with the 1.3x frustum clamp (hlsl:56-90).
    zc = view_pos[..., 2]
    lim_x = CLAMP_FACTOR * tan_fovx
    lim_y = CLAMP_FACTOR * tan_fovy
    tx = torch.clamp(view_pos[..., 0] / zc, -lim_x, lim_x) * zc
    ty = torch.clamp(view_pos[..., 1] / zc, -lim_y, lim_y) * zc
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00 = focal * inv_z
    j02 = -focal * tx * inv_z2
    j12 = -focal * ty * inv_z2
    vr = view_rot
    t00 = j00 * vr[0, 0] + j02 * vr[2, 0]
    t01 = j00 * vr[0, 1] + j02 * vr[2, 1]
    t02 = j00 * vr[0, 2] + j02 * vr[2, 2]
    t10 = j00 * vr[1, 0] + j12 * vr[2, 0]
    t11 = j00 * vr[1, 1] + j12 * vr[2, 1]
    t12 = j00 * vr[1, 2] + j12 * vr[2, 2]

    def quad(a0, a1, a2, b0, b1, b2):
        return (
            a0 * (vxx * b0 + vxy * b1 + vxz * b2)
            + a1 * (vxy * b0 + vyy * b1 + vyz * b2)
            + a2 * (vxz * b0 + vyz * b1 + vzz * b2)
        )

    cxx = quad(t00, t01, t02, t00, t01, t02) + COV2D_LOWPASS
    cyy = quad(t10, t11, t12, t10, t11, t12) + COV2D_LOWPASS
    cxy = -quad(t00, t01, t02, t10, t11, t12)  # y-up NDC -> y-down pixels

    axis1, axis2 = _decompose(cxx, cxy, cyy)
    return ScreenAxes(axis1, axis2), torch.stack([cxx, cxy, cyy], dim=-1)
