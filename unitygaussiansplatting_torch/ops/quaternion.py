"""Quaternion helpers for splat orientation (GaussianUtils.cs:40-76,
GaussianSplatting.hlsl:36-44,219-229).

Quaternions are stored ``(x, y, z, w)``, the reference's layout after
``NormalizeSwizzleRotation`` converts PLY's wxyz storage.
"""

from __future__ import annotations

import torch

_SQRT2 = 1.4142135623730951


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis.

    The norm is floored inside the sqrt, so a zero quaternion gives finite
    gradients.
    """
    norm = torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=eps * eps))
    return q / norm


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of xyzw quaternions (GaussianSplatting.hlsl:19-22)."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse (conjugate / |q|^2) of xyzw quaternions (hlsl:24-27)."""
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    conj = q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)
    return conj / norm2


def quat_rotate_vector(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors by xyzw quaternions (hlsl:13-17); leading dims
    broadcast."""
    qv, v = torch.broadcast_tensors(q[..., :3], v)
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def normalize_swizzle_rotation(wxyz: torch.Tensor) -> torch.Tensor:
    """PLY-order (w, x, y, z) -> normalized (x, y, z, w) (GaussianUtils.cs:40-43)."""
    q = quat_normalize(wxyz)
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> (..., 3, 3) rotation matrix (GaussianSplatting.hlsl:36-44)."""
    x, y, z, w = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


# The pack swizzle: the three components kept when index i is the largest.
_SMALLEST3_ORDER = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def pack_smallest3(q: torch.Tensor) -> torch.Tensor:
    """Pack xyzw quaternions into "smallest three" (..., 4) in [0, 1]
    (GaussianUtils.cs:46-76).

    The three smallest components land in xyz mapped to 0..1 and w holds
    ``largest_index / 3``.  ``torch.argmax`` keeps the first index on ties,
    the reference's if-chain tie-break.
    """
    idx = torch.argmax(torch.abs(q), dim=-1)
    order = torch.tensor(_SMALLEST3_ORDER, dtype=torch.int64, device=q.device)
    three = torch.gather(q, -1, order[idx])
    largest = torch.gather(q, -1, idx[..., None])
    sign = torch.where(largest >= 0, 1.0, -1.0)
    three = three * sign
    three = three * _SQRT2 * 0.5 + 0.5
    return torch.cat([three, idx[..., None].to(q.dtype) / 3.0], dim=-1)


def unpack_smallest3(pq: torch.Tensor) -> torch.Tensor:
    """Decode "smallest three" [0, 1]^4 back to xyzw (GaussianSplatting.hlsl:219-229).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The 1e-24
    floor inside the sqrt keeps gradients finite when the three stored
    components already have unit norm.
    """
    idx = torch.round(pq[..., 3] * 3.0).to(torch.int32)
    three = pq[..., :3] * _SQRT2 - (1.0 / _SQRT2)
    largest = torch.sqrt(torch.clamp(1.0 - torch.sum(three * three, dim=-1), min=1e-24))
    a, b, c = three.unbind(-1)
    x = torch.where(idx == 0, largest, a)
    y = torch.where(idx == 1, largest, torch.where(idx == 0, a, b))
    z = torch.where(idx == 2, largest, torch.where(idx <= 1, b, c))
    w = torch.where(idx == 3, largest, c)
    return torch.stack([x, y, z, w], dim=-1)
