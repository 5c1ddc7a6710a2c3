"""Export and merge of splat clouds.

The reference's export kernel with its optional world-transform bake, SH
rotation included (``CSExportData``, SplatUtilities.compute:616-673,
549-609), the PLY writer's deleted/cut filter
(GaussianSplatRendererEditor.cs:394-445), and the merge of several renderers
(GaussianSplatRendererEditor.cs:169-235 + ``CSCopySplats`` compute:686-758).
The cloud stays on its device; only the (4, 4) matrix is read on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.gaussians import Gaussians
from ..ops.projection import affine
from ..ops.quaternion import quat_mul, quat_normalize
from ..ops.sh import rotate_sh


def _matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> xyzw quaternion (host numpy, for the bake)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s, 0.25 * s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1e-12, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def bake_transform(g: Gaussians, matrix) -> Gaussians:
    """Bake an object->world transform (4, 4) into the cloud.

    The export kernel's world-space bake (compute:645-658): positions through
    the full matrix, orientations composed with its rotation part, scales
    times the axis lengths, SH rotated to the new frame.  Non-uniform scale
    is approximated per axis, as the reference does.
    """
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    m = np.asarray(matrix, np.float32)
    rot3 = m[:3, :3]
    axis_scales = np.linalg.norm(rot3, axis=0)  # length of each basis column
    rot_pure = rot3 / axis_scales[None, :]
    q = _matrix_to_quat_np(rot_pure).astype(np.float32)

    dev = g.means.device

    def put(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    rotations = quat_normalize(quat_mul(torch.broadcast_to(put(q), g.rotations.shape), g.rotations))
    return dataclasses.replace(
        g,
        means=affine(g.means, put(m)),
        rotations=rotations,
        scales=g.scales * put(axis_scales),
        sh=rotate_sh(g.sh, put(rot_pure)),
    )


def export_gaussians(
    g: Gaussians,
    deleted: torch.Tensor | None = None,
    kill_mask: torch.Tensor | None = None,
    bake_matrix=None,
) -> Gaussians:
    """Drop deleted/cut splats and optionally bake a world transform.

    The result feeds ``io.bridge.gaussians_to_input_splats`` +
    ``io.ply.write_ply``: the analog of EditExportData + ExportPlyFile.
    """
    keep = torch.ones(g.num_splats, dtype=torch.bool, device=g.means.device)
    if deleted is not None:
        keep &= ~deleted
    if kill_mask is not None:
        keep &= ~kill_mask
    idx = torch.nonzero(keep).squeeze(1)
    filtered = Gaussians(**{f.name: getattr(g, f.name).index_select(0, idx) for f in dataclasses.fields(g)})
    if bake_matrix is not None:
        filtered = bake_transform(filtered, bake_matrix)
    return filtered


def merge_gaussians(clouds: list[Gaussians], matrices: list | None = None) -> Gaussians:
    """Concatenate clouds, baking each one's transform first where given
    (MergeSplatObjects, GaussianSplatRendererEditor.cs:169-235)."""
    if matrices is not None:
        clouds = [bake_transform(g, m) if m is not None else g for g, m in zip(clouds, matrices)]
    return Gaussians(**{f.name: torch.cat([getattr(g, f.name) for g in clouds]) for f in dataclasses.fields(Gaussians)})
