"""Converters between the asset pipeline's canonical splats and the
renderer's ``Gaussians`` (the port of ``unitygaussiansplatting_tpu/io/bridge.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import Gaussians
from ..utils.device import resolve_device
from .asset import InputSplats, pack_smallest3_np, unpack_smallest3_np


def input_splats_to_gaussians(s: InputSplats, device=None) -> Gaussians:
    """Decoded asset splats -> renderer-ready ``Gaussians`` on ``device``
    (CUDA unless told otherwise)."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    return Gaussians(
        means=put(s.pos),
        rotations=put(unpack_smallest3_np(s.rot)),
        scales=put(s.scale),
        opacities=put(s.opacity),
        base_color=put(s.color),
        sh=put(s.sh),
    )


def gaussians_to_input_splats(g: Gaussians) -> InputSplats:
    """Renderer ``Gaussians`` (any device) -> canonical numpy splats, for
    export and encode."""

    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    return InputSplats(
        pos=host(g.means),
        rot=pack_smallest3_np(host(g.rotations)),
        scale=host(g.scales),
        color=host(g.base_color),
        opacity=host(g.opacities),
        sh=host(g.sh),
    )
