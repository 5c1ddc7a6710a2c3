"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy arrays: the JAX package's numpy
``sphere_scene`` goes through ``unitygaussiansplatting_torch.utils.convert``.
"""

import dataclasses

import numpy as np

from unitygaussiansplatting_torch.models.gaussians import Gaussians as TorchGaussians
from unitygaussiansplatting_torch.ops.projection import ProjectedSplats as TorchProjected
from unitygaussiansplatting_torch.utils import config as tcfg
from unitygaussiansplatting_torch.utils.convert import camera_from_numpy, raw_gaussians_from_numpy
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera
from unitygaussiansplatting_tpu.ops import projection as jax_types
from unitygaussiansplatting_tpu.utils import config as jcfg
from unitygaussiansplatting_tpu.utils.synthetic import sphere_scene

import torch

SCENE_N = 1500
SCENE_SEED = 0
WIDTH, HEIGHT = 192, 128  # the scene and camera of tests/test_pallas.py:16-26
CAMERA = dict(eye=[0, 0.5, -3.0], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0)

# The bench's headline configuration (bench.py:511-525).
HEADLINE = dict(
    pair_multiplier=4.0, chunk_size=256, pack_axes_u32=True, pack_grads_bf16=True,
    pack_center_u32=True, pack_color_rgba8=True,
)
# tests/test_pallas.py:29-37, :88-99, the headline; name -> RasterizeConfig kwargs.
CONFIGS = {
    "default": {},
    "small-tiles": dict(tile_h=8, chunk_size=64),
    "small-expand-chunk": dict(pair_multiplier=6.0, expand_chunk=128),
    "axes-f16": dict(pack_axes_f16=True),
    "color-rgba8": dict(pack_color_rgba8=True),
    "axes+rgba8": dict(pack_axes_f16=True, pack_color_rgba8=True),
    "axes-u32": dict(pack_axes_u32=True),
    "axes-u32+rgba8": dict(pack_axes_u32=True, pack_color_rgba8=True),
    "headline": HEADLINE,
}
# A K1 checkpoint segment longer than any tile's walk at these sizes: K3 from
# such checkpoints walks each tile whole, from T = 1 and a zero prefix.
WHOLE_TILE_STEPS = 1 << 20


def configs(**kw):
    """(JAX RasterizeConfig, port RasterizeConfig) with the same fields."""
    return jcfg.RasterizeConfig(**kw), tcfg.RasterizeConfig(**kw)


def raw_arrays(raw) -> dict:
    return {f.name: np.asarray(getattr(raw, f.name)) for f in dataclasses.fields(raw)}


def jax_scene(n=SCENE_N, seed=SCENE_SEED):
    """The JAX package's numpy RawGaussians."""
    return sphere_scene(n=n, seed=seed)


def port_scene(raw):
    return raw_gaussians_from_numpy(raw_arrays(raw))


def port_cloud(jg):
    """The port's Gaussians holding a JAX ``Gaussians``' values (both packages
    then start from the same activated cloud)."""
    return TorchGaussians(**{f.name: torch.from_numpy(np.array(getattr(jg, f.name))) for f in dataclasses.fields(jg)})


def cameras(width=WIDTH, height=HEIGHT):
    """(JAX Camera, port Camera) built from the same view matrix."""
    jcam = JaxCamera.look_at(width=width, height=height, **CAMERA)
    return jcam, camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, width, height)


def proj_to_torch(jproj) -> TorchProjected:
    """The port's ProjectedSplats holding the JAX projection's values."""
    return TorchProjected(
        **{name: torch.from_numpy(np.array(getattr(jproj, name))) for name in TorchProjected._fields}
    )


def within_fraction(got, want, atol):
    """Fraction of entries with |got - want| <= atol."""
    return float(np.mean(np.abs(np.asarray(got) - np.asarray(want)) <= atol))


def saturating_projection(n=300, seed=7):
    """Big, nearly opaque splats stacked over the whole 192x128 frame: most
    tiles saturate part-way through their pairs, so the per-tile early exit
    decides what is composited."""
    rng = np.random.default_rng(seed)
    radius = rng.uniform(20.0, 40.0, n).astype(np.float32)
    theta = rng.uniform(0.0, np.pi, n).astype(np.float32)
    a1 = np.stack([np.cos(theta), np.sin(theta)], -1) * radius[:, None]
    a2 = np.stack([np.sin(theta), -np.cos(theta)], -1) * (0.8 * radius)[:, None]
    center = rng.uniform([0, 0], [WIDTH, HEIGHT], (n, 2)).astype(np.float32)
    return jax_types.ProjectedSplats(
        depth=rng.uniform(1.0, 2.0, n).astype(np.float32), center=center,
        axis1=a1.astype(np.float32), axis2=a2.astype(np.float32),
        conic=np.zeros((n, 3), np.float32), color=rng.uniform(0.0, 1.5, (n, 3)).astype(np.float32),
        opacity=rng.uniform(0.8, 0.99, n).astype(np.float32), valid=np.ones(n, bool),
    )
