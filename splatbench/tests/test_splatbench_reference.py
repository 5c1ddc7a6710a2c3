"""``splatbench/reference`` against the port's plain path at a small size:
the frame, the gradients of the six raw fields, one Adam step and the
Medium codec."""

import math

import numpy as np
import torch

from splatbench import poses, scenes
from splatbench.reference import asset as ref_asset
from splatbench.reference import render as ref
from splatbench.reference import train as ref_train
from unitygaussiansplatting_torch.io.device_asset import decode_device, encode_device
from unitygaussiansplatting_torch.models.camera import Camera
from unitygaussiansplatting_torch.models.gaussians import RawGaussians
from unitygaussiansplatting_torch.models.renderer import render
from unitygaussiansplatting_torch.models.trainer import GroupAdam, photometric_loss
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings

W, H, N, SEED = 192, 128, 20_000, 2**31 + 5
RING = dict(radius=5.0, height=0.4, target=[0.0, -0.2, 0.0], poses=8, step_deg=45.0)
RAS = ref.Raster(width=W, height=H, fov_y_deg=47.0)


def _camera(view) -> Camera:
    return Camera(view=torch.from_numpy(view), fov_y=math.radians(47.0), width=W, height=H)


def _program_frame(g, view):
    return render(g, _camera(view), RenderSettings(sh_order=3), RasterizeConfig(pair_multiplier=8.0), device="cpu")


def test_frame_matches_the_port():
    raw = scenes.outdoor_scene(N, SEED, "cpu")
    g = RawGaussians(**raw).activate()
    for view in poses.ring(RING)[:3]:
        work = ref.Work()
        want = ref.render(ref.activate(raw), view, RAS, work=work)
        got = _program_frame(g, view)
        assert (got - want).abs().max() < 5e-4  # the composite's exit falls at other chunk boundaries
        assert work.demand > 0 and 0 < work.kept <= work.evals <= work.demand * RAS.tile_w * RAS.tile_h


def test_medium_codec_matches_the_port_word_for_word():
    raw = scenes.outdoor_scene(N, SEED, "cpu")
    got = decode_device(encode_device(RawGaussians(**raw).activate(), device="cpu"), device="cpu")
    want = ref_asset.decode(ref_asset.encode(ref.activate(raw)))
    for k in want:
        assert torch.equal(getattr(got, k), want[k]), k
    assert encode_device(RawGaussians(**raw).activate(), device="cpu").device_bytes() == ref_asset.asset_bytes(N)


def test_gradients_and_adam_match_the_port():
    raw = scenes.outdoor_scene(N, SEED, "cpu")
    target = scenes.targets(1, W, H, SEED, "cpu")[0]
    view = poses.ring(RING)[2]
    leaves = RawGaussians(**{k: v.clone() for k, v in raw.items()})
    group = GroupAdam({f: f for f in ref_train.RAW_FIELDS}, {f: 1e-3 * (i + 1) for i, f in
                                                             enumerate(ref_train.RAW_FIELDS)}, eps=1e-15)
    opt = group.init(leaves)
    rt = _program_frame(leaves.activate(), view)
    loss = photometric_loss(rt[..., :3], target, 0.2)
    loss.backward()
    want_loss, grads = ref_train.frame_gradients(raw, view, target, RAS, [0.0, 0.0, 0.0], 0.2)
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-6
    for k in ref_train.RAW_FIELDS:
        a, b = getattr(leaves, k).grad, grads[k]
        assert (a.norm() - b.norm()).abs() <= 1e-5 * b.norm(), k
    group.update(opt)
    params = {k: v.clone() for k, v in raw.items()}
    ref_train.Adam(params, eps=1e-15).step(params, {k: getattr(leaves, k).grad for k in params},
                                           {f: 1e-3 * (i + 1) for i, f in enumerate(ref_train.RAW_FIELDS)})
    for k in params:
        assert torch.allclose(getattr(leaves, k).detach(), params[k], rtol=0, atol=1e-6), k


def test_a_splat_culled_at_depth_zero_has_no_gradient():
    """A splat whose view depth is exactly 0 takes no part in the frame: its
    gradient is nought, not NaN (the projection divides by the depth)."""
    raw = scenes.outdoor_scene(2000, SEED, "cpu")
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = 5.0  # a camera at z = -5 looking down +z: a splat at z = -5 has depth 0
    raw["means"][7] = torch.tensor([1.0, 0.5, -5.0])
    ras = ref.Raster(width=64, height=32, fov_y_deg=47.0)
    _, grads = ref_train.frame_gradients(raw, view, torch.zeros(32, 64, 3), ras, [0.0, 0.0, 0.0], 0.2)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert all(float(g[7].abs().max()) == 0.0 for g in grads.values())
