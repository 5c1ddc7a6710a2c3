"""The port's trainer (``models/trainer.py``) vs the JAX package's.

Losses on the same numpy images, three Adam steps through the hand-written
backward on the same scene (JAX: Pallas kernels in interpret mode; port:
the plain versions of K1-K4 on the CPU), the official means-lr schedule
against optax's, and fits that lower the loss (tests/test_trainer.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import _torch_parity as tp  # noqa: E402
import unitygaussiansplatting_tpu.ops.rasterize_pallas as rpal  # noqa: E402
from unitygaussiansplatting_torch.models import trainer as ttr  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS, camera_from_numpy  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models import trainer as jtr  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

# tests/test_trainer.py:18-27: the camera and the lean config of the fits.
CAM = dict(eye=[0, 0.3, -2.8], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=64, height=48)
LEAN = RasterizeConfig(tile_h=8, chunk_size=32)
# Adam's first update moves every entry by lr * g / (|g| + eps), about lr
# whatever the gradient's size, and the next ones by lr * mu / sqrt(nu):
# ratios of gradients, not gradients.  An entry whose gradient is near zero
# (a splat at the edge of a pixel's discard or clip) can take another ratio
# from a rounding-level difference of its gradient.  Measured after three
# steps: every entry within 0.014 * lr of JAX's, 99.8% within 1e-5.
STEP_PARAM_TOL = 0.05  # times the group's lr, every entry
STEP_PARAM_CLOSE = 1e-5
STEP_PARAM_FRACTION = 0.99
LOSS_RTOL = 1e-6  # measured 2e-7


@pytest.fixture(scope="module")
def cameras():
    jcam = JaxCamera.look_at(**CAM)
    return jcam, camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, CAM["width"], CAM["height"])


def images(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape).astype(np.float32), rng.uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 32, 3), (48, 64, 3), (9, 13, 4)])
def test_ssim_and_loss_match_jax(shape):
    a, b = images(sum(shape), shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(ttr.ssim(ta, tb)), float(jtr.ssim(ja, jb)), rtol=0, atol=1e-6)
    assert float(ttr.ssim(ta, ta)) > 0.999
    for w in (0.0, 0.2, 1.0):
        np.testing.assert_allclose(float(ttr.photometric_loss(ta, tb, w)), float(jtr.photometric_loss(ja, jb, w)),
                                   rtol=1e-6, atol=1e-7)
    assert float(ttr.photometric_loss(ta, ta)) < 1e-6
    np.testing.assert_allclose(ttr._gaussian_window().numpy(), np.asarray(jtr._gaussian_window()), rtol=1e-6,
                               atol=1e-9)


def test_train_steps_match_jax(cameras):
    jcam, tcam = cameras
    jcfg, cfg = tp.configs(tile_h=8, chunk_size=32)
    truth = tp.jax_scene(n=300, seed=7)
    target = np.array(jrd.render(truth.activate(), jcam, JaxRenderSettings(sh_order=0), jcfg,
                                   backend="reference"))[..., :3]
    raw = tp.jax_scene(n=200, seed=8)
    lrs = dict(lr_means=1e-3, lr_rest=1e-2)

    jopt = jtr.default_optimizer(**lrs)
    jstep = jtr.make_train_step(jcam, jopt, settings=JaxRenderSettings(sh_order=0), config=jcfg, backend="pallas")
    jstate, jraw, jlosses = jopt.init(raw), raw, []
    rpal.INTERPRET = True
    try:
        for _ in range(3):
            loss, jraw, jstate = jstep(jraw, jstate, jnp.asarray(target))
            jlosses.append(float(loss))
    finally:
        rpal.INTERPRET = False

    opt = ttr.default_optimizer(**lrs)
    step = ttr.make_train_step(tcam, opt, settings=RenderSettings(sh_order=0), config=cfg, device="cpu")
    traw = tp.port_scene(raw)
    state, losses = opt.init(traw), []
    for _ in range(3):
        loss, traw, state = step(traw, state, torch.from_numpy(target))
        losses.append(float(loss))

    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for f in RAW_FIELDS:
        lr = lrs["lr_means"] if f == "means" else lrs["lr_rest"]
        got, want = getattr(traw, f).detach().numpy(), np.asarray(getattr(jraw, f))
        d = np.abs(got - want)
        assert d.max() <= STEP_PARAM_TOL * lr, (f, d.max())
        assert np.mean(d <= STEP_PARAM_CLOSE) >= STEP_PARAM_FRACTION, (f, np.mean(d <= STEP_PARAM_CLOSE))
    # sh_order=0: the SH bands get no gradient and stay where they were.
    np.testing.assert_array_equal(traw.sh.detach().numpy(), np.asarray(raw.sh))


def test_official_optimizer_groups_and_schedule():
    total = 40
    opt = ttr.official_3dgs_optimizer(scene_extent=2.0, total_steps=total)
    ref = optax.exponential_decay(init_value=1.6e-4 * 2.0, transition_steps=total, decay_rate=1.6e-6 / 1.6e-4,
                                  end_value=1.6e-6 * 2.0)
    sched = opt.lrs["means"]
    for count in (0, 1, total // 2, total, 2 * total):
        assert sched(count) == pytest.approx(float(ref(count)), rel=1e-6), count
    state = opt.init(sphere_scene(n=8, seed=0))
    lrs = {g["label"]: g["lr"] for g in state.param_groups}
    assert lrs == dict(means=pytest.approx(3.2e-4), rotations=1e-3, scales=5e-3, opacity=5e-2, sh0=2.5e-3,
                       sh_rest=2.5e-3 / 20.0)
    assert all(g["eps"] == 1e-15 for g in state.param_groups)
    assert sorted(len(g["params"]) for g in state.param_groups) == [1] * 6

    # The means lr follows the schedule update by update, from count 0.
    raw = sphere_scene(n=8, seed=0)
    state = opt.init(raw)
    for count in range(3):
        for p in (raw.means, raw.sh0):
            p.grad = torch.ones_like(p)
        opt.update(state)
        means_group = next(g for g in state.param_groups if g["label"] == "means")
        assert means_group["lr"] == pytest.approx(float(ref(count)), rel=1e-6)
        assert means_group["count"] == count + 1


def test_fit_recovers_target(cameras):
    # tests/test_trainer.py:49-69.
    _, tcam = cameras
    settings = RenderSettings(sh_order=0)
    target_raw = sphere_scene(n=120, seed=7, sh_bands=False)
    with torch.no_grad():
        target = render(target_raw.activate(), tcam, settings, LEAN, device="cpu")[..., :3]
    rng = np.random.default_rng(8)
    start = dataclasses.replace(
        target_raw,
        sh0=target_raw.sh0 + torch.from_numpy(0.7 * rng.normal(size=tuple(target_raw.sh0.shape)).astype(np.float32)),
        opacity_logits=target_raw.opacity_logits * 0.5,
    )
    before = start.sh0.clone()
    fitted, losses = ttr.fit(start, tcam, target, steps=130, settings=settings, config=LEAN, ssim_weight=0.0,
                             device="cpu")
    assert losses[-1] < losses[0] * 0.5, f"loss {losses[0]} -> {losses[-1]}"
    assert torch.equal(start.sh0, before)  # fit trains a copy


def test_fit_moves_positions(cameras):
    # tests/test_trainer.py:71-93.
    _, tcam = cameras
    settings = RenderSettings(sh_order=0)
    target_raw = sphere_scene(n=80, seed=9, sh_bands=False)
    with torch.no_grad():
        target = render(target_raw.activate(), tcam, settings, LEAN, device="cpu")[..., :3]
    start = dataclasses.replace(target_raw, means=target_raw.means + 0.05)
    one_group = ttr.GroupAdam({f: "all" for f in RAW_FIELDS}, {"all": 2e-3})  # optax.adam(2e-3)
    fitted, losses = ttr.fit(start, tcam, target, steps=50, optimizer=one_group, settings=settings,
                             config=LEAN, ssim_weight=0.0, device="cpu")
    d_before = float((start.means - target_raw.means).abs().mean())
    d_after = float((fitted.means.detach() - target_raw.means).abs().mean())
    assert losses[-1] < losses[0]
    assert d_after < d_before


def test_official_optimizer_trains():
    # tests/test_trainer.py:129-144.
    raw = sphere_scene(n=128, seed=4)
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 64, 32)
    target = torch.full((32, 64, 3), 0.25)
    opt = ttr.official_3dgs_optimizer(scene_extent=2.0, total_steps=40)
    _, losses = ttr.fit(raw, cam, target, steps=40, optimizer=opt, config=LEAN, device="cpu")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_multicam_train_step(cameras):
    _, tcam = cameras
    other = Camera.look_at([0.8, 0.3, -2.6], [0, 0, 0], [0, 1, 0], 45.0, 64, 48)
    settings = RenderSettings(sh_order=0)
    truth = sphere_scene(n=100, seed=3)
    with torch.no_grad():
        targets = [render(truth.activate(), c, settings, LEAN, device="cpu")[..., :3] for c in (tcam, other)]
    raw = sphere_scene(n=100, seed=5)
    opt = ttr.default_optimizer(lr_means=1e-3, lr_rest=2e-2)
    step = ttr.make_multicam_train_step(opt, settings=settings, config=LEAN, ssim_weight=0.0, device="cpu")
    state = opt.init(raw)
    losses = []
    for i in range(16):
        loss, raw, state = step(raw, state, (tcam, other)[i % 2], targets[i % 2])
        losses.append(float(loss))
    assert losses[-2] < losses[0] and losses[-1] < losses[1]


def test_train_step_needs_cuda_unless_told(monkeypatch, cameras):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.make_train_step(cameras[1], ttr.default_optimizer())
    with pytest.raises(ValueError, match="group"):
        ttr.GroupAdam({"means": "a"}, {"a": 1e-3})
