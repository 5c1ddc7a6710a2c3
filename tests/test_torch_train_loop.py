"""The port's full training loop (``models/training_loop.py``) vs the JAX package.

The five tests of tests/test_train_full.py on the port at their toy sizes
(``backend="cuda"``: the plain versions of the kernels on the CPU), then
parity with the JAX package on the same numpy inputs, ``backend="reference"``
on both sides: one ``_make_step`` (loss, the densification statistic and the
visibility counts) and ``_remap_opt_state`` on the same Adam moments.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.models import densify as tdn  # noqa: E402
from unitygaussiansplatting_torch.models import trainer as ttr  # noqa: E402
from unitygaussiansplatting_torch.models import training_loop as ttl  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render, render_with_stats  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import pair_budget  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS, camera_from_numpy  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.models import densify as jdn  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models import training_loop as jtl  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402

torch.set_num_threads(2)

SETTINGS = RenderSettings(sh_order=0)
CONFIG = RasterizeConfig(tile_h=8, chunk_size=32)
CPU = dict(device="cpu")
# One step's loss against JAX's (the same oracle render, L1 + SSIM).
LOSS_RTOL = 1e-6
# The densification statistic: the norm of each center's loss gradient
# (autograd of the oracle vs jax.grad of it), against the largest entry
# (measured 2.9e-6).
GACC_REL = 1e-4


def adam(lr):
    """The port's ``optax.adam(lr)``: one group over every field."""
    return ttr.GroupAdam({f: "all" for f in RAW_FIELDS}, {"all": lr})


def cams_targets(k=3, w=96, h=64):
    """tests/test_train_full.py:27-38 on the port."""
    truth = sphere_scene(n=500, seed=0).activate()
    cams = []
    for i in range(k):
        a = 2 * np.pi * i / k
        cams.append(Camera.look_at([3.0 * np.sin(a), 0.5, -3.0 * np.cos(a)], [0, 0, 0], [0, 1, 0], 45.0, w, h))
    with torch.no_grad():
        targets = [render(truth, c, SETTINGS, CONFIG, **CPU)[..., :3] for c in cams]
    return cams, targets


# --- tests/test_train_full.py on the port


def test_full_training_loop_improves_and_densifies(tmp_path):
    cams, targets = cams_targets()
    init = sphere_scene(n=220, seed=9)
    before = {f: getattr(init, f).clone() for f in RAW_FIELDS}
    loop = ttl.TrainLoopConfig(
        steps=120, densify_every=50, densify_from=30, densify_until=80, grad_threshold=5e-5,
        capacity_step=256, checkpoint_dir=str(tmp_path), checkpoint_every=60, ssim_weight=0.0,
    )
    p0 = ttl.psnr_of(init, cams[0], targets[0], SETTINGS, CONFIG, **CPU)
    trained, hist = ttl.train(init, cams, targets, loop, SETTINGS, CONFIG, optimizer=adam(8e-3), **CPU)
    p1 = ttl.psnr_of(trained, cams[0], targets[0], SETTINGS, CONFIG, **CPU)

    assert p1 > p0 + 0.5, f"PSNR did not improve: {p0:.2f} -> {p1:.2f}"
    counts = [c for _, c in hist["counts"]]
    assert len(counts) >= 2 and all(0 < c <= 10 * counts[0] for c in counts)
    assert any(e[1] == "densify+prune" for e in hist["events"])
    losses = hist["losses"]
    assert len(losses) == loop.steps and np.mean(losses[-10:]) < np.mean(losses[:10])
    for f in RAW_FIELDS:  # train trains a copy
        assert torch.equal(getattr(init, f), before[f]), f

    # Checkpoints exist and restore losslessly.
    assert (tmp_path / "ckpt_000060").is_file() and (tmp_path / "ckpt_000120").is_file()
    restored, step = ttl.load_checkpoint(str(tmp_path / "ckpt_final"), **CPU)
    assert step == loop.steps
    for f in RAW_FIELDS:
        assert torch.equal(getattr(restored, f), getattr(trained, f).detach()), f


def test_checkpoint_roundtrip(tmp_path, monkeypatch):
    raw = sphere_scene(n=64, seed=3)
    ttl.save_checkpoint(str(tmp_path / "c1"), raw, 7)
    back, step = ttl.load_checkpoint(str(tmp_path / "c1"), **CPU)
    assert step == 7
    for f in RAW_FIELDS:
        assert torch.equal(getattr(back, f), getattr(raw, f)), f
    # Without a GPU the loop's entry points need device="cpu".
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 32, 24)
    for call in (
        lambda: ttl.load_checkpoint(str(tmp_path / "c1")),
        lambda: ttl.psnr_of(raw, cam, torch.zeros(24, 32, 3), SETTINGS, CONFIG),
        lambda: ttl.train(raw, [cam], [torch.zeros(24, 32, 3)], ttl.TrainLoopConfig(steps=1)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_optimizer_state_survives_densify(monkeypatch):
    # The lr schedule and Adam moments carry across densification (the
    # official trainer's cat_tensors_to_optimizer).
    raw = sphere_scene(n=200, seed=7)
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 64, 48)
    target = torch.full((48, 64, 3), 0.8)
    loop = ttl.TrainLoopConfig(steps=12, densify_every=5, densify_from=1, grad_threshold=1e-7, capacity_step=256)
    opt = ttr.official_3dgs_optimizer(scene_extent=1.5, total_steps=12)
    remaps = []
    real_remap = ttl._remap_opt_state

    def remap(opt_state, src_idx, is_new, new_raw, optimizer):
        out = real_remap(opt_state, src_idx, is_new, new_raw, optimizer)
        remaps.append(([g["count"] for g in opt_state.param_groups], [g["count"] for g in out.param_groups]))
        return out

    monkeypatch.setattr(ttl, "_remap_opt_state", remap)
    out, hist = ttl.train(raw, [cam], [target], loop, RenderSettings(sh_order=1), CONFIG, optimizer=opt, **CPU)
    assert np.isfinite(hist["losses"]).all()
    assert [e[0] for e in hist["events"] if e[1] == "densify+prune"] == [5, 10]
    # Every group's update count runs on across both events.
    assert remaps == [([5] * 6, [5] * 6), ([10] * 6, [10] * 6)]


def test_overflow_recovery_grows_budget():
    # An undersized pair budget grows mid-training instead of truncating.
    cams, targets = cams_targets(k=2, w=128, h=96)
    init = sphere_scene(n=1200, seed=9)
    config = RasterizeConfig(tile_h=8, chunk_size=32, pair_multiplier=0.4)
    loop = ttl.TrainLoopConfig(
        steps=40, densify_every=15, densify_from=5, grad_threshold=5e-5, capacity_step=256,
        budget_check_every=8, ssim_weight=0.0,
    )
    trained, hist = ttl.train(init, cams, targets, loop, SETTINGS, config, optimizer=adam(8e-3), **CPU)
    grows = [e for e in hist["events"] if e[1] == "budget_grow"]
    assert grows, f"no budget_grow event: {hist['events']}"
    new_mult = grows[-1][2]["new_multiplier"]
    assert new_mult > config.pair_multiplier
    # Rendering with the grown budget no longer truncates.
    grown = dataclasses.replace(config, pair_multiplier=new_mult)
    with torch.no_grad():
        _, stats = render_with_stats(trained.activate(), cams[0], SETTINGS, grown, **CPU)
    assert not bool(stats.overflowed)
    losses = hist["losses"]
    assert np.mean(losses[-8:]) < np.mean(losses[:8])


def test_no_opacity_reset_on_final_step():
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 64, 48)
    with torch.no_grad():
        target = render(sphere_scene(n=300, seed=0).activate(), cam, SETTINGS, CONFIG, **CPU)[..., :3]
    loop = ttl.TrainLoopConfig(steps=6, densify_every=0, budget_check_every=0, opacity_reset_every=3)
    trained, hist = ttl.train(sphere_scene(n=200, seed=1), [cam], [target], loop, SETTINGS, CONFIG, **CPU)
    resets = [e for e in hist["events"] if e[1] == "opacity_reset"]
    assert [s for s, *_ in resets] == [3], resets  # step 6 (final) skipped
    # The reset reached the optimizer's own tensor: three steps later the
    # logits are still near the ceiling.
    assert float(trained.opacity_logits.detach().max()) < float(np.log(0.01 / 0.99)) + 0.05


# --- parity with the JAX package


@pytest.fixture(scope="module")
def small_views():
    """(JAX camera, port camera, numpy target) at 48x32, the target the
    oracle render of another scene."""
    w, h = 48, 32
    jcam = JaxCamera.look_at([0.3, 0.4, -1.5], [0, 0, 0], [0, 1, 0], 45.0, w, h)  # some splats off-screen
    tcam = camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, w, h)
    jcfg, _ = tp.configs(tile_h=8, chunk_size=32)
    truth = tp.jax_scene(n=90, seed=2).activate()
    target = np.array(jrd.render(truth, jcam, tp.jcfg.RenderSettings(sh_order=0), jcfg, backend="reference"))[..., :3]
    return jcam, tcam, target


def test_make_step_matches_jax(small_views):
    jcam, tcam, target = small_views
    jcfg, cfg = tp.configs(tile_h=8, chunk_size=32)
    jraw = tp.jax_scene(n=60, seed=5)
    n = jraw.means.shape[0]
    jstep = jtl._make_step(optax.adam(8e-3), tp.jcfg.RenderSettings(sh_order=0), jcfg, "reference", 0.2,
                           jcam.width, jcam.height)
    jloss, _, _, jgacc, jvis, _ = jstep(jraw, optax.adam(8e-3).init(jraw), jnp.zeros(n), jnp.zeros(n, jnp.int32),
                                         jcam, jnp.asarray(target))

    opt = adam(8e-3)
    tstep = ttl._make_step(opt, SETTINGS, cfg, "reference", 0.2, tcam.width, tcam.height, **CPU)
    traw = tp.port_scene(jraw)
    gacc, vis = torch.zeros(n), torch.zeros(n, dtype=torch.int32)
    loss, _, _, gacc2, vis2, _ = tstep(traw, opt.init(traw), gacc, vis, tcam, torch.from_numpy(target))

    assert gacc2 is gacc and vis2 is vis  # accumulated in place, on the device
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    assert 0 < int(vis.sum()) < n  # some splats off-screen
    jg = np.asarray(jgacc)
    assert jg.max() > 0 and np.all(jg[np.asarray(jvis) == 0] == 0)
    np.testing.assert_allclose(gacc.numpy(), jg, rtol=0, atol=GACC_REL * jg.max())


def test_remap_opt_state_matches_jax():
    jraw = tp.jax_scene(n=120, seed=6)
    traw = tp.port_scene(jraw)
    rng = np.random.default_rng(3)
    mu = {f: rng.normal(size=np.shape(getattr(jraw, f))).astype(np.float32) for f in RAW_FIELDS}
    nu = {f: rng.uniform(size=np.shape(getattr(jraw, f))).astype(np.float32) for f in RAW_FIELDS}

    # The same moments, three updates in, in optax's state and in torch's.
    jstate = optax.adam(8e-3).init(jraw)
    jstate = (jstate[0]._replace(count=jnp.asarray(3, jnp.int32), mu=jdn._from_np(mu), nu=jdn._from_np(nu)),
              *jstate[1:])
    gadam = adam(8e-3)
    opt = gadam.init(traw)
    opt.param_groups[0]["count"] = 3
    for f, p in zip(opt.param_groups[0]["fields"], opt.param_groups[0]["params"]):
        opt.state[p] = dict(step=torch.tensor(3.0), exp_avg=torch.from_numpy(mu[f]),
                            exp_avg_sq=torch.from_numpy(nu[f]))

    # A densify + prune + pad map.
    grads = np.abs(rng.normal(size=120)) * 1e-3
    new, src_idx, is_new = tdn.densify(traw, torch.from_numpy(grads), grad_threshold=1e-3, return_map=True)
    new, kept = tdn.prune(new, return_map=True)
    src_idx, is_new = src_idx[kept], is_new[kept]
    new = tdn.pad_to_capacity(new, 256)
    pad = 256 - src_idx.numel()
    src_idx = torch.cat([src_idx, torch.zeros(pad, dtype=torch.int64)])
    is_new = torch.cat([is_new, torch.ones(pad, dtype=torch.bool)])
    assert 0 < int(is_new[: 256 - pad].sum()) and pad > 0

    jout = jtl._remap_opt_state(jstate, src_idx.numpy(), is_new.numpy())
    tout = ttl._remap_opt_state(opt, src_idx, is_new, new, gadam)
    assert int(jout[0].count) == 3 and tout.param_groups[0]["count"] == 3
    assert [p is getattr(new, f) for f, p in zip(RAW_FIELDS, tout.param_groups[0]["params"])] == [True] * 6
    for f, p in zip(tout.param_groups[0]["fields"], tout.param_groups[0]["params"]):
        state = tout.state[p]
        assert float(state["step"]) == 3.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(), np.asarray(getattr(jout[0].mu, f)), err_msg=f)
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), np.asarray(getattr(jout[0].nu, f)), err_msg=f)
        assert not state["exp_avg"][is_new].any()


def test_group_adam_rebuild_keeps_counts():
    # A rebuilt optimizer goes on with each group's update count and lr, so
    # the means-lr schedule does not restart (it did before the port had
    # GroupAdam.init(..., like=)).
    opt = ttr.official_3dgs_optimizer(scene_extent=1.0, total_steps=10)
    raw = sphere_scene(n=16, seed=0)
    state = opt.init(raw)
    for _ in range(4):
        for f in RAW_FIELDS:
            getattr(raw, f).grad = torch.ones_like(getattr(raw, f))
        opt.update(state)
    rebuilt = opt.init(sphere_scene(n=20, seed=1), like=state)
    assert [g["count"] for g in rebuilt.param_groups] == [4] * 6
    assert [g["lr"] for g in rebuilt.param_groups] == [g["lr"] for g in state.param_groups]
    assert [g["fields"] for g in rebuilt.param_groups] == [[f] for f in RAW_FIELDS]
    fresh = opt.init(sphere_scene(n=20, seed=1))
    assert [g["count"] for g in fresh.param_groups] == [0] * 6


def test_auto_budget_sizes_the_budget(monkeypatch):
    # auto_budget_slack > 0: the worst view's demand through the port's
    # suggest_pair_multiplier sets the budget before the first step, so an
    # undersized multiplier never overflows (tests/test_train_full.py has no
    # case for it).
    cams, targets = cams_targets(k=2, w=64, h=48)
    seen = []
    real = ttl.suggest_pair_multiplier

    def suggest(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(ttl, "suggest_pair_multiplier", suggest)
    config = RasterizeConfig(tile_h=8, chunk_size=32, pair_multiplier=0.1)
    loop = ttl.TrainLoopConfig(steps=4, densify_every=0, budget_check_every=2, auto_budget_slack=1.5)
    _, hist = ttl.train(sphere_scene(n=1200, seed=9), cams, targets, loop, SETTINGS, config, **CPU)
    (mult, demand), = seen
    capacity = ttl._capacity_for(1200, loop)
    assert demand > pair_budget(capacity, config)  # the caller's budget would overflow
    assert mult == demand * 1.5 / 1200
    assert not [e for e in hist["events"] if e[1] == "budget_grow"], hist["events"]
