"""The port's user-facing programs (``unitygaussiansplatting_torch.examples``
and ``.tools``) vs the JAX package, on the CPU at small sizes.

The JAX scripts under ``examples/`` and ``tools/`` hard-code their sizes, so
the JAX side is built from the JAX package's functions with each script's
own construction (scene, camera, background, settings, config) at a reduced
size; module-level helpers of the scripts (``ring_cameras``, ``parse_args``,
the tools' functions) are loaded from the files.  The port's side is each
program's own ``run``/``main``.  Backends map ``"torch"`` <-> ``"jax"`` and
``"cuda"`` (plain versions of the kernels on the CPU) <-> ``"pallas"``
(interpret mode).  Image bars: tests/test_torch_render.py's for the default
config (max 5e-3, >= 99.9% of channels within 1e-4).
"""

import ast
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_render import E2E_ATOL, E2E_FRACTION, E2E_MAX  # noqa: E402
from unitygaussiansplatting_torch.examples import orbit, render_asset, render_sphere, train_full, train_splats  # noqa: E402
from unitygaussiansplatting_torch.io import bridge as tbr  # noqa: E402
from unitygaussiansplatting_torch.io import ply as tply  # noqa: E402
from unitygaussiansplatting_torch.models import trainer as ttr  # noqa: E402
from unitygaussiansplatting_torch.models import training_loop as ttl  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.training_loop import load_checkpoint, psnr_of  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import tile_grid  # noqa: E402
from unitygaussiansplatting_torch.tools import measure_bc7, measure_overlap  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import captured_scene, sphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.io import asset as jas  # noqa: E402
from unitygaussiansplatting_tpu.io import bridge as jbr  # noqa: E402
from unitygaussiansplatting_tpu.io import creator as jcr  # noqa: E402
from unitygaussiansplatting_tpu.io import device_asset as jda  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models import trainer as jtr  # noqa: E402
from unitygaussiansplatting_tpu.models import training_loop as jtl  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.ops import binning as jbin  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402
from unitygaussiansplatting_tpu.utils import synthetic as jsyn  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RasterizeConfig as JaxConfig  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxSettings  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
# render_sphere and orbit at a reduced size, SH3.
SMALL_N, SMALL_W, SMALL_H = 500, 96, 64
# The port's backend and the JAX package's that computes the same function.
BACKENDS = [("torch", "jax"), ("cuda", "pallas")]
# train_splats: the first loss as tests/test_torch_trainer.py's LOSS_RTOL
# (measured 2e-7 there); steps 2-3 looser, because Adam's division
# amplifies ulps of the gradients.
LOSS_RTOL = 1e-6
LATER_LOSS_RTOL = 1e-5
# train_full: the r5 ring's geometry (examples/train_full.py:113-121).
R5_RING = dict(radius=9.0, width=800, height=500, height_off=2.0, fov=47.0, target=(0.0, 0.3, 0.0))
PROGRAMS = {
    "examples.render_sphere": ["out.png"], "examples.orbit": ["out"], "examples.render_asset": ["in.ply", "o.png"],
    "examples.train_splats": ["out"], "examples.train_full": [], "tools.measure_overlap": [],
}


def load_script(relpath: str):
    """A JAX script of the repo, imported from its file."""
    spec = importlib.util.spec_from_file_location("jax_" + Path(relpath).stem, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_train_full():
    return load_script("examples/train_full.py")


def assert_image_close(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= E2E_MAX, d.max()
    assert np.mean(d <= E2E_ATOL) >= E2E_FRACTION["default"], np.mean(d <= E2E_ATOL)


def views_close(port_cam, jax_cam, atol=1e-6):
    np.testing.assert_allclose(port_cam.view.numpy(), np.asarray(jax_cam.view), rtol=0, atol=atol)


# --- render_sphere, orbit ---------------------------------------------------


@pytest.mark.parametrize("backend,jax_backend", BACKENDS)
def test_render_sphere_matches_jax(backend, jax_backend):
    # examples/render_sphere.py:41-49 at n=500, 96x64.
    got = render_sphere.run(n=SMALL_N, width=SMALL_W, height=SMALL_H, frames=1, backend=backend, **CPU)
    jcam = JaxCamera.look_at(eye=[0.0, 0.8, -3.2], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=SMALL_W,
                             height=SMALL_H)
    views_close(render_sphere.camera(SMALL_W, SMALL_H), jcam)
    want = jrd.render_over_background(jsyn.sphere_scene(n=SMALL_N, seed=0).activate(), jcam,
                                      background=jnp.asarray([0.1, 0.1, 0.12]),
                                      settings=JaxSettings(sh_order=3), backend=jax_backend)
    assert got["img"].shape == (SMALL_H, SMALL_W, 3)
    assert_image_close(got["img"], want)
    assert 0.0 < got["mean"] < 1.0


def jax_orbit_view(center, radius, theta, width, height):
    # examples/orbit.py:135-143.
    eye = center + radius * np.asarray([np.sin(theta), 0.2, -np.cos(theta)], np.float32)
    return JaxCamera.look_at(eye=eye, target=center, up=[0, 1, 0], fov_y_deg=47.0, width=width, height=height).view


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0), (0.7, -0.2, 1.3)])
def test_orbit_poses_match_jax(center):
    center = np.asarray(center, np.float32)
    cams = orbit.orbit_cameras(center, 3.0, 12, 512, 384)
    assert len(cams) == 12
    for i, cam in enumerate(cams):
        want = jax_orbit_view(center, 3.0, 2.0 * np.pi * i / 12, 512, 384)
        np.testing.assert_allclose(cam.view.numpy(), np.asarray(want), rtol=0, atol=1e-6, err_msg=str(i))
        assert (cam.width, cam.height, cam.fov_y) == (512, 384, math.radians(47.0))


@pytest.mark.parametrize("backend,jax_backend", BACKENDS)
def test_orbit_frame_matches_jax(backend, jax_backend, tmp_path):
    # examples/orbit.py:117-133, 145-150: the last of 3 frames, written as a PNG.
    frames = 3
    got = orbit.run(str(tmp_path), n=SMALL_N, frames=frames, width=SMALL_W, height=SMALL_H, backend=backend, **CPU)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"orbit_{i:04d}.png" for i in range(frames)]
    assert len(got["device_ms"]) == frames
    center = np.zeros(3, np.float32)
    base = JaxCamera.look_at(eye=center + np.asarray([0.0, 0.6, -3.0], np.float32), target=center, up=[0, 1, 0],
                             fov_y_deg=47.0, width=SMALL_W, height=SMALL_H)
    cam = dataclasses.replace(base, view=jax_orbit_view(center, 3.0, 2.0 * np.pi * (frames - 1) / frames, SMALL_W,
                                                        SMALL_H))
    want = jrd.render(jsyn.sphere_scene(n=SMALL_N, seed=0).activate(), cam, JaxSettings(sh_order=3), JaxConfig(),
                      backend=jax_backend)
    assert got["frame"].shape == (SMALL_H, SMALL_W, 4)
    assert_image_close(got["frame"], want)


def test_orbit_renders_a_ply_as_it_is(tmp_path):
    # The JAX script's --ply path calls .activate() on Gaussians, which has
    # none; the port renders the imported cloud around its mean.
    g = sphere_scene(n=300, seed=2).activate()
    path = tmp_path / "scene.ply"
    tply.write_ply(str(path), tbr.gaussians_to_input_splats(g))
    got = orbit.run(None, ply=str(path), frames=2, width=48, height=32, **CPU)
    cloud, center = orbit.load_cloud(str(path), 0, torch.device("cpu"))
    np.testing.assert_array_equal(center, cloud.means.numpy().mean(axis=0))
    assert np.isfinite(got["frame"]).all() and got["frame"][..., 3].max() > 0.0
    assert not hasattr(jbr.input_splats_to_gaussians(tbr.gaussians_to_input_splats(g)), "activate")


# --- render_asset -----------------------------------------------------------


def look_at_camera_json(folder: Path, eye, target):
    """A 3DGS cameras.json with one camera at ``eye`` looking at ``target``
    (rotation columns: right, down, forward)."""
    view = Camera.look_at(eye, target, [0, 1, 0], 47.0, 8, 8).view.numpy()
    right, up, fwd = view[0, :3], view[1, :3], view[2, :3]
    rot = np.stack([right, -up, fwd], axis=1)
    (folder / "cameras.json").write_text(json.dumps([{"id": 0, "position": list(map(float, eye)),
                                                      "rotation": rot.tolist()}]))


@pytest.fixture(scope="module")
def asset_scene(tmp_path_factory):
    """A 2000-splat captured-statistics PLY beside a cameras.json, and the
    JAX package's Medium asset of it, saved as .asset.json."""
    folder = tmp_path_factory.mktemp("asset_scene")
    ply = folder / "scene.ply"
    tply.write_ply(str(ply), tbr.gaussians_to_input_splats(captured_scene(n=2000, seed=3).activate()))
    look_at_camera_json(folder, [4.0, 1.5, -6.0], [0.0, 0.3, 0.0])
    jasset = jcr.create_asset(str(ply), output_folder=str(folder / "jax"), quality="medium")
    return ply, jasset, folder / "jax" / "scene.asset.json"


@pytest.mark.parametrize("camera", [0, None])
def test_render_asset_matches_jax(asset_scene, camera):
    ply, jasset, _ = asset_scene
    size = dict(width=SMALL_W, height=SMALL_H)
    dev = render_asset.run(str(ply), quality="medium", camera=camera, **size, **CPU)
    host = render_asset.run(str(ply), quality="medium", camera=camera, host_decode=True, **size, **CPU)
    for blob in ("chunk_blob", "pos_blob", "other_blob", "color_blob", "sh_blob"):
        assert getattr(dev["asset"], blob) == getattr(jasset, blob), blob
    assert dev["asset"].cameras == jasset.cameras and len(jasset.cameras) == 1
    if camera is None:  # examples/render_asset.py:227-230
        center = (jasset.bounds_min + jasset.bounds_max) / 2
        extent = float(np.linalg.norm(jasset.bounds_max - jasset.bounds_min))
        eye = center + np.array([0.0, 0.25 * extent, -0.9 * extent], np.float32)
        jcam = JaxCamera.look_at(eye, center, [0, 1, 0], 47.0, SMALL_W, SMALL_H)
    else:
        jcam = JaxCamera.from_camera_info(jasset.cameras[camera], SMALL_W, SMALL_H, 47.0)
    views_close(dev["camera"], jcam, atol=0)
    settings = JaxSettings(sh_order=3)
    jdev = jrd.render_over_background(jda.device_asset_from_asset(jasset), jcam, jnp.zeros(3), settings=settings,
                                      backend="pallas")
    jhost = jrd.render_over_background(jbr.input_splats_to_gaussians(jas.decode_asset(jasset)), jcam, jnp.zeros(3),
                                       settings=settings, backend="pallas")
    assert_image_close(dev["img"], jdev)
    assert_image_close(host["img"], jhost)
    assert not dev["overflow"] and not host["overflow"]
    assert float(dev["img"].mean()) > 0.0


def test_render_asset_loads_a_saved_asset(asset_scene, tmp_path):
    # The JAX package's saved .asset.json, through the port's main: the same
    # asset bytes, so the frame of the imported PLY bit for bit.
    ply, _, saved = asset_scene
    size = ["--width", str(SMALL_W), "--height", str(SMALL_H), "--camera", "0", "--device", "cpu"]
    got = render_asset.main([str(saved), str(tmp_path / "saved.png"), *size])
    want = render_asset.main([str(ply), str(tmp_path / "ply.png"), *size])
    assert torch.equal(got["img"], want["img"])
    assert (tmp_path / "saved.png").read_bytes() == (tmp_path / "ply.png").read_bytes()
    with pytest.raises(ValueError, match="backend"):
        render_asset.run(str(saved), backend="pallas", **CPU)


# --- train_splats -----------------------------------------------------------


def jax_start(target_raw):
    # examples/train_splats.py:286-291.
    rng = np.random.default_rng(1)
    return dataclasses.replace(
        target_raw,
        means=target_raw.means + 0.03 * rng.normal(size=target_raw.means.shape).astype(np.float32),
        sh0=target_raw.sh0 + 0.5 * rng.normal(size=target_raw.sh0.shape).astype(np.float32),
    )


def test_train_splats_start_is_jax_bit_for_bit():
    got = train_splats.start_cloud(sphere_scene(n=2000, seed=0))
    want = jax_start(jsyn.sphere_scene(n=2000, seed=0))
    for f in RAW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_train_splats_steps_match_jax():
    n, w, h, steps = 300, 64, 48, 3
    got = train_splats.run(None, n=n, width=w, height=h, steps=steps, backend="torch", **CPU)
    # examples/train_splats.py:275-302 at n=300, 64x48, the package's default backend ("jax").
    cam = JaxCamera.look_at(eye=[0, 0.5, -3.0], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=w, height=h)
    settings = JaxSettings(sh_order=1)
    config = JaxConfig(tile_h=8, chunk_size=64, max_pairs_per_tile=2048)
    target_raw = jsyn.sphere_scene(n=n, seed=0)
    target = jrd.render(target_raw.activate(), cam, settings, config)[..., :3]
    raw = jax_start(target_raw)
    opt = jtr.default_optimizer(lr_means=2e-3, lr_rest=5e-3)
    step = jtr.make_train_step(cam, opt, settings, config, ssim_weight=0.2)
    state, losses = opt.init(raw), []
    for _ in range(steps):
        loss, raw, state = step(raw, state, target)
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][1:], losses[1:], rtol=LATER_LOSS_RTOL)


def test_train_splats_cuda_backend_improves():
    got = train_splats.run(None, n=300, width=64, height=48, steps=20, **CPU)
    assert len(got["losses"]) == 20 and all(np.isfinite(got["losses"]))
    assert got["fitted_psnr"] > got["start_psnr"], (got["start_psnr"], got["fitted_psnr"])


# --- train_full -------------------------------------------------------------


def ring_angle(cam) -> float:
    """The angle of a ring camera about the vertical axis, from its eye."""
    view = np.asarray(cam.view, np.float64)
    eye = -view[:3, :3].T @ view[:3, 3]
    return math.atan2(eye[0], -eye[2])


def min_angular_gap(held, train) -> float:
    gaps = [abs(math.remainder(ring_angle(h) - ring_angle(t), 2 * math.pi)) for h in held for t in train]
    return min(gaps, default=math.inf)


@pytest.mark.parametrize("views,held_out", [(24, 4), (6, 3), (8, 8), (6, 0)])
def test_train_full_cameras(jax_train_full, views, held_out):
    ring = dict(R5_RING)
    args = (ring.pop("radius"), ring.pop("width"), ring.pop("height"))
    train = train_full.ring_cameras(views, *args, **ring)
    jtrain = jax_train_full.ring_cameras(views, *args, **ring)
    for cam, jcam in zip(train, jtrain, strict=True):
        views_close(cam, jcam)
    held = train_full.held_out_cameras(views, held_out, *args, ring["height_off"], ring["fov"], ring["target"])
    assert len(held) == held_out
    # Each held-out camera sits at a midpoint: half a ring step from the nearest training camera.
    assert min_angular_gap(held, train) >= math.pi / views - 1e-6
    assert len({round(ring_angle(c), 9) for c in held}) == held_out


def test_jax_r5_held_out_cameras_are_training_cameras(jax_train_full):
    # The fault the port does not copy (examples/train_full.py:124-126): the
    # check above fails on the JAX script's r5 placement.
    ring = dict(R5_RING)
    args = (ring.pop("radius"), ring.pop("width"), ring.pop("height"))
    train = jax_train_full.ring_cameras(24, *args, **ring)
    held = jax_train_full.ring_cameras(4, *args, **ring, phase=0.5)[:4]
    assert min_angular_gap(held, train) < 1e-6


@pytest.mark.parametrize("preset", ["quick", "r5"])
def test_train_full_presets_match_jax(jax_train_full, preset):
    got = train_full.parse_args(["--preset", preset])
    want = jax_train_full.parse_args(["--preset", preset])
    backend = {"jax": "torch", "pallas": "cuda"}
    assert set(train_full.PRESETS[preset]) | {"preset"} <= set(vars(want))
    for key in train_full.PRESETS[preset]:
        expected = backend[want.backend] if key == "backend" else getattr(want, key)
        assert getattr(got, key) == expected, key
    assert (got.seed, got.out_json) == (want.seed, want.out_json)


def jax_record_keys() -> set:
    """The keys of the JAX script's ``record`` dict literal."""
    tree = ast.parse((ROOT / "examples" / "train_full.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "record":
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in examples/train_full.py")


def test_train_full_quick_main(tmp_path):
    out_json = tmp_path / "record.json"
    result = train_full.main(["--preset", "quick", "--steps", "6", "--views", "2", "--width", "48", "--height", "32",
                              "--truth-n", "300", "--init-n", "100", "--device", "cpu", "--out-json", str(out_json),
                              "--out-dir", str(tmp_path / "ckpt")])
    record = json.loads(out_json.read_text())
    assert set(record) == jax_record_keys()
    losses = result["history"]["losses"]
    assert len(losses) == 6
    # Over the real count: the JAX script's hard-coded 10 gives 0.6 of the mean here.
    for key in ("loss_l1_dssim_first10_mean", "loss_l1_dssim_last10_mean"):
        assert record[key] == pytest.approx(sum(losses) / 6, abs=5e-6), key
    assert "--preset" in record["provenance"] and record["truth_splats"] == 300
    # The final checkpoint is one file; restored, it is the trained cloud.
    ckpt = tmp_path / "ckpt" / "ckpt_final"
    assert ckpt.is_file()
    restored, step = load_checkpoint(str(ckpt), **CPU)
    assert step == 6 == result["restored_step"]
    for f in RAW_FIELDS:
        assert torch.equal(getattr(restored, f), getattr(result["trained"], f).detach()), f
    cam, target = result["train_cams"][0], result["targets"][0]
    trained_psnr = psnr_of(result["trained"], cam, target, result["settings"], result["config"], backend="torch", **CPU)
    assert result["restored_psnr"] == trained_psnr
    assert record["psnr_trained_db"] == pytest.approx(trained_psnr)


def test_train_full_r5_step_matches_jax(jax_train_full):
    # One step of r5's loop (its captured scenes, ring, SH1 and the bench's
    # packs, at a reduced size): the loss and the densification statistic,
    # the port's fused path (plain versions) against JAX's Pallas path
    # (interpret mode).  pack_grads_bf16 rounds each pair's gradient to bf16,
    # so a pair may sit one bf16 step apart: the statistic within 2^-8 of its
    # max, the rows over the threshold within 1%.
    w, h, n_truth, n_init = 96, 64, 3000, 1000
    args = train_full.parse_args(["--preset", "r5"])
    config = RasterizeConfig(pack_axes_f16=True, pack_grads_bf16=True, pack_center_u32=True,
                                        pack_color_rgba8=True)
    jconfig = JaxConfig(**{f: getattr(config, f) for f in ("pack_axes_f16", "pack_grads_bf16", "pack_center_u32",
                                                           "pack_color_rgba8")})
    ring = (R5_RING["radius"], w, h, R5_RING["height_off"], R5_RING["fov"], R5_RING["target"])
    cam, jcam = train_full.ring_cameras(1, *ring)[0], jax_train_full.ring_cameras(1, *ring)[0]
    settings, jsettings = RenderSettings(sh_order=args.sh_order), JaxSettings(sh_order=args.sh_order)
    target = np.asarray(jrd.render(jsyn.captured_scene(n=n_truth, seed=5).activate(), jcam, jsettings, jconfig,
                                   backend="pallas"))[..., :3]
    jinit = jsyn.captured_scene(n=n_init, seed=77)
    jopt = jtr.default_optimizer()
    jstep = jtl._make_step(jopt, jsettings, jconfig, "pallas", 0.2, w, h)
    jloss, *_, jstat, _, _ = jstep(jinit, jopt.init(jinit), jnp.zeros(n_init), jnp.zeros(n_init, jnp.int32), jcam,
                                   jnp.asarray(target))
    init = captured_scene(n=n_init, seed=77)
    opt = ttr.default_optimizer()
    step = ttl._make_step(opt, settings, config, "cuda", 0.2, w, h, **CPU)
    loss, *_, stat, _, _ = step(init, opt.init(init), torch.zeros(n_init), torch.zeros(n_init, dtype=torch.int32),
                                cam, torch.from_numpy(target.copy()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    stat, jstat = stat.numpy(), np.asarray(jstat)
    assert np.abs(stat - jstat).max() <= 2.0**-8 * np.abs(jstat).max()
    threshold = ttl.TrainLoopConfig().grad_threshold
    hot, jhot = int((stat > threshold).sum()), int((jstat > threshold).sum())
    assert jhot > 0 and abs(hot - jhot) <= max(1, jhot // 100), (hot, jhot)


def test_loss_means_take_the_real_count():
    assert train_full.loss_means([1.0, 2.0, 3.0]) == (2.0, 2.0)
    assert train_full.loss_means([float(i) for i in range(25)]) == (4.5, 19.5)
    assert train_full.loss_means([]) == (None, None)
    with pytest.raises(ValueError, match="held_out"):
        train_full.held_out_cameras(4, 5, 9.0, 8, 8, 2.0, 47.0, (0, 0, 0))


# --- measure_overlap --------------------------------------------------------


def jax_tool_arithmetic(rects, n, tiles_x, tiles_y) -> dict:
    """tools/measure_overlap.py:35-56 on ``tile_rects``' numpy output."""
    x0, y0, nx, ny, counts, valid = (np.asarray(r) for r in rects)
    v = valid & (counts > 0)
    c = counts[v]
    grid = np.zeros((tiles_y + 1, tiles_x + 1), np.int64)
    x0v, y0v, nxv, nyv = x0[v], y0[v], nx[v], ny[v]
    np.add.at(grid, (y0v, x0v), 1)
    np.add.at(grid, (y0v + nyv, x0v), -1)
    np.add.at(grid, (y0v, x0v + nxv), -1)
    np.add.at(grid, (y0v + nyv, x0v + nxv), 1)
    per_tile = np.cumsum(np.cumsum(grid, axis=0), axis=1)[:tiles_y, :tiles_x]
    return dict(visible=v.mean(), pairs_per_splat=c.sum() / n, pairs_per_visible=c.mean(),
                p50=np.percentile(c, 50), p95=np.percentile(c, 95), p99=np.percentile(c, 99), max=c.max(),
                hist=np.bincount(np.clip(c, 0, 16), minlength=17), per_tile=per_tile,
                tile_mean=per_tile.mean(), tile_p50=np.percentile(per_tile, 50),
                tile_p95=np.percentile(per_tile, 95), tile_max=per_tile.max())


def assert_overlap_equal(got: dict, want: dict):
    for key in ("max", "tile_max"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["hist"], want["hist"])
    np.testing.assert_array_equal(np.asarray(got["per_tile"]), want["per_tile"])
    for key in ("visible", "pairs_per_splat", "pairs_per_visible", "p50", "p95", "p99", "tile_mean", "tile_p50",
                "tile_p95"):
        assert got[key] == pytest.approx(float(want[key]), abs=1e-6), key


@pytest.mark.parametrize("name", list(measure_overlap.SCENES))
def test_measure_overlap_matches_jax(name, capsys):
    n = 2000
    jax_tool = load_script("tools/measure_overlap.py")
    make, seed, _ = measure_overlap.SCENES[name]
    jraw = getattr(jsyn, make.__name__)(n=n, seed=seed)
    eye, target = measure_overlap.SCENES[name][2]
    jcam = JaxCamera.look_at(eye=eye, target=target, up=[0, 1, 0], fov_y_deg=47.0, width=1200, height=797)
    views_close(measure_overlap.scene_camera(name), jcam, atol=0)
    jcfg = JaxConfig()
    tiles = tile_grid(1200, 797, RasterizeConfig())
    jproj = jax.jit(lambda g: jax_project(g, jcam, JaxSettings(sh_order=0)))(jraw.activate())
    jrects = jax.jit(lambda p: jbin.tile_rects(p, 1200, 797, jcfg))(jproj)
    want = jax_tool_arithmetic(jrects, n, *tiles)
    # The port's arithmetic on the JAX projection's rects, then the port's tool end to end.
    same = measure_overlap.overlap_stats(tuple(torch.from_numpy(np.array(r)) for r in jrects), n, *tiles)
    assert_overlap_equal(same, want)
    capsys.readouterr()
    got = measure_overlap.stats(name, make(n=n, seed=seed), measure_overlap.scene_camera(name),
                                RasterizeConfig(), **CPU)
    assert_overlap_equal(got, want)
    port_lines = capsys.readouterr().out
    jax_tool.stats(name, jraw, jcam, jcfg)
    assert port_lines == capsys.readouterr().out


# --- measure_bc7 ------------------------------------------------------------


def test_measure_bc7_matches_jax():
    n = 8 * 256  # the texture of 8 chunks
    jax_tool = load_script("tools/measure_bc7.py")
    tex = measure_bc7.chunk_normalized_color_tex(n)
    jtex = jax_tool.chunk_normalized_color_tex(n)
    np.testing.assert_array_equal(tex, jtex)
    got = measure_bc7.texture_psnrs(tex)
    u8 = np.clip(jtex * 255.5, 0, 255).astype(np.uint8)
    h, w, _ = jtex.shape
    dec = jax_tool.decode_bc7(jax_tool.encode_bc7(u8), w, h).reshape(h, w, 4).astype(np.float32) / 255.0
    assert got["norm8"] == jax_tool.psnr(jtex, u8.astype(np.float32) / 255.0)
    assert got["bc7"] == jax_tool.psnr(jtex, dec)
    assert got["bytes"] == w * h


# --- entry points -----------------------------------------------------------


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_programs_need_cuda_unless_told(program, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"unitygaussiansplatting_torch.{program}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([str(tmp_path / a) for a in PROGRAMS[program]])


@pytest.mark.parametrize("program", [*PROGRAMS, "tools.measure_bc7"])
def test_programs_run_as_modules(program):
    out = subprocess.run([sys.executable, "-m", f"unitygaussiansplatting_torch.{program}", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout and ("--device" in out.stdout) == (program != "tools.measure_bc7")
