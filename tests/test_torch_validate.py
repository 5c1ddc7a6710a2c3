"""The port's validator and debug render modes against the JAX package's,
and the port's frames against the committed goldens, on the CPU.

- ``validate_image``: the same ``ValidationResult`` as the JAX package's on
  the same arrays, field for field.
- The debug modes on ``sphere_scene(n=2000, seed=0)`` at 256x160 (the
  goldens' scene and camera): equal to the JAX package's images, bit for bit.
- The goldens: the port's main frame and both debug modes, quantized to u8
  as ``tests/test_validate.py:113-126`` does, through the JAX package's own
  ``validate_image`` gate (at most 50 differing pixels, at least 90 dB).
"""

import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch import validate as tval  # noqa: E402
from unitygaussiansplatting_torch.models import debug_render as tdr  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render_over_background  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.image import save_png  # noqa: E402
from unitygaussiansplatting_tpu import validate as jval  # noqa: E402
from unitygaussiansplatting_tpu.models import debug_render as jdr  # noqa: E402
from unitygaussiansplatting_tpu.utils.image import load_png  # noqa: E402

torch.set_num_threads(2)

GOLDENS = Path(__file__).parent / "goldens"
GOLDEN_W, GOLDEN_H = 256, 160


@pytest.fixture(scope="module")
def golden_scene():
    """(JAX cloud, port cloud, JAX camera, port camera) of the goldens."""
    raw = tp.jax_scene(n=2000, seed=0)
    jcam, tcam = tp.cameras(GOLDEN_W, GOLDEN_H)
    return raw.activate(), tp.port_scene(raw).activate(), jcam, tcam


DEBUG_MODES = {
    "points": ("render_debug_points", {}),
    "points-by-index": ("render_debug_points", dict(by_index=True)),
    "points-3px-grey": ("render_debug_points", dict(point_size=3, background=(0.2, 0.2, 0.2))),
    "chunk-bounds": ("render_debug_chunk_bounds", dict(chunk_size=64)),
    "boxes": ("render_debug_boxes", {}),
}


@pytest.fixture(scope="module")
def port_debug_images(golden_scene):
    _, tg, _, tcam = golden_scene
    return {name: getattr(tdr, fn)(tg, tcam, device="cpu", **kw) for name, (fn, kw) in DEBUG_MODES.items()}


@pytest.mark.parametrize("name", list(DEBUG_MODES))
def test_debug_modes_equal_jax(golden_scene, port_debug_images, name):
    jg, _, jcam, _ = golden_scene
    fn, kw = DEBUG_MODES[name]
    want = np.asarray(getattr(jdr, fn)(jg, jcam, **kw))
    got = port_debug_images[name]
    assert got.shape == (GOLDEN_H, GOLDEN_W, 3) and float(got.max()) > 0
    np.testing.assert_array_equal(got.numpy(), want)


def quantized(img):
    """u8 quantization as save_png does (floor(v * 255 + 0.5) / 255)."""
    return np.floor(np.clip(img[..., :3].numpy(), 0, 1) * 255.0 + 0.5) / 255.0


@pytest.mark.parametrize("name", ["sphere_main", "sphere_debug_points", "sphere_debug_boxes"])
def test_port_frames_pass_the_golden_gate(golden_scene, port_debug_images, name, tmp_path):
    _, tg, _, tcam = golden_scene
    if name == "sphere_main":
        img = render_over_background(tg, tcam, torch.zeros(3), RenderSettings(sh_order=1), RasterizeConfig(),
                                     device="cpu")
    else:
        img = port_debug_images[name.removeprefix("sphere_debug_")]
    res = jval.validate_image(quantized(img), load_png(str(GOLDENS / f"{name}.png")), name=name,
                              dump_folder=str(tmp_path))
    assert res.passed, str(res)
    assert res.diff_pixels == 0


def image_pairs():
    rng = np.random.default_rng(9)
    base = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    few = base.copy()
    few[rng.integers(0, 48, 30), rng.integers(0, 64, 30)] += 0.1  # <= 30 pixels off by 0.1
    noisy = base + rng.normal(scale=1e-3, size=base.shape).astype(np.float32)
    rgba = np.concatenate([base, np.ones((48, 64, 1), np.float32)], -1)
    return {"same": (base, base), "few-pixels": (few, base), "noise": (noisy, base),
            "all-off": (np.zeros_like(base), np.ones_like(base)), "rgba-vs-rgb": (rgba, base)}


@pytest.mark.parametrize("case", list(image_pairs()))
def test_validate_image_matches_jax(case, tmp_path):
    got, golden = image_pairs()[case]
    want = jval.validate_image(got, golden, name=case, dump_folder=str(tmp_path / "jax"))
    res = tval.validate_image(got, golden, name=case, dump_folder=str(tmp_path / "port"))
    assert res == tval.ValidationResult(want.name, want.rmse, want.psnr, want.diff_pixels, want.passed)
    assert str(res) == str(want)
    dumped = sorted(os.listdir(tmp_path / "port")) if (tmp_path / "port").exists() else []
    assert dumped == (sorted(os.listdir(tmp_path / "jax")) if (tmp_path / "jax").exists() else [])
    for f in dumped:
        np.testing.assert_array_equal(load_png(str(tmp_path / "port" / f)), load_png(str(tmp_path / "jax" / f)))


def test_validate_image_size_mismatch_raises():
    with pytest.raises(ValueError, match="size mismatch"):
        tval.validate_image(np.zeros((4, 4, 3)), np.zeros((5, 5, 3)))


def test_validate_render_passes_itself_and_dumps_on_failure(tmp_path):
    # tests/test_validate.py's validator checks, on the port.
    raw = tp.jax_scene(n=400, seed=5)
    g = tp.port_scene(raw).activate()
    _, cam = tp.cameras(128, 96)
    img = render_over_background(g, cam, torch.zeros(3), device="cpu")
    golden = str(tmp_path / "golden.png")
    save_png(golden, np.clip(img[..., :3].numpy(), 0, 1))
    res = tval.validate_render(g, cam, golden, name="self", dump_folder=str(tmp_path / "self"), device="cpu")
    # The u8 golden clips values above 1: tests/test_validate.py's bars.
    assert res.diff_pixels <= 50 and res.psnr > 45
    save_png(golden, np.ones((96, 128, 3), np.float32))
    res = tval.validate_render(g, cam, golden, name="bad", dump_folder=str(tmp_path / "bad"), device="cpu")
    assert not res.passed
    assert sorted(os.listdir(tmp_path / "bad")) == ["bad_diff.png", "bad_got.png", "bad_ref.png"]
