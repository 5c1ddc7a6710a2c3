"""The port's forward render slice end to end vs the JAX package.

Same raw splats (numpy) through port ``render`` (plain PyTorch versions of
the kernels on the CPU) and JAX ``render(..., backend="pallas")`` (Pallas
kernels in interpret mode).  Also holds the JAX image fixture that
``chip_smoke.py`` compares the card's images with (the machine with the card
has no JAX): ``python tests/test_torch_render.py`` rewrites it.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene, sphere_scene_device  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "torch_fixtures" / "sphere1500_192x128.npz"
FIXTURE_CONFIGS = {"default": {}, "headline": tp.HEADLINE}

# End-to-end bar: ulp-level projection differences (XLA contracts into FMA,
# transcendentals differ by an ulp) can flip a pixel across alpha_discard or
# the |q| <= 2 clip, so a few channels may move by up to the alpha step.
# With the headline packs they can also put a value on the neighbouring
# lattice code: measured one theta code of 1500 (a 1.5 mrad turn of that
# splat) and ~0.3% of pair centers one code step apart, which leaves 99.88%
# of channels within 1e-4 and a max of 1.2e-3 (default config: max 4.4e-6).
E2E_MAX = 5e-3
E2E_ATOL = 1e-4
E2E_FRACTION = {"default": 0.999, "headline": 0.998}


def jax_fixture_images() -> dict:
    """JAX pallas images of the fixture scene, one per fixture config."""
    jcam, _ = tp.cameras()
    g = tp.jax_scene().activate()
    return {
        name: np.asarray(jrd.render(g, jcam, JaxRenderSettings(sh_order=3), tp.configs(**kw)[0],
                                    backend="pallas"))
        for name, kw in FIXTURE_CONFIGS.items()
    }


def write_fixture(images: dict) -> None:
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    meta = dict(
        scene=dict(n=tp.SCENE_N, seed=tp.SCENE_SEED), camera=dict(tp.CAMERA, width=tp.WIDTH, height=tp.HEIGHT),
        settings=dict(sh_order=3), configs=FIXTURE_CONFIGS,
        tolerance=dict(max=E2E_MAX, atol=E2E_ATOL, fraction=E2E_FRACTION),
    )
    np.savez_compressed(FIXTURE, meta=json.dumps(meta), **{f"image_{k}": v for k, v in images.items()})


def assert_e2e_close(got, want, fraction=E2E_FRACTION["default"]):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert d.max() <= E2E_MAX, d.max()
    assert np.mean(d <= E2E_ATOL) >= fraction, np.mean(d <= E2E_ATOL)


@pytest.fixture(scope="module")
def jax_images():
    return jax_fixture_images()


def test_fixture_is_current(jax_images):
    # The card's parity phase reads this file; it must be what the JAX
    # package renders now.
    with np.load(FIXTURE) as f:
        meta = json.loads(str(f["meta"]))
        assert meta["configs"] == json.loads(json.dumps(FIXTURE_CONFIGS))
        assert meta["tolerance"]["fraction"] == E2E_FRACTION
        for name, img in jax_images.items():
            np.testing.assert_array_equal(f[f"image_{name}"], img, err_msg=name)


@pytest.mark.parametrize("name", list(FIXTURE_CONFIGS))
def test_render_matches_jax(jax_images, name):
    _, tcam = tp.cameras()
    cfg = tp.configs(**FIXTURE_CONFIGS[name])[1]
    g = sphere_scene(n=tp.SCENE_N, seed=tp.SCENE_SEED).activate()
    img, stats = trd.render_with_stats(g, tcam, RenderSettings(sh_order=3), cfg, device="cpu")
    assert img.shape == (tp.HEIGHT, tp.WIDTH, 4) and img.dtype == torch.float32
    assert not bool(stats.overflowed) and 0 < int(stats.num_pairs) <= stats.budget
    assert_e2e_close(img.numpy(), jax_images[name], E2E_FRACTION[name])


def test_reference_backend_matches_jax():
    jcam, tcam = tp.cameras()
    raw = tp.jax_scene(n=200, seed=4)
    want = jrd.render(raw.activate(), jcam, backend="reference")
    got = trd.render(tp.port_scene(raw).activate(), tcam, backend="reference", device="cpu")
    assert_e2e_close(got.numpy(), want)
    # The tile pipeline computes the same function.
    tiles = trd.render(tp.port_scene(raw).activate(), tcam, device="cpu")
    np.testing.assert_allclose(tiles.numpy(), got.numpy(), atol=E2E_ATOL)


def test_visibility_and_pair_multiplier_match_jax():
    jcam, tcam = tp.cameras()
    raw = tp.jax_scene(n=400, seed=5)
    g = tp.port_scene(raw).activate()
    _, jstats = jrd.render_with_stats(raw.activate(), jcam, backend="reference", want_visibility=True)
    _, stats = trd.render_with_stats(g, tcam, backend="reference", want_visibility=True, device="cpu")
    np.testing.assert_array_equal(stats.visible.numpy(), np.asarray(jstats.visible))
    jm = jrd.suggest_pair_multiplier(raw.activate(), [jcam])
    m = trd.suggest_pair_multiplier(g, [tcam], device="cpu")
    assert m[1] == jm[1] and m[0] == pytest.approx(jm[0])


def test_check_overflow():
    stats = trd.RenderStats(torch.tensor(5000), 4096, torch.tensor(True))
    with pytest.warns(UserWarning, match="overflow"):
        assert trd.check_overflow(stats)
    with pytest.raises(RuntimeError, match="overflow"):
        trd.check_overflow(stats, action="raise")
    assert not trd.check_overflow(trd.RenderStats(torch.tensor(5), 4096, torch.tensor(False)))


def test_default_device_raises_without_cuda(monkeypatch):
    # Entry points run on CUDA unless told otherwise; with no GPU they raise
    # instead of continuing on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcam = tp.cameras()
    g = sphere_scene(n=16).activate()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trd.render(g, tcam)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trd.render_with_stats(g, tcam)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sphere_scene_device(16)
    with pytest.raises(ValueError, match="backend"):
        trd.render(g, tcam, backend="pallas", device="cpu")


def test_backward_raises_not_silently_zero():
    _, tcam = tp.cameras()
    g = sphere_scene(n=64).activate()
    g.means.requires_grad_(True)
    img = trd.render(g, tcam, device="cpu")
    assert img.requires_grad
    with pytest.raises(NotImplementedError, match="K3/K4"):
        img.sum().backward()


def test_package_never_imports_jax():
    # Every module of the port imports with jax and the JAX package blocked.
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['unitygaussiansplatting_tpu'] = None\n"
        "import unitygaussiansplatting_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # And no import statement names them, even one that a run never reaches.
    for path in [root / "chip_smoke.py", *(root / "unitygaussiansplatting_torch").rglob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "unitygaussiansplatting_tpu"), (path, mod)


if __name__ == "__main__":
    write_fixture(jax_fixture_images())
    print(f"wrote {FIXTURE}")
