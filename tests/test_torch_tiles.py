"""The port's tile path (``backend="torch"``) vs the JAX package's XLA path.

The same numpy inputs go to both packages: the chunk math
(``tile_common.chunk_alphas``/``composite_chunk``), ``bin_splats`` (every
output exact, overflow included), ``rasterize_tiles_torch``, the renderer's
``"torch"`` backend and its autograd gradients, train steps, multi-object
frames and the validator through it.  Also holds the fixture of the JAX
package's XLA-path gradients that ``chip_smoke.py`` compares the card's
tile path with (the machine with the card has no JAX):
``python tests/test_torch_tiles.py`` rewrites it.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from test_torch_backward import GAUSSIAN_FIELDS, WEIGHT_SEED, assert_grads_close, weight_image  # noqa: E402
from unitygaussiansplatting_torch import validate as tval  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.models import trainer as ttr  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians, RawGaussians  # noqa: E402
from unitygaussiansplatting_torch.ops import binning as tbin  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_tiles as trt  # noqa: E402
from unitygaussiansplatting_torch.ops import tile_common as ttc  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS, camera_from_numpy  # noqa: E402
from unitygaussiansplatting_torch.utils.image import save_png  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.models import trainer as jtr  # noqa: E402
from unitygaussiansplatting_tpu.ops import binning as jbin  # noqa: E402
from unitygaussiansplatting_tpu.ops import rasterize_tiles as jrt  # noqa: E402
from unitygaussiansplatting_tpu.ops import tile_common as jtc  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

# The chunk math on the same float32 inputs: the same terms in the same
# order; the color sum's order of addition is the library's (measured 2e-7).
CHUNK_ATOL = 1e-6
# Images: tests/test_pallas.py:49's bar between backends; a multi-object
# frame adds two frames, each within it.
IMAGE_ATOL = 5e-6
MULTI_ATOL = 2 * IMAGE_ATOL
# Gradients: against jax.grad of the XLA path, tests/test_gradients.py:123's
# bars; against the port's hand-written backward, :150-158's.
GRAD_JAX = dict(rtol=1e-3, atol=1e-4)
GRAD_CUDA = dict(rtol=2e-3, atol=2e-5)
GRAD_FIELDS = ("means", "log_scales", "opacity_logits", "sh0")
# tests/test_render.py:20's scene and config.
SMALL = dict(n=400, seed=0, width=128, height=64)
SMALL_CONFIG = dict(tile_h=8, chunk_size=32)
# bin_splats configs: the default, small tiles and chunks, quad AABBs
# (alpha_discard=0) and an overflowing budget (depth-major truncation).
BIN_CONFIGS = {
    "default": {},
    "small-tiles": dict(tile_h=8, chunk_size=32),
    "quad-aabbs": dict(alpha_discard=0.0),
    "overflow": dict(pair_multiplier=0.5),
}
# The gradients of sum(image * seeded weights) w.r.t. the activated fixture
# scene (tests/test_torch_backward.py's), JAX's XLA path, default config.
# tests/test_torch_backward.py:64's bar, but for the share of splats within
# 1e-4: a color whose f16 rounding lands next to the 2^-14 flush
# (tile_common._f16_round) is flushed on one side and kept on the other, its
# gradient zero against whole; measured on the CPU 2 of 1500 splats in
# base_color (1.06e-4) and 1 in sh (1.24e-4), all within 2e-4.  The Pallas
# fixture (sphere1500_192x128_grads.npz) is no reference for this path: K1
# and K3 stop at transmittance_eps and drop the gradients of the pairs
# behind saturated pixels, which the XLA path keeps; JAX's own XLA path is
# 0.0206 of the field's max from it.
# The work cap is set to 2048 pairs a tile, 16 chunks instead of the
# default's 64 (the XLA path's static trip count): no tile of 1500 splats
# reaches it, so the function is the default config's.
XLA_GRAD_FIXTURE = Path(__file__).parent / "torch_fixtures" / "sphere1500_192x128_grads_xla.npz"
XLA_GRAD_CONFIGS = {"default": dict(max_pairs_per_tile=2048)}
XLA_GRAD_TOL = {"default": dict(max=2e-4, atol=1e-4, fraction=0.998)}
BIN_FIELDS = ("pair_rank", "pair_tile", "depth_order", "rank_counts", "tile_starts", "num_pairs")


def jax_projection(raw, jcam, sh_order=3):
    return jax_project(raw.activate(), jcam, JaxRenderSettings(sh_order=sh_order))


@pytest.mark.parametrize("quad_clip", [True, False])
def test_chunk_math_matches_jax(quad_clip):
    rng = np.random.default_rng(3)
    c, p = 48, 256
    center = rng.uniform(0, 64, (c, 2)).astype(np.float32)
    axis1 = rng.normal(0, 6, (c, 2)).astype(np.float32)
    axis2 = np.stack([axis1[:, 1], -axis1[:, 0]], -1) * rng.uniform(0.2, 1.0, (c, 1)).astype(np.float32)
    opacity = rng.uniform(0, 1, c).astype(np.float32)
    colors = rng.uniform(0, 1.5, (c, 3)).astype(np.float32)
    px = rng.uniform(0, 64, p).astype(np.float32)
    py = rng.uniform(0, 64, p).astype(np.float32)
    trans = rng.uniform(0.2, 1, p).astype(np.float32)
    jcfg, cfg = tp.configs(quad_clip=quad_clip)
    ja = jtc.chunk_alphas(*map(jnp.asarray, (center, axis1, axis2, opacity, px, py)), jcfg)
    ta = ttc.chunk_alphas(*map(torch.from_numpy, (center, axis1, axis2, opacity, px, py)), cfg)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=CHUNK_ATOL)
    assert float((ta > 0).float().mean()) > 0.05  # the inputs reach the clip and the discard both ways
    assert float((ta == 0).float().mean()) > 0.05
    want = jtc.composite_chunk(jnp.asarray(trans), ja, jnp.asarray(colors))
    got = ttc.composite_chunk(torch.from_numpy(trans), torch.from_numpy(np.array(ja)), torch.from_numpy(colors))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=CHUNK_ATOL)


@pytest.mark.parametrize("name", list(BIN_CONFIGS))
def test_bin_splats_exact(name):
    jcam, _ = tp.cameras()
    jcfg, cfg = tp.configs(**BIN_CONFIGS[name])
    jproj = jax_projection(tp.jax_scene(), jcam)
    want = jax.jit(lambda p: jbin.bin_splats(p, tp.WIDTH, tp.HEIGHT, jcfg))(jproj)
    got = tbin.bin_splats(tp.proj_to_torch(jproj), tp.WIDTH, tp.HEIGHT, cfg)
    for f in BIN_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w), f
    np.testing.assert_array_equal(got.pair_splat.numpy(), np.asarray(want.pair_splat))
    budget = got.pair_rank.shape[0]
    assert (int(got.num_pairs) > budget) == (name == "overflow")


def test_floor_division_equals_the_reciprocal_trick():
    # bin_splats' j // snx: the JAX package's float reciprocal with its exact
    # correction (binning.py:250-255), against integer floor division, for
    # every divisor a rect can have (nx in 1..511) at and around every
    # multiple up to the largest within-run index (511 x 2047 tiles).
    snx = np.arange(1, 512, dtype=np.int32)[:, None]
    q = np.arange(0, 2048, dtype=np.int32)[None, :]
    j = np.stack([q * snx - 1, q * snx, q * snx + 1, q * snx + snx // 2], -1)
    j = np.minimum(np.maximum(j, 0), 511 * 2047).reshape(511, -1)
    snx = np.broadcast_to(snx, j.shape)
    jj, js = jnp.asarray(j), jnp.asarray(snx)
    fq = jnp.floor(jj.astype(jnp.float32) * (1.0 / js.astype(jnp.float32))).astype(jnp.int32)
    rem = jj - fq * js
    fq = jnp.where(rem < 0, fq - 1, jnp.where(rem >= js, fq + 1, fq))
    got = torch.div(torch.from_numpy(j.copy()), torch.from_numpy(snx.copy()), rounding_mode="floor")
    np.testing.assert_array_equal(got.numpy(), np.asarray(fq))
    np.testing.assert_array_equal(got.numpy(), j // snx)


@pytest.fixture(scope="module")
def small_scene():
    """(JAX raw, JAX camera, port camera, JAX config, port config, settings
    of both) of tests/test_render.py:20."""
    raw = tp.jax_scene(n=SMALL["n"], seed=SMALL["seed"])
    jcam, tcam = tp.cameras(SMALL["width"], SMALL["height"])
    jcfg, cfg = tp.configs(**SMALL_CONFIG)
    return raw, jcam, tcam, jcfg, cfg, JaxRenderSettings(sh_order=1), RenderSettings(sh_order=1)


def test_rasterize_tiles_matches_jax(small_scene):
    raw, jcam, _, jcfg, cfg, jset, _ = small_scene
    jproj = jax_project(raw.activate(), jcam, jset)
    w, h = SMALL["width"], SMALL["height"]
    want = np.asarray(jax.jit(lambda p: jrt.rasterize_tiles_jax(p, jbin.bin_splats(p, w, h, jcfg), w, h, jcfg))(jproj))
    proj = tp.proj_to_torch(jproj)
    got = trt.rasterize_tiles_torch(proj, tbin.bin_splats(proj, w, h, cfg), w, h, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    assert float(want[..., 3].mean()) > 0.05


@pytest.mark.parametrize("name", ["small", "default", "overflow"])
def test_render_torch_matches_jax(name, small_scene):
    if name == "small":
        raw, jcam, tcam, jcfg, cfg, jset, tset = small_scene
    else:
        raw = tp.jax_scene()
        jcam, tcam = tp.cameras()
        jcfg, cfg = tp.configs(**BIN_CONFIGS[name])
        jset, tset = JaxRenderSettings(sh_order=3), RenderSettings(sh_order=3)
    g = raw.activate()
    want, jstats = jax.jit(lambda g: jrd.render_with_stats(g, jcam, jset, jcfg, backend="jax"))(g)
    got, stats = trd.render_with_stats(tp.port_cloud(g), tcam, tset, cfg, backend="torch", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=IMAGE_ATOL)
    assert int(stats.num_pairs) == int(jstats.num_pairs) and stats.budget == jstats.budget
    assert bool(stats.overflowed) == bool(jstats.overflowed) == (name == "overflow")
    if name == "overflow":
        with pytest.warns(UserWarning, match="depth-major on the torch backend"):
            trd.check_overflow(stats)


@pytest.mark.parametrize("name", ["small", "default"])
def test_render_torch_matches_cuda_backend(name, small_scene):
    # Both port backends on the CPU (the "cuda" backend's plain versions).
    if name == "small":
        raw, _, tcam, _, cfg, _, tset = small_scene
    else:
        raw, (_, tcam), cfg, tset = tp.jax_scene(), tp.cameras(), tp.configs()[1], RenderSettings(sh_order=3)
    g = tp.port_scene(raw).activate()
    a = trd.render(g, tcam, tset, cfg, backend="torch", device="cpu")
    b = trd.render(g, tcam, tset, cfg, backend="cuda", device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=IMAGE_ATOL)


# tests/test_gradients.py:40-50's loss: a weighted sum of the channels.
CHANNEL_WEIGHTS = [0.3, 0.5, 0.2, 0.7]


def port_grads(raw, tcam, tset, cfg, backend):
    params = [torch.from_numpy(np.array(getattr(raw, f))).requires_grad_(True) for f in RAW_FIELDS]
    img = trd.render(RawGaussians(**dict(zip(RAW_FIELDS, params))).activate(), tcam, tset, cfg, backend=backend,
                     device="cpu")
    return dict(zip(RAW_FIELDS, torch.autograd.grad(torch.sum(img * torch.tensor(CHANNEL_WEIGHTS)), params)))


def test_gradients_match_jax_and_cuda_backend():
    # tests/test_gradients.py's scene, camera and loss, default config.
    raw = tp.jax_scene(n=60, seed=3)

    jcam = JaxCamera.look_at(eye=[0.0, 0.3, -2.6], target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0], fov_y_deg=50.0,
                             width=48, height=32)
    tcam = camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, 48, 32)
    jcfg, cfg = tp.configs()
    jset, tset = JaxRenderSettings(sh_order=1), RenderSettings(sh_order=1)
    want = jax.jit(jax.grad(lambda r: jnp.sum(jrd.render(r.activate(), jcam, jset, jcfg, backend="jax")
                                              * jnp.asarray(CHANNEL_WEIGHTS))))(raw)
    got = port_grads(raw, tcam, tset, cfg, "torch")
    cuda = port_grads(raw, tcam, tset, cfg, "cuda")
    for f in GRAD_FIELDS:
        g = got[f].numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 1e-6, f
        np.testing.assert_allclose(g, np.asarray(getattr(want, f)), err_msg=f, **GRAD_JAX)
        np.testing.assert_allclose(g, cuda[f].numpy(), err_msg=f, **GRAD_CUDA)


def test_train_steps_match_jax():
    # tests/test_torch_trainer.py's three Adam steps, on the tile path.

    cam = dict(eye=[0, 0.3, -2.8], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=64, height=48)
    jcam = JaxCamera.look_at(**cam)
    tcam = camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, cam["width"], cam["height"])
    # max_pairs_per_tile: no tile of 200 splats reaches 256 pairs, so the
    # function is the default cap's, in 8 chunks of the XLA path's scan
    # instead of 256.
    jcfg, cfg = tp.configs(tile_h=8, chunk_size=32, max_pairs_per_tile=256)
    truth = tp.jax_scene(n=300, seed=7)
    target = np.array(jrd.render(truth.activate(), jcam, JaxRenderSettings(sh_order=0), jcfg,
                                 backend="reference"))[..., :3]
    raw = tp.jax_scene(n=200, seed=8)
    lrs = dict(lr_means=1e-3, lr_rest=1e-2)

    jopt = jtr.default_optimizer(**lrs)
    jstep = jtr.make_train_step(jcam, jopt, settings=JaxRenderSettings(sh_order=0), config=jcfg, backend="jax")
    jstate, jraw, jlosses = jopt.init(raw), raw, []
    for _ in range(3):
        loss, jraw, jstate = jstep(jraw, jstate, jnp.asarray(target))
        jlosses.append(float(loss))

    opt = ttr.default_optimizer(**lrs)
    step = ttr.make_train_step(tcam, opt, settings=RenderSettings(sh_order=0), config=cfg, backend="torch",
                               device="cpu")
    traw = tp.port_scene(raw)
    state, losses = opt.init(traw), []
    for _ in range(3):
        loss, traw, state = step(traw, state, torch.from_numpy(target))
        losses.append(float(loss))

    # tests/test_torch_trainer.py's bars (the same Adam steps on the other
    # backend): losses to 1e-6 relative, every entry within 0.05 lr.
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    assert losses[-1] < losses[0]
    for f in RAW_FIELDS:
        lr = lrs["lr_means"] if f == "means" else lrs["lr_rest"]
        d = np.abs(getattr(traw, f).detach().numpy() - np.asarray(getattr(jraw, f)))
        assert d.max() <= 0.05 * lr, (f, d.max())
        assert np.mean(d <= 1e-5) >= 0.99, (f, np.mean(d <= 1e-5))


def test_render_multi_and_validate_render_on_the_tile_path(tmp_path, monkeypatch):
    # JAX's render_multi renders each object eagerly; its frames jitted are
    # the same function, compiled once.
    monkeypatch.setattr(jrd, "render", jax.jit(jrd.render, static_argnames=("backend",)))
    raws = [tp.jax_scene(n=300, seed=10), tp.jax_scene(n=300, seed=11)]
    jcam, tcam = tp.cameras()
    jcfg, cfg = tp.configs(max_pairs_per_tile=512)  # an object of 300 splats stays under the cap
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0.2, 0.1, 0.0]
    want = np.asarray(jrd.render_multi([r.activate() for r in raws], jcam, config=jcfg, backend="jax",
                                       render_order=[0.0, 1.0], models=[m, None]))
    got = trd.render_multi([tp.port_scene(r).activate() for r in raws], tcam, config=cfg, backend="torch",
                           render_order=[0.0, 1.0], models=[torch.from_numpy(m), None], device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MULTI_ATOL)

    g = tp.port_scene(raws[0]).activate()
    img = trd.render_over_background(g, tcam, torch.zeros(3), backend="torch", device="cpu")
    golden = str(tmp_path / "golden.png")
    save_png(golden, np.clip(img[..., :3].numpy(), 0, 1))
    res = tval.validate_render(g, tcam, golden, name="self", backend="torch", device="cpu")
    # The u8 golden clips values above 1: tests/test_validate.py's bars.
    assert res.diff_pixels <= 50 and res.psnr > 45
    renderer = trd.GaussianSplatRenderer(g, backend="torch", device="cpu")
    np.testing.assert_array_equal(renderer.render_frame(tcam).numpy(), trd.render(g, tcam, backend="torch",
                                                                                   device="cpu").numpy())


def jax_xla_fixture_grads() -> dict:
    """``jax.grad`` of sum(render * weights) w.r.t. the activated fixture
    scene, the JAX package's XLA path (``backend="jax"``), default config."""
    jcam, _ = tp.cameras()
    wt = jnp.asarray(weight_image())
    cfg = tp.configs(**XLA_GRAD_CONFIGS["default"])[0]
    grads = jax.jit(jax.grad(lambda g: jnp.sum(jrd.render(g, jcam, JaxRenderSettings(sh_order=3), cfg,
                                                          backend="jax") * wt)))(tp.jax_scene().activate())
    return {f: np.asarray(getattr(grads, f)) for f in GAUSSIAN_FIELDS}


def write_xla_grad_fixture(grads: dict) -> None:
    meta = dict(
        scene=dict(n=tp.SCENE_N, seed=tp.SCENE_SEED), camera=dict(tp.CAMERA, width=tp.WIDTH, height=tp.HEIGHT),
        settings=dict(sh_order=3), configs=XLA_GRAD_CONFIGS, weight_seed=WEIGHT_SEED, fields=list(GAUSSIAN_FIELDS),
        tolerance=XLA_GRAD_TOL,
    )
    np.savez_compressed(XLA_GRAD_FIXTURE, meta=json.dumps(meta), **{f"grad_default_{f}": a for f, a in grads.items()})


def test_xla_grad_fixture_is_current_and_met_on_the_cpu():
    # chip_smoke.py's tile-path gradient check reads this file; it must be
    # what the JAX package computes now, and the port's CPU tile path meets it.
    want = jax_xla_fixture_grads()
    with np.load(XLA_GRAD_FIXTURE) as f:
        meta = json.loads(str(f["meta"]))
        assert meta["tolerance"] == XLA_GRAD_TOL and meta["weight_seed"] == WEIGHT_SEED
        assert meta["configs"] == XLA_GRAD_CONFIGS
        for field, a in want.items():
            np.testing.assert_array_equal(f[f"grad_default_{field}"], a, err_msg=field)
    _, tcam = tp.cameras()
    g = tp.port_scene(tp.jax_scene()).activate()
    g = Gaussians(**{f: getattr(g, f).detach().requires_grad_(True) for f in GAUSSIAN_FIELDS})
    img = trd.render(g, tcam, RenderSettings(sh_order=3), tp.configs(**XLA_GRAD_CONFIGS["default"])[1],
                     backend="torch", device="cpu")
    (img * torch.from_numpy(weight_image())).sum().backward()
    assert_grads_close({f: getattr(g, f).grad.numpy() for f in GAUSSIAN_FIELDS}, want, XLA_GRAD_TOL["default"])


if __name__ == "__main__":
    write_xla_grad_fixture(jax_xla_fixture_grads())
    print(f"wrote {XLA_GRAD_FIXTURE}")
