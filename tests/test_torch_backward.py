"""The port's backward (K3 + K4 behind ``Rasterize``) vs the JAX package.

The same numpy inputs go to both packages.  On the CPU the port's kernel
wrappers take their plain PyTorch versions; the JAX package's Pallas kernels
run in interpret mode.  JAX's end-to-end gradients are computed once per
module and also hold the gradient fixture that ``chip_smoke.py`` compares
the card's gradients with (the machine with the card has no JAX):
``python tests/test_torch_backward.py`` rewrites it.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
import unitygaussiansplatting_tpu.ops.rasterize_pallas as rpal  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians, RawGaussians  # noqa: E402
from unitygaussiansplatting_torch.models.trainer import photometric_loss  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as trc  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda_bwd as tbwd  # noqa: E402
from unitygaussiansplatting_torch.ops.pair_expand import bin_and_prepare  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.ops import pair_expand as jpe  # noqa: E402
from unitygaussiansplatting_tpu.ops import rasterize_pallas_bwd as jbwd  # noqa: E402
from unitygaussiansplatting_tpu.ops.binning import tile_grid  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

GRAD_FIXTURE = Path(__file__).parent / "torch_fixtures" / "sphere1500_192x128_grads.npz"
GRAD_CONFIGS = {"default": {}, "headline": tp.HEADLINE}
GAUSSIAN_FIELDS = ("means", "rotations", "scales", "opacities", "base_color", "sh")
WEIGHT_SEED = 5  # loss = sum(image * N(0, 1) weights from this seed)

# K3 per pair, f32: both sides sum the same (pair, pixel) terms, in another
# order (JAX factors the per-pair constants out of tile-local pixel sums and
# scans with Hillis-Steele); measured <= 8e-6 of each field's max at 600
# splats.  The bar is the Pallas kernel's own against XLA
# (tests/test_gradients.py:234-238).
K3_REL_TO_MAX = 1e-4
# bf16: each side rounds its own f32 sum once (nearest even), so a sum that
# lies near a rounding midpoint may land on the neighbouring bf16 value.
K3_BF16_ULPS = 1
# End to end, w.r.t. the activated Gaussians.  Default config: measured
# <= 6.3e-5 of each field's max.  Headline: bf16 pair gradients plus the
# lattice codes that differ between the packages (ROADMAP queue 3: XLA's
# FMA contraction moves ~0.3% of pair centers one code step, one theta code
# flips) move a few splats: measured >= 99.27% of splats within 1e-4 of the
# field's max, max 3.3e-3.
E2E_TOL = {
    "default": dict(max=2e-4, atol=1e-4, fraction=1.0),
    "headline": dict(max=1e-2, atol=1e-4, fraction=0.985),
}


def weight_image(height=tp.HEIGHT, width=tp.WIDTH):
    return np.random.default_rng(WEIGHT_SEED).normal(size=(height, width, 4)).astype(np.float32)


def jax_fixture_grads() -> dict:
    """``jax.grad`` of sum(render * weights) w.r.t. the activated Gaussians,
    JAX pallas backend, per fixture config."""
    jcam, _ = tp.cameras()
    g = tp.jax_scene().activate()
    wt = jnp.asarray(weight_image())
    out = {}
    for name, kw in GRAD_CONFIGS.items():
        cfg = tp.configs(**kw)[0]
        grads = jax.grad(
            lambda gg: jnp.sum(jrd.render(gg, jcam, JaxRenderSettings(sh_order=3), cfg, backend="pallas") * wt)
        )(g)
        out[name] = {f: np.asarray(getattr(grads, f)) for f in GAUSSIAN_FIELDS}
    return out


def write_grad_fixture(grads: dict) -> None:
    GRAD_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    meta = dict(
        scene=dict(n=tp.SCENE_N, seed=tp.SCENE_SEED), camera=dict(tp.CAMERA, width=tp.WIDTH, height=tp.HEIGHT),
        settings=dict(sh_order=3), configs=GRAD_CONFIGS, weight_seed=WEIGHT_SEED, fields=list(GAUSSIAN_FIELDS),
        tolerance=E2E_TOL,
    )
    arrays = {f"grad_{name}_{f}": a for name, fields in grads.items() for f, a in fields.items()}
    np.savez_compressed(GRAD_FIXTURE, meta=json.dumps(meta), **arrays)


def assert_grads_close(got: dict, want: dict, tol: dict):
    """Per field: every splat within ``max`` of the field's max magnitude, a
    ``fraction`` of splats within ``atol`` of it."""
    for f, w in want.items():
        g = np.asarray(got[f])
        assert np.isfinite(g).all(), f
        scale = max(np.abs(w).max(), 1e-12)
        per_splat = np.abs(g - w).reshape(w.shape[0], -1).max(1) / scale
        assert per_splat.max() <= tol["max"], (f, per_splat.max())
        assert np.mean(per_splat <= tol["atol"]) >= tol["fraction"], (f, np.mean(per_splat <= tol["atol"]))


def port_gaussian_grads(raw, cam, cfg, wt):
    g = tp.port_scene(raw).activate()
    g = Gaussians(**{f: getattr(g, f).detach().requires_grad_(True) for f in GAUSSIAN_FIELDS})
    img = trd.render(g, cam, RenderSettings(sh_order=3), cfg, device="cpu")
    (img * torch.from_numpy(wt)).sum().backward()
    return {f: getattr(g, f).grad.numpy() for f in GAUSSIAN_FIELDS}


@pytest.fixture(scope="module")
def jax_grads():
    return jax_fixture_grads()


# --------------------------------------------------------------------------
# K3 against the Pallas backward kernel, on the JAX pipeline's own inputs.


@pytest.mark.parametrize("name", ["default", "small-tiles", "headline"])
def test_k3_plain_matches_pallas_bwd(name):
    # The JAX pipeline's sorted fields, tile starts and forward output go to
    # both kernels with perm = identity, so both return sorted-pair order.
    jcfg, cfg = tp.configs(**tp.CONFIGS[name])
    jcam, _ = tp.cameras()
    w, h = tp.WIDTH, tp.HEIGHT
    jproj = jax_project(tp.jax_scene(n=600, seed=2).activate(), jcam)
    tiles_x, tiles_y = tile_grid(w, h, jcfg)
    binning, fields, _ = jpe.bin_and_prepare(jproj, w, h, jcfg, interpret=True)
    schedule = rpal.build_schedule(binning, tiles_x * tiles_y, jcfg.chunk_size)
    _, raw = rpal.composite_pallas(fields, schedule, w, h, jcfg, interpret=True, return_raw=True)
    dout = rpal.tile_layout(jnp.asarray(weight_image()), w, h, jcfg)
    dsteps = jbwd.composite_pallas_bwd(fields, schedule, raw, dout, w, h, jcfg, interpret=True)
    dpairs = np.asarray(jbwd.steps_to_pair_gradients(dsteps, binning, tiles_x * tiles_y, jcfg.chunk_size))
    want = dpairs.transpose(1, 0, 2).reshape(dpairs.shape[1], -1)  # (10, K) or (5, K) u32

    f10 = torch.from_numpy(np.asarray(fields).transpose(1, 0, 2).reshape(fields.shape[1], -1)[:10].copy())
    k = f10.shape[1]
    ts = torch.from_numpy(np.array(binning.tile_starts))
    # K3 walks each tile whole: one segment per tile, from the walk's start.
    _, _, ck = trc.composite_tiles_plain(f10, ts, w, h, cfg, checkpoints=True, segment_steps=tp.WHOLE_TILE_STEPS)
    got, done = tbwd.composite_bwd(
        f10, ts, torch.from_numpy(np.array(raw)), torch.from_numpy(np.array(dout)), torch.arange(k), w, h, cfg, ck,
    )
    assert got.shape == (10, k) and done.shape == (tiles_x * tiles_y,)
    if cfg.pack_grads_bf16:
        assert got.dtype == torch.bfloat16
        want_bits = (np.stack([want[i // 2] >> (16 * (i % 2)) for i in range(10)]) & 0xFFFF).astype(np.uint16)
        want_bf16 = torch.from_numpy(want_bits.view(np.int16)).view(torch.bfloat16)
        assert int((tbwd.bf16_order(got) - tbwd.bf16_order(want_bf16)).abs().max()) <= K3_BF16_ULPS
    else:
        got = got.numpy()
        for f in range(10):
            scale = max(np.abs(want[f]).max(), 1e-12)
            assert np.abs(got[f] - want[f]).max() / scale <= K3_REL_TO_MAX, f
            np.testing.assert_array_equal(got[f] != 0, want[f] != 0)


def test_k3_exit_and_determinism_match_k1():
    # K3 carries T as a product and makes its own max-T test (the TPU
    # kernel's rule); on tiles that saturate it stops where K1 stopped.
    _, cfg = tp.configs(pair_multiplier=24.0, chunk_size=64)
    tproj = tp.proj_to_torch(tp.saturating_projection())
    binning, fields, _ = bin_and_prepare(tproj, tp.WIDTH, tp.HEIGHT, cfg)
    raw, done, ck = trc.composite_tiles(fields, binning.tile_starts, tp.WIDTH, tp.HEIGHT, cfg, checkpoints=True)
    dout = trc.tile_layout(torch.from_numpy(weight_image()), tp.WIDTH, tp.HEIGHT, cfg)
    args = (fields, binning.tile_starts, raw, dout, binning.perm, tp.WIDTH, tp.HEIGHT, cfg, ck)
    grads, done_bwd = tbwd.composite_bwd(*args)
    counts = binning.tile_starts[1:] - binning.tile_starts[:-1]
    assert int((done < counts).sum()) >= counts.numel() // 3
    assert torch.equal(done_bwd, done)
    assert torch.equal(tbwd.composite_bwd(*args)[0], grads)
    # Slots of pairs past the exit, culled or unused hold exact zeros.
    walked = torch.zeros(grads.shape[1], dtype=torch.bool)
    for t in range(counts.numel()):
        s = int(binning.tile_starts[t])
        walked[binning.perm[s:s + int(done[t])]] = True
    assert (grads[:, ~walked] == 0).all() and (grads[:, walked] != 0).any()


# --------------------------------------------------------------------------
# K4 against the Pallas run-reduce kernel (tests/test_pallas.py:286-349).


def run_layout():
    """Splats 0..254 one slot, 255 two (a run across the 256 boundary),
    256..298 five, 299 forty: 512 slots of bf16-exact gradients."""
    n, k = 300, 512
    counts = np.zeros(n, np.int32)
    counts[:255], counts[255], counts[256:299], counts[299] = 1, 2, 5, 40
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    grads = np.random.default_rng(7).integers(-256, 256, size=(10, k)).astype(np.float32) / 8.0
    return n, k, counts, offsets, grads


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout", ["straddle", "truncated"])
def test_k4_plain_matches_run_reduce(layout, dtype):
    n, k, counts, offsets, grads = run_layout()
    budget = k if layout == "straddle" else 256  # truncated: splat 255 keeps 1 of 2, 256.. none
    g = torch.from_numpy(grads[:, :budget].copy())
    got = tbwd.run_reduce(g.to(torch.bfloat16) if dtype == "bf16" else g, torch.from_numpy(offsets)).numpy()
    want = np.zeros((10, n), np.float32)
    np.add.at(want.T, np.repeat(np.arange(n), counts)[:budget], grads[:, :budget].T)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got[:, 256:]).max() > 0 if layout == "straddle" else np.abs(got[:, 256:]).max() == 0
    if dtype == "bf16":
        bits = [jax.lax.bitcast_convert_type(jnp.asarray(r[:budget]).astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
                for r in grads]
        packed = tuple(bits[2 * i] | (bits[2 * i + 1] << 16) for i in range(5))
        ids = jnp.asarray(np.repeat(np.arange(n, dtype=np.int32), counts)[:budget])
        jax_sums = jbwd._run_reduce(packed, ids, jnp.asarray(np.minimum(offsets, budget)), n, 256, interpret=True)
        np.testing.assert_allclose(got, np.asarray(jax_sums), rtol=0, atol=1e-5)


def test_k4_plain_sums_runs_in_slot_order():
    # The plain version adds each run in slot order from 0, as the kernel
    # does: equal to a sequential float32 loop, bit for bit.
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 9, size=40).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    grads = rng.normal(size=(10, int(offsets[-1]) - 5)).astype(np.float32)  # last runs clipped
    got = tbwd.run_reduce(torch.from_numpy(grads), torch.from_numpy(offsets)).numpy()
    want = np.zeros((10, counts.size), np.float32)
    for i in range(counts.size):
        for j in range(min(offsets[i], grads.shape[1]), min(offsets[i + 1], grads.shape[1])):
            want[:, i] = want[:, i] + grads[:, j]
    np.testing.assert_array_equal(got, want)


def test_bwd_wrappers_reject_bad_inputs():
    _, cfg = tp.configs()
    tiles = 12
    fields = torch.zeros((10, 64))
    starts = torch.zeros(tiles + 1, dtype=torch.int32)
    buf = torch.zeros((tiles + 1, 4, 2048))
    perm = torch.arange(64)
    _, _, ck = trc.composite_tiles_plain(fields, starts, tp.WIDTH, tp.HEIGHT, cfg, checkpoints=True)
    tbwd.composite_bwd(fields, starts, buf, buf, perm, tp.WIDTH, tp.HEIGHT, cfg, ck)
    with pytest.raises(ValueError):
        tbwd.composite_bwd(fields[:9], starts, buf, buf, perm, tp.WIDTH, tp.HEIGHT, cfg, ck)
    with pytest.raises(ValueError):
        tbwd.composite_bwd(fields, starts, buf, buf, perm.int(), tp.WIDTH, tp.HEIGHT, cfg, ck)
    with pytest.raises(ValueError):
        tbwd.composite_bwd(fields, starts, buf[:, :3], buf, perm, tp.WIDTH, tp.HEIGHT, cfg, ck)
    with pytest.raises(ValueError):  # neither CPU (plain version) nor CUDA (kernel)
        meta_ck = tbwd.Checkpoints(*(x.to("meta") for x in ck[:3]), ck.segment_steps)
        tbwd.composite_bwd(*(x.to("meta") for x in (fields, starts, buf, buf, perm)), tp.WIDTH, tp.HEIGHT, cfg,
                           meta_ck)
    bounds = torch.tensor([0, 10, 64], dtype=torch.int32)
    assert tbwd.run_reduce(fields, bounds).shape == (10, 2)
    with pytest.raises(ValueError):
        tbwd.run_reduce(fields.double(), bounds)
    with pytest.raises(ValueError):
        tbwd.run_reduce(fields, bounds.long())
    with pytest.raises(ValueError):
        tbwd.run_reduce(fields.to("meta"), bounds.to("meta"))


def test_tile_layout_inverts_untile():
    cfg = tp.configs(tile_h=2, tile_w=4)[1]
    width, height = 7, 3  # 2 x 2 tiles, cropped
    img = torch.arange(height * width * 4, dtype=torch.float32).reshape(height, width, 4) + 1
    buf = trc.tile_layout(img, width, height, cfg)
    assert buf.shape == (5, 4, 8)
    assert torch.equal(trc.untile(buf, width, height, cfg), img)
    assert (buf[-1] == 0).all() and int((buf == 0).sum()) == buf.numel() - img.numel()


# --------------------------------------------------------------------------
# End to end: gradients w.r.t. the activated Gaussians.


def test_grad_fixture_is_current(jax_grads):
    # The card's parity phase reads this file; it must be what the JAX
    # package computes now.
    with np.load(GRAD_FIXTURE) as f:
        meta = json.loads(str(f["meta"]))
        assert meta["configs"] == json.loads(json.dumps(GRAD_CONFIGS))
        assert meta["tolerance"] == E2E_TOL and meta["weight_seed"] == WEIGHT_SEED
        for name, fields in jax_grads.items():
            for field, a in fields.items():
                np.testing.assert_array_equal(f[f"grad_{name}_{field}"], a, err_msg=f"{name} {field}")


@pytest.mark.parametrize("name", list(GRAD_CONFIGS))
def test_grads_match_jax(jax_grads, name):
    _, tcam = tp.cameras()
    cfg = tp.configs(**GRAD_CONFIGS[name])[1]
    got = port_gaussian_grads(tp.jax_scene(), tcam, cfg, weight_image())
    assert_grads_close(got, jax_grads[name], E2E_TOL[name])


def test_center_probe_grad_matches_jax():
    # The probe's gradient is the screen-space positional gradient.
    jcam, tcam = tp.cameras(width=96, height=64)
    raw = tp.jax_scene(n=300, seed=4)
    wt = weight_image(64, 96)
    jcfg, cfg = tp.configs()
    probe = np.zeros((300, 2), np.float32)

    def jloss(p):
        img, _ = jrd.render_with_stats(raw.activate(), jcam, JaxRenderSettings(sh_order=3), jcfg,
                                       backend="pallas", center_probe=p)
        return jnp.sum(img * wt)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(probe)))
    p = torch.from_numpy(probe).requires_grad_(True)
    img = trd.render(tp.port_scene(raw).activate(), tcam, RenderSettings(sh_order=3), cfg, center_probe=p,
                     device="cpu")
    (img * torch.from_numpy(wt)).sum().backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------------------
# The port on its own (tests/test_gradients.py, tests/test_pallas.py).

# Finite differences need a smooth forward pass (tests/test_gradients.py:37-39).
SMOOTH = RasterizeConfig(quad_clip=False, alpha_discard=0.0, pack_color_f16=False)
PSEUDO_TARGET = torch.tensor([0.3, 0.5, 0.2, 0.7])


@pytest.fixture(scope="module")
def fd_camera():
    from unitygaussiansplatting_torch.models.camera import Camera

    return Camera.look_at([0.0, 0.3, -2.6], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 50.0, 48, 32)


def pseudo_loss(raw, camera, backend, config=SMOOTH):
    img = trd.render(raw.activate(), camera, RenderSettings(sh_order=1), config, backend=backend, device="cpu")
    return torch.sum(img * PSEUDO_TARGET)


def leaf_copy(raw):
    return RawGaussians(**{f: getattr(raw, f).detach().clone().requires_grad_(True) for f in RAW_FIELDS})


def raw_grads(raw, camera, backend, config):
    r = leaf_copy(raw)
    pseudo_loss(r, camera, backend, config).backward()
    return {f: getattr(r, f).grad.numpy() for f in RAW_FIELDS}


@pytest.mark.parametrize("field", ["means", "log_scales", "opacity_logits", "sh0", "rotations_wxyz", "sh"])
def test_reference_grad_matches_finite_diff(fd_camera, field):
    # tests/test_gradients.py:55-110 on the port's oracle backend, with its
    # tolerances: geometry moves footprints across tile edges and clamps.
    raw = sphere_scene(n=60, seed=3)
    g = raw_grads(raw, fd_camera, "reference", SMOOTH)[field]
    assert np.isfinite(g).all()
    rng = np.random.default_rng(0)
    eps = 3e-3
    base = getattr(raw, field).numpy()

    def f0(arr):
        r = dataclasses.replace(raw, **{field: torch.from_numpy(arr)})
        with torch.no_grad():
            return float(pseudo_loss(r, fd_camera, "reference"))

    geometry = field in ("means", "log_scales", "rotations_wxyz")
    rel_tol = 0.15 if geometry else 0.06
    max_outliers = 1 if geometry or field in ("sh", "sh0") else 0
    failures = []
    for i in rng.choice(g.size, size=min(6, g.size), replace=False):
        hi, lo = base.copy(), base.copy()
        hi.flat[i] += eps
        lo.flat[i] -= eps
        fd = (f0(hi) - f0(lo)) / (2 * eps)
        an = g.flat[i]
        if abs(fd) < 1e-4 and abs(an) < 1e-4:
            continue
        if abs(fd - an) / max(abs(fd), abs(an), 1e-2) >= rel_tol:
            failures.append(f"{field}[{i}]: finite-diff {fd} vs autograd {an}")
    assert len(failures) <= max_outliers, "; ".join(failures)
    assert np.abs(g).max() > 1e-6


def test_cuda_backend_grads_match_reference(fd_camera):
    # tests/test_gradients.py:113-123: with the quad clip on, the tile
    # pipeline's binning covers every quad, so both backends compute one
    # function and their gradients agree.
    raw = sphere_scene(n=60, seed=3)
    cfg = RasterizeConfig()
    tiles = raw_grads(raw, fd_camera, "cuda", cfg)
    ref = raw_grads(raw, fd_camera, "reference", cfg)
    for field in ("means", "log_scales", "opacity_logits", "sh0"):
        np.testing.assert_allclose(tiles[field], ref[field], rtol=1e-3, atol=1e-4, err_msg=field)


def test_rgba8_gradients_pass_straight_through():
    # tests/test_pallas.py:115-132: the RGBA8 lattice passes gradients
    # straight through; the quantized render's are close to the plain one's.
    _, tcam = tp.cameras()

    def color_grad(cfg):
        g = sphere_scene(n=1500, seed=0).activate()
        g.base_color.requires_grad_(True)
        torch.mean(trd.render(g, tcam, RenderSettings(sh_order=0), cfg, device="cpu")).backward()
        return g.base_color.grad

    n8 = float(torch.linalg.vector_norm(color_grad(RasterizeConfig(pack_color_rgba8=True))))
    nf = float(torch.linalg.vector_norm(color_grad(RasterizeConfig())))
    assert np.isfinite(n8) and n8 > 0
    assert 0.5 < n8 / nf < 2.0, (n8, nf)


def test_axes_u32_grads_finite_and_close():
    # tests/test_pallas.py:192-209: the u32 axis lattice is straight-through.
    _, tcam = tp.cameras()
    raw = sphere_scene(n=600, seed=2)

    def grads(cfg):
        r = leaf_copy(raw)
        torch.mean(trd.render(r.activate(), tcam, config=cfg, device="cpu")).backward()
        return {f: getattr(r, f).grad.numpy() for f in ("means", "log_scales", "opacity_logits", "sh0")}

    g0, g1 = grads(RasterizeConfig()), grads(RasterizeConfig(pack_axes_u32=True))
    for f in g0:
        assert np.isfinite(g1[f]).all(), f
        rel = np.abs(g1[f] - g0[f]).max() / max(np.abs(g0[f]).max(), 1e-12)
        assert rel < 0.05, (f, rel)


def test_padded_isotropic_splats_have_zero_finite_grads():
    # tests/test_gradients.py:352-378, with the padding built as the JAX
    # package's densify.pad_to_capacity builds it: zero means and sh,
    # opacity logits and log-scales of -20, identity rotations.
    from unitygaussiansplatting_torch.models.camera import Camera

    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 64, 32)
    cfg = RasterizeConfig(tile_h=8, chunk_size=32)
    raw = sphere_scene(n=100, seed=2)
    pad = 156
    filler = {f: torch.zeros((pad,) + getattr(raw, f).shape[1:]) for f in RAW_FIELDS}
    filler["opacity_logits"] -= 20.0
    filler["log_scales"] -= 20.0
    filler["rotations_wxyz"][:, 0] = 1.0
    padded = RawGaussians(**{f: torch.cat([getattr(raw, f), filler[f]]).requires_grad_(True) for f in RAW_FIELDS})
    img = trd.render(padded.activate(), cam, RenderSettings(sh_order=1), cfg, device="cpu")
    photometric_loss(img[..., :3], torch.zeros((32, 64, 3)), ssim_weight=0.2).backward()
    for f in RAW_FIELDS:
        g = getattr(padded, f).grad
        assert torch.isfinite(g).all(), f
        assert float(g[100:].abs().max()) == 0.0, f
    assert float(padded.means.grad[:100].abs().max()) > 0


if __name__ == "__main__":
    write_grad_fixture(jax_fixture_grads())
    print(f"wrote {GRAD_FIXTURE}")
