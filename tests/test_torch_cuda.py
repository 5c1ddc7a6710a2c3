"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and one backward through ``render`` on the card against the CPU.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed
(the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as pe  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as rc  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda_bwd as rb  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import depth_key_bits, pair_budget, tile_grid  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import project_splats  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402

# The scene and camera of tests/test_pallas.py:16-26.
WIDTH, HEIGHT = 192, 128
HEADLINE = dict(pair_multiplier=4.0, chunk_size=256, pack_axes_u32=True, pack_center_u32=True,
                pack_color_rgba8=True)
CONFIGS = {"default": {}, "small-tiles": dict(tile_h=8, chunk_size=64), "headline": HEADLINE}
BWD_CONFIGS = dict(CONFIGS, **{"headline-bf16": dict(HEADLINE, pack_grads_bf16=True)})
FIELD_TOL = dict(rtol=1e-6, atol=1e-6)
K1_ATOL = 5e-6  # tests/test_pallas.py:49
# K3 vs its plain version: rasterize_cuda_bwd.k3_distance and its bars.
# One backward through render, card vs CPU plain versions, per field
# relative to the field's max (the CPU tests hold the plain path to JAX).
# bf16: a pair gradient one bf16 step apart moves its splat by up to 2^-8 of
# that pair's value.
E2E_REL_TO_MAX = {"default": 1e-4, "headline-bf16": 1e-2}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def pipeline_inputs(device, cfg):
    g = sphere_scene(n=1500, seed=0).to(device).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
    proj = project_splats(g, cam)
    table, bounds, _ = pe.prepare_table(proj, WIDTH, HEIGHT, cfg)
    return table, bounds, pair_budget(table.shape[1], cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_k2_kernel_matches_plain(device, name):
    cfg = RasterizeConfig(**CONFIGS[name])
    table, bounds, k = pipeline_inputs(device, cfg)
    before = pe.expand_pairs.launches
    comp, fields = pe.expand_pairs(table, bounds, k, WIDTH, HEIGHT, cfg)
    comp_p, fields_p = pe.expand_pairs_plain(table, bounds, k, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert pe.expand_pairs.launches == before + 1
    assert torch.equal(comp, comp_p)
    torch.testing.assert_close(fields, fields_p, **FIELD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_k1_kernel_matches_plain(device, name):
    cfg = RasterizeConfig(**CONFIGS[name])
    table, bounds, k = pipeline_inputs(device, cfg)
    tiles_x, tiles_y = tile_grid(WIDTH, HEIGHT, cfg)
    num_tiles = tiles_x * tiles_y
    comp, fields = pe.expand_pairs_plain(table, bounds, k, WIDTH, HEIGHT, cfg)
    _, fields_s, starts, _ = pe.sort_pairs(comp, fields, num_tiles, depth_key_bits(num_tiles))
    before = rc.composite_tiles.launches
    raw, done = rc.composite_tiles(fields_s, starts, WIDTH, HEIGHT, cfg)
    raw_p, done_p = rc.composite_tiles_plain(fields_s, starts, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert rc.composite_tiles.launches == before + 1
    torch.testing.assert_close(raw, raw_p, rtol=0, atol=K1_ATOL)
    assert torch.equal(done, done_p)


def backward_inputs(device, cfg):
    table, bounds, k = pipeline_inputs(device, cfg)
    tiles_x, tiles_y = tile_grid(WIDTH, HEIGHT, cfg)
    num_tiles = tiles_x * tiles_y
    comp, fields = pe.expand_pairs_plain(table, bounds, k, WIDTH, HEIGHT, cfg)
    _, fields_s, starts, perm = pe.sort_pairs(comp, fields, num_tiles, depth_key_bits(num_tiles))
    raw, done = rc.composite_tiles_plain(fields_s, starts, WIDTH, HEIGHT, cfg)
    gen = torch.Generator(device=device).manual_seed(5)
    dout = torch.randn((num_tiles + 1, 4, cfg.tile_w * cfg.tile_h), generator=gen, device=device)
    dout[-1] = 0.0
    return (fields_s, starts, raw, dout, perm), done, bounds


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BWD_CONFIGS))
def test_k3_kernel_matches_plain(device, name):
    cfg = RasterizeConfig(**BWD_CONFIGS[name])
    args, done_fwd, _ = backward_inputs(device, cfg)
    before = rb.composite_bwd.launches
    grads, done = rb.composite_bwd(*args, WIDTH, HEIGHT, cfg)
    again, _ = rb.composite_bwd(*args, WIDTH, HEIGHT, cfg)
    plain, done_p = rb.composite_bwd_plain(*args, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert rb.composite_bwd.launches == before + 2
    assert torch.equal(grads.view(torch.int16) if cfg.pack_grads_bf16 else grads,
                       again.view(torch.int16) if cfg.pack_grads_bf16 else again)  # no atomics
    assert torch.equal(done, done_p) and torch.equal(done, done_fwd)
    assert grads.dtype == (torch.bfloat16 if cfg.pack_grads_bf16 else torch.float32)
    distance, limit = rb.k3_distance(grads, plain)
    assert distance <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["default", "headline"])
def test_k4_kernel_matches_plain(device, name, dtype):
    cfg = RasterizeConfig(**BWD_CONFIGS[name])
    args, _, bounds = backward_inputs(device, cfg)
    dpairs = rb.composite_bwd_plain(*args, WIDTH, HEIGHT, cfg)[0].to(dtype)
    for budget in (dpairs.shape[1], int(bounds[-1]) // 2):  # and truncated
        g = dpairs[:, :budget].contiguous()
        before = rb.run_reduce.launches
        got = rb.run_reduce(g, bounds)
        want = rb.run_reduce_plain(g, bounds)
        torch.cuda.synchronize()
        assert rb.run_reduce.launches == before + 1
        assert torch.equal(got, want)  # both add each run in slot order


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "headline-bf16"])
def test_backward_on_card_matches_cpu(device, name):
    cfg = RasterizeConfig(**BWD_CONFIGS[name])
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    wt = torch.randn((HEIGHT, WIDTH, 4), generator=torch.Generator().manual_seed(5))
    fields = ("means", "rotations", "scales", "opacities", "base_color", "sh")
    grads = {}
    for dev in ("cpu", device):
        g = sphere_scene(n=1500, seed=0).activate()
        g = Gaussians(**{f: getattr(g, f).to(dev).requires_grad_(True) for f in fields})
        before = rb.composite_bwd.launches, rb.run_reduce.launches
        loss = (render(g, cam, config=cfg, device=dev) * wt.to(dev)).sum()
        loss.backward()
        if dev != "cpu":
            assert (rb.composite_bwd.launches, rb.run_reduce.launches) == (before[0] + 1, before[1] + 1)
        grads[dev] = {f: getattr(g, f).grad.cpu() for f in fields}
    for f in fields:
        want, got = grads["cpu"][f], grads[device][f]
        assert torch.isfinite(got).all(), f
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= E2E_REL_TO_MAX[name] * scale, f
