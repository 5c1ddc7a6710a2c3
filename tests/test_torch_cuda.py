"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed
(the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as pe  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as rc  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import depth_key_bits, pair_budget, tile_grid  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import project_splats  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402

# The scene and camera of tests/test_pallas.py:16-26.
WIDTH, HEIGHT = 192, 128
HEADLINE = dict(pair_multiplier=4.0, chunk_size=256, pack_axes_u32=True, pack_center_u32=True,
                pack_color_rgba8=True)
CONFIGS = {"default": {}, "small-tiles": dict(tile_h=8, chunk_size=64), "headline": HEADLINE}
FIELD_TOL = dict(rtol=1e-6, atol=1e-6)
K1_ATOL = 5e-6  # tests/test_pallas.py:49


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def pipeline_inputs(device, cfg):
    g = sphere_scene(n=1500, seed=0).to(device).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
    proj = project_splats(g, cam)
    table, bounds, _, _ = pe.prepare_table(proj, WIDTH, HEIGHT, cfg)
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
    _, fields_s, starts = pe.sort_pairs(comp, fields, num_tiles, depth_key_bits(num_tiles))
    before = rc.composite_tiles.launches
    raw, done = rc.composite_tiles(fields_s, starts, WIDTH, HEIGHT, cfg)
    raw_p, done_p = rc.composite_tiles_plain(fields_s, starts, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert rc.composite_tiles.launches == before + 1
    torch.testing.assert_close(raw, raw_p, rtol=0, atol=K1_ATOL)
    assert torch.equal(done, done_p)
