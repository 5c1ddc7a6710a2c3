"""The port's CUDA kernels against their plain PyTorch versions, on the card,
one backward through ``render`` on the card against the CPU, and the import
pipeline's device steps (the Morton order against its plain version, the
k-means bit for bit across runs and near the CPU's), the debug point
modes on the card equal to the CPU's, the tile path (``backend="torch"``)
on the card against the CPU, strips on a world of one NCCL rank, and the
``train_splats`` program's first steps on the card against the CPU.  K2's
operands come from a per-splat kernel, and K2 runs in windows of slots; K1
runs as clusters of CTAs and saves K3's checkpoints; K3 runs one block per
segment from them.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed
(the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.ops import cuda_build  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as pe  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as rc  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda_bwd as rb  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import depth_key_bits, pair_budget, tile_grid  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import ProjectedSplats, project_splats  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402

# The scene and camera of tests/test_pallas.py:16-26.
WIDTH, HEIGHT = 192, 128
HEADLINE = dict(pair_multiplier=4.0, chunk_size=256, pack_axes_u32=True, pack_center_u32=True,
                pack_color_rgba8=True)
CONFIGS = {"default": {}, "small-tiles": dict(tile_h=8, chunk_size=64), "headline": HEADLINE}
# The per-splat pass under every lattice it rounds to.
TABLE_CONFIGS = dict(CONFIGS, **{
    "axes-f16": dict(pack_axes_f16=True), "color-rgba8": dict(pack_color_rgba8=True),
    "axes-u32": dict(pack_axes_u32=True), "center-f16": dict(pack_center_u32=True, pack_axes_f16=True),
    "no-discard": dict(alpha_discard=0.0),
})
# Edge scenes of both K2 passes, each with its config: every splat culled
# (zero opacity), every splat behind the camera, NaN and infinite geometry
# with a strided depth, an overflowing budget, one splat, fewer splats than
# K2's 512-slot window, and splats larger than the frame on the 768 tiles of
# 8x4 (runs longer than a window; the budget also ends inside one of them).
EDGE_SCENES = {
    "empty": {}, "behind-camera": HEADLINE, "nan": HEADLINE, "overflow": dict(pair_multiplier=0.5),
    "one-splat": HEADLINE, "fewer-than-a-window": {},
    "larger-than-frame": dict(tile_w=8, tile_h=4, chunk_size=32, pair_multiplier=8.0),
    "overflow-in-long-run": dict(tile_w=8, tile_h=4, chunk_size=32, pair_multiplier=0.5),
}
K2_WINDOW = 512  # csrc/pair_expand.cu's kWindow
# 64x2 = 128 px: a cluster of 4 CTAs (8 would leave each less than a warp);
# chunk 1024: a 48 KB stage beside the static exit flags.
K1_CONFIGS = dict(CONFIGS, **{"tiles-64x2": dict(tile_h=2, chunk_size=32), "chunk-1024": dict(chunk_size=1024)})
K1_CLUSTER = {"default": 8, "small-tiles": 8, "headline": 8, "tiles-64x2": 4, "chunk-1024": 8}
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


def sphere_projection(device, target=(0, 0, 0)):
    g = sphere_scene(n=1500, seed=0).to(device).activate()
    cam = Camera.look_at([0, 0.5, -3.0], list(target), [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
    return project_splats(g, cam)


def pipeline_inputs(device, cfg):
    table, bounds, _ = pe.prepare_table(sphere_projection(device), WIDTH, HEIGHT, cfg)
    return table, bounds, pair_budget(table.shape[1], cfg)


def nan_projection(device):
    """The sphere's projection with NaN and infinite entries (behind-camera
    splats), some still marked valid, and its depth a strided view."""
    proj = ProjectedSplats(*(x.clone() for x in sphere_projection(device)))
    proj.center[::7] = float("nan")
    proj.valid[::7] = False
    proj.axis1[3::11] = float("nan")
    proj.center[5::13, 1] = float("inf")
    proj.opacity[2::17] = float("nan")
    return proj._replace(depth=torch.stack([proj.depth] * 3, -1)[:, 1])


def larger_than_frame(proj, splats):
    """The sphere's projection with ``splats`` stretched over the whole
    frame, every splat valid and nearly opaque."""
    axis1, axis2 = proj.axis1.clone(), proj.axis2.clone()
    axis1[splats] = torch.tensor([400.0, 0.0], device=axis1.device)
    axis2[splats] = torch.tensor([0.0, -300.0], device=axis2.device)
    return proj._replace(axis1=axis1, axis2=axis2, opacity=torch.full_like(proj.opacity, 0.9),
                         valid=torch.ones_like(proj.valid))


def edge_scene(device, scene):
    """``(projection, config)`` of one of EDGE_SCENES."""
    cfg = RasterizeConfig(**EDGE_SCENES[scene])
    proj = sphere_projection(device)
    if scene == "empty":
        proj = proj._replace(opacity=torch.zeros_like(proj.opacity))
    elif scene == "behind-camera":
        proj = sphere_projection(device, target=(0, 0.5, -6.0))  # looking away from the cloud
    elif scene == "nan":
        proj = nan_projection(device)
    elif scene == "one-splat":
        proj = ProjectedSplats(*(x[40:41] for x in proj))
    elif scene == "fewer-than-a-window":
        proj = ProjectedSplats(*(x[:100] for x in proj))
    elif scene == "larger-than-frame":
        proj = larger_than_frame(proj, [7, 8, 900])
    elif scene == "overflow-in-long-run":
        proj = larger_than_frame(proj, [50, 1200])
    return proj, cfg


def assert_table_matches_plain(proj, cfg):
    """The per-splat kernel against its plain version: the table bit for
    bit, the run bounds and the real pair count exact; returns the kernel's
    ``(table, bounds, num_real)``."""
    before = pe.prepare_table.launches
    table, bounds, real = pe.prepare_table(proj, WIDTH, HEIGHT, cfg)
    table_p, bounds_p, real_p = pe.prepare_table_plain(proj, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert pe.prepare_table.launches == before + 1
    assert table.shape == table_p.shape and table.is_contiguous()
    assert torch.equal(table.view(torch.int32), table_p.view(torch.int32))
    assert bounds.dtype == torch.int32 and torch.equal(bounds, bounds_p)
    assert real.dtype == torch.int32 and int(real) == int(real_p)
    assert bool(torch.isfinite(table).all())
    return table, bounds, real


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TABLE_CONFIGS))
def test_prepare_table_kernel_matches_plain(device, name):
    assert_table_matches_plain(sphere_projection(device), RasterizeConfig(**TABLE_CONFIGS[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(EDGE_SCENES) + ["no-splats"])
def test_prepare_table_kernel_edge_scenes(device, scene):
    if scene == "no-splats":
        proj, cfg = ProjectedSplats(*(x[:0] for x in sphere_projection(device))), RasterizeConfig()
    else:
        proj, cfg = edge_scene(device, scene)
    table, bounds, real = assert_table_matches_plain(proj, cfg)
    n = proj.depth.shape[0]
    runs = bounds[1:] - bounds[:-1]
    if scene in ("empty", "behind-camera", "no-splats"):
        assert int(real) == 0 and bool((runs == 1).all()) and int(bounds[-1]) == n
    if scene == "behind-camera":
        assert not bool(proj.valid.any())
    if scene.startswith("larger-than-frame") or scene == "overflow-in-long-run":
        assert int(runs.max()) == 768 > K2_WINDOW


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS) + list(EDGE_SCENES) + ["odd-k"])
def test_k2_kernel_matches_plain(device, name):
    # Windowed K2 against the plain K2 on the per-splat kernel's table.
    if name in CONFIGS or name == "odd-k":
        proj, cfg = sphere_projection(device), RasterizeConfig(**CONFIGS.get(name, HEADLINE))
    else:
        proj, cfg = edge_scene(device, name)
    table, bounds, _ = assert_table_matches_plain(proj, cfg)
    n = table.shape[1]
    # odd-k: a budget that is no multiple of the window, nor of four.
    k = 4 * K2_WINDOW + 3 if name == "odd-k" else pair_budget(n, cfg)
    before = pe.expand_pairs.launches
    comp, fields = pe.expand_pairs(table, bounds, k, WIDTH, HEIGHT, cfg)
    comp_p, fields_p = pe.expand_pairs_plain(table, bounds, k, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert pe.expand_pairs.launches == before + 1
    assert torch.equal(comp, comp_p)
    torch.testing.assert_close(fields, fields_p, **FIELD_TOL)
    demand = int(bounds[-1])
    if name.startswith("overflow"):
        assert demand > k
    if name == "overflow-in-long-run":
        assert int(bounds[50]) < k < int(bounds[51])  # the budget ends inside the long run
    if name in ("one-splat", "fewer-than-a-window"):
        assert n < K2_WINDOW < k


def sorted_inputs(device, cfg):
    table, bounds, k = pipeline_inputs(device, cfg)
    tiles_x, tiles_y = tile_grid(WIDTH, HEIGHT, cfg)
    num_tiles = tiles_x * tiles_y
    comp, fields = pe.expand_pairs_plain(table, bounds, k, WIDTH, HEIGHT, cfg)
    _, fields_s, starts, perm = pe.sort_pairs(comp, fields, num_tiles, depth_key_bits(num_tiles))
    return fields_s, starts, perm, bounds


def assert_k1_matches_plain(fields, starts, width, height, cfg, segment_steps=rb.SEGMENT_STEPS):
    """K1 and its checkpoints against the plain version's; returns the
    kernel's ``(raw, pairs_done, checkpoints)``."""
    before = rc.composite_tiles.launches
    raw, done, ck = rc.composite_tiles(fields, starts, width, height, cfg, checkpoints=True,
                                       segment_steps=segment_steps)
    raw_p, done_p, ck_p = rc.composite_tiles_plain(fields, starts, width, height, cfg, checkpoints=True,
                                                   segment_steps=segment_steps)
    torch.cuda.synchronize()
    assert rc.composite_tiles.launches == before + 1
    torch.testing.assert_close(raw, raw_p, rtol=0, atol=K1_ATOL)
    assert torch.equal(done, done_p)
    assert torch.equal(ck.seg_starts, ck_p.seg_starts) and ck.state.shape == ck_p.state.shape
    _, pairs = rb.segment_pairs(starts, ck, cfg.chunk_size)
    reached = pairs > 0  # written by both
    torch.testing.assert_close(ck.state[reached], ck_p.state[reached], rtol=0, atol=K1_ATOL)
    return raw, done, ck


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K1_CONFIGS))
def test_k1_kernel_matches_plain(device, name):
    cfg = RasterizeConfig(**K1_CONFIGS[name])
    fields_s, starts, _, _ = sorted_inputs(device, cfg)
    assert cuda_build.library("composite_fwd").composite_fwd_cluster_size(cfg.tile_w * cfg.tile_h) == K1_CLUSTER[name]
    for steps in (1, rb.SEGMENT_STEPS):
        assert_k1_matches_plain(fields_s, starts, WIDTH, HEIGHT, cfg, steps)
    # Without checkpoints: the same image, nothing saved.
    before = rc.composite_tiles.launches
    raw, done, none = rc.composite_tiles(fields_s, starts, WIDTH, HEIGHT, cfg)
    raw_p, done_p, _ = rc.composite_tiles_plain(fields_s, starts, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert rc.composite_tiles.launches == before + 1 and none is None
    torch.testing.assert_close(raw, raw_p, rtol=0, atol=K1_ATOL)
    assert torch.equal(done, done_p)


def backward_inputs(device, cfg, segment_steps=rb.SEGMENT_STEPS):
    fields_s, starts, perm, bounds = sorted_inputs(device, cfg)
    raw, done, ck = rc.composite_tiles(fields_s, starts, WIDTH, HEIGHT, cfg, checkpoints=True,
                                       segment_steps=segment_steps)
    gen = torch.Generator(device=device).manual_seed(5)
    dout = torch.randn((raw.shape[0], 4, cfg.tile_w * cfg.tile_h), generator=gen, device=device)
    dout[-1] = 0.0
    return (fields_s, starts, raw, dout, perm), ck, bounds


def assert_k3_matches_plain(args, ck, width, height, cfg):
    """K3 from K1's checkpoints against its plain version from the same
    ones: within ``k3_distance``'s bars, two launches bit-identical, its exits
    K1's."""
    before = rb.composite_bwd.launches
    grads, done = rb.composite_bwd(*args, width, height, cfg, checkpoints=ck)
    again, _ = rb.composite_bwd(*args, width, height, cfg, checkpoints=ck)
    plain, done_p = rb.composite_bwd_plain(*args, width, height, cfg, checkpoints=ck)
    torch.cuda.synchronize()
    assert rb.composite_bwd.launches == before + 2
    assert torch.equal(grads.view(torch.int16) if cfg.pack_grads_bf16 else grads,
                       again.view(torch.int16) if cfg.pack_grads_bf16 else again)  # no atomics
    assert torch.equal(done, done_p) and torch.equal(done, ck.pairs_done)
    assert grads.dtype == (torch.bfloat16 if cfg.pack_grads_bf16 else torch.float32)
    distance, limit = rb.k3_distance(grads, plain)
    assert distance <= limit
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BWD_CONFIGS))
def test_k3_kernel_matches_plain(device, name):
    cfg = RasterizeConfig(**BWD_CONFIGS[name])
    for steps in (1, rb.SEGMENT_STEPS):
        args, ck, _ = backward_inputs(device, cfg, steps)
        if steps == 1:
            assert int((ck.seg_starts[1:] - ck.seg_starts[:-1]).max()) >= 3
        assert_k3_matches_plain(args, ck, WIDTH, HEIGHT, cfg)


def one_tile_projection(device, n=3000, seed=3):
    """Small, faint splats packed inside the first 64x32 tile, a few
    elsewhere: one tile holds nearly all pairs and walks ~24 steps."""
    gen = torch.Generator().manual_seed(seed)
    crowd = torch.rand((n, 2), generator=gen) * torch.tensor([48.0, 16.0]) + 8.0
    rest = torch.rand((20, 2), generator=gen) * torch.tensor([WIDTH - 16.0, HEIGHT - 16.0]) + 8.0
    m = n + 20
    radius = torch.rand(m, generator=gen) * 2.0 + 1.5
    theta = torch.rand(m, generator=gen) * 3.14159
    a1 = torch.stack([torch.cos(theta), torch.sin(theta)], -1) * radius[:, None]
    a2 = torch.stack([torch.sin(theta), -torch.cos(theta)], -1) * (0.7 * radius)[:, None]
    proj = ProjectedSplats(
        depth=torch.rand(m, generator=gen) + 1.0, center=torch.cat([crowd, rest]), axis1=a1, axis2=a2,
        conic=torch.zeros((m, 3)), color=torch.rand((m, 3), generator=gen),
        opacity=torch.rand(m, generator=gen) * 0.02 + 0.01, valid=torch.ones(m, dtype=torch.bool),
    )
    return ProjectedSplats(*(x.to(device) for x in proj))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["empty", "one-tile"])
def test_k1_k3_edge_scenes_match_plain(device, scene):
    cfg = RasterizeConfig(pair_multiplier=8.0, pack_grads_bf16=False)
    if scene == "empty":
        g = sphere_scene(n=256, seed=1).to(device).activate()
        g.opacities.zero_()
        cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
        proj = project_splats(g, cam)
    else:
        proj = one_tile_projection(device)
    binning, fields, _ = pe.bin_and_prepare(proj, WIDTH, HEIGHT, cfg)
    counts = binning.tile_starts[1:] - binning.tile_starts[:-1]
    if scene == "one-tile":
        assert int(counts[0]) > 0.95 * int(counts.sum()) and int(counts[0]) > 20 * cfg.chunk_size
    raw, done, ck = assert_k1_matches_plain(fields, binning.tile_starts, WIDTH, HEIGHT, cfg, segment_steps=2)
    gen = torch.Generator(device=device).manual_seed(5)
    dout = torch.randn(raw.shape, generator=gen, device=device)
    dout[-1] = 0.0
    args = (fields, binning.tile_starts, raw, dout, binning.perm)
    grads = assert_k3_matches_plain(args, ck, WIDTH, HEIGHT, cfg)
    if scene == "empty":
        assert (raw == 0).all() and (done == 0).all() and (grads == 0).all()
    else:
        assert int(done[0]) > 0 and bool(grads.abs().amax() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1_000_003, 1 << 20])  # scalar stores, then 16- and 8-byte ones
@pytest.mark.parametrize("keys_only", [False, True])
def test_expand_probe_writes_zeros(device, keys_only, k):
    before = pe.expand_probe.launches
    comp, fields = pe.expand_probe(k, device, keys_only=keys_only)
    torch.cuda.synchronize()
    assert pe.expand_probe.launches == before + 1
    assert comp.shape == (k,) and not comp.any()
    assert fields is None if keys_only else (fields.shape == (10, k) and not fields.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["default", "headline"])
def test_k4_kernel_matches_plain(device, name, dtype):
    cfg = RasterizeConfig(**BWD_CONFIGS[name])
    args, ck, bounds = backward_inputs(device, cfg)
    dpairs = rb.composite_bwd_plain(*args, WIDTH, HEIGHT, cfg, checkpoints=ck)[0].to(dtype)
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2_000_000, 4097])
def test_morton_order_on_card_matches_plain(device, n):
    import numpy as np

    from unitygaussiansplatting_torch.ops import morton

    rng = np.random.default_rng(n)
    pos = (rng.normal(size=(n, 3)) * [4.0, 1.5, 4.0]).astype(np.float32)
    pos[: n // 4] = pos[n // 4 : n // 2]  # repeated points: equal codes keep their input order
    got = morton.morton_order(pos, device=device)
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), morton.morton_order_plain(pos))


@pytest.mark.cuda
def test_kmeans_on_card_is_deterministic_and_matches_cpu(device):
    from unitygaussiansplatting_torch.io import kmeans

    gen = torch.Generator().manual_seed(0)
    data = 0.1 * torch.randn((60_000, 45), generator=gen)
    draws = (torch.randint(0, 60_000, (3, 4096), generator=gen), torch.randint(0, 60_000, (4096,), generator=gen),
             torch.randint(0, 60_000, (16, 8192), generator=gen))
    runs = [kmeans.fit_kmeans_from_draws(data.to(device), *(d.to(device) for d in draws), k=4096, k_chunk=1024)
            for _ in range(2)]
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))  # bit for bit
    cpu = kmeans.fit_kmeans_from_draws(data, *draws, k=4096, k_chunk=1024)
    assert float((runs[0].cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())
    table, idx = kmeans.cluster_sh(data.reshape(-1, 15, 3), k=4096, iters=8, device=device)
    again, idx_again = kmeans.cluster_sh(data.reshape(-1, 15, 3), k=4096, iters=8, device=device)
    assert torch.equal(table, again) and torch.equal(idx, idx_again)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["points", "points-by-index", "chunk-bounds"])
def test_debug_points_on_card_equal_cpu(device, mode):
    # The goldens' scene and camera; the cloud activated on the host, so that
    # both devices start from the same values.  The scatter's winner per
    # pixel is explicit, so the card's image is the CPU's bit for bit.
    from unitygaussiansplatting_torch.models import debug_render as dr

    g = sphere_scene(n=2000, seed=0).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 256, 160)
    fn, kw = {"points": (dr.render_debug_points, {}), "points-by-index": (dr.render_debug_points, dict(by_index=True)),
              "chunk-bounds": (dr.render_debug_chunk_bounds, dict(chunk_size=64))}[mode]
    want = fn(g, cam, device="cpu", **kw)
    got = fn(g, cam, device=device, **kw)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "small-tiles", "overflow"])
def test_bin_splats_on_card_equals_cpu(device, name):
    from unitygaussiansplatting_torch.ops.binning import bin_splats

    cfg = RasterizeConfig(**{"default": {}, "small-tiles": CONFIGS["small-tiles"],
                             "overflow": dict(pair_multiplier=0.5)}[name])
    g = sphere_scene(n=1500, seed=0).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    proj = project_splats(g, cam)
    want = bin_splats(proj, WIDTH, HEIGHT, cfg)
    got = bin_splats(ProjectedSplats(*(x.to(device) for x in proj)), WIDTH, HEIGHT, cfg)
    for field in ("pair_rank", "pair_tile", "depth_order", "rank_counts", "tile_starts", "num_pairs"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


@pytest.mark.cuda
def test_render_torch_backend_on_card_matches_cpu(device):
    g = sphere_scene(n=1500, seed=0).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    want = render(g, cam, backend="torch", device="cpu")
    got = render(g, cam, backend="torch", device=device).cpu()
    assert float((got - want).abs().max()) <= K1_ATOL


@pytest.mark.cuda
def test_train_splats_steps_on_card_match_cpu(device):
    # The program's own scene, frame and small-tile config (tiles of 64x8,
    # 64-pair steps), three steps on each device.
    from unitygaussiansplatting_torch.examples import train_splats

    want = train_splats.run(None, steps=3, device="cpu")["losses"]
    got = train_splats.run(None, steps=3, device=device)["losses"]
    assert len(got) == len(want) == 3
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(got, want)), (got, want)


@pytest.mark.cuda
def test_nccl_world_of_one_strips_equal_render(device):
    import torch.distributed as dist

    from unitygaussiansplatting_torch import parallel
    from unitygaussiansplatting_torch.parallel.strips import render_strips_fn

    g = sphere_scene(n=1500, seed=0).to(device).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
    parallel.initialize()
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = parallel.make_pod_mesh()
        for backend in ("cuda", "torch"):
            # One rank: the strip is the whole frame (128 rows, 4 tiles of 32).
            strips = render_strips_fn(mesh, cam, backend=backend)(g)
            assert torch.equal(strips, render(g, cam, backend=backend)), backend
    finally:
        dist.destroy_process_group()
