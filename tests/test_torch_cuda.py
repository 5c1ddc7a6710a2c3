"""The port's CUDA kernels against their plain PyTorch versions, on the card,
one backward through ``render`` on the card against the CPU, and the import
pipeline's device steps (the Morton order against its plain version, the
k-means bit for bit across runs and near the CPU's), the debug point
modes on the card equal to the CPU's, the tile path (``backend="torch"``)
on the card against the CPU, strips on a world of one NCCL rank, and the
``train_splats`` program's first steps on the card against the CPU, the
projection's two kernels (``csrc/project.cu``) against its plain version
bit for bit, alone and in a frame, the asset decode (``csrc/decode.cu``)
against its plain version bit for bit, alone and in a frame, and the pair
sort (``csrc/pair_sort.cu``) against its plain version bit for bit, up to
a 6.1M-splat cloud's budget of 15M slots, and a frame's route through the
per-splat records (K1 reading each pair's fields through its splat id)
against the route through the sorted per-slot fields, bit for bit, on the
sort's cases.  K2's
operands come from a per-splat kernel, and K2 runs in windows of slots; K1
runs as clusters of CTAs and saves K3's checkpoints; K3 runs one block per
segment from them.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed
(the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import collections
import dataclasses
import json
import re
import warnings

import pytest

torch = pytest.importorskip("torch")

from unitygaussiansplatting_torch.io import device_asset as tda  # noqa: E402
from unitygaussiansplatting_torch.io import formats as TF  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.ops import cuda_build  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as pe  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians  # noqa: E402
from unitygaussiansplatting_torch.models import renderer  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render  # noqa: E402
from unitygaussiansplatting_torch.ops import projection  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as rc  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda_bwd as rb  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import depth_key_bits, pair_budget, tile_grid  # noqa: E402
from unitygaussiansplatting_torch.ops.packing import as_i16, as_i32  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import ProjectedSplats, project_splats  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
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
SORT_ENTRIES = ("pair_sort_upsweep_launch", "pair_sort_pass_launch", "pair_sort_starts_launch")
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
    bit, the run bounds and the real pair count exact; where the config
    allows records, the kernel again with them: the same table, bounds and
    count, and the records as the plain version's (bit for bit; within
    FIELD_TOL under pack_axes_u32, whose decode takes cos, sin and exp2).
    Returns the kernel's ``(table, bounds, num_real)``."""
    before = cuda_build.launched.copy()
    table, bounds, real = pe.prepare_table(proj, WIDTH, HEIGHT, cfg)
    table_p, bounds_p, real_p = pe.prepare_table_plain(proj, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["pair_table_launch"] == 1
    assert table.shape == table_p.shape and table.is_contiguous()
    assert torch.equal(table.view(torch.int32), table_p.view(torch.int32))
    assert bounds.dtype == torch.int32 and torch.equal(bounds, bounds_p)
    assert real.dtype == torch.int32 and int(real) == int(real_p)
    assert bool(torch.isfinite(table).all())
    if pe.per_splat_fields(cfg):
        *again, record = pe.prepare_table(proj, WIDTH, HEIGHT, cfg, records=True)
        record_p = pe.splat_records_plain(table_p, cfg)
        torch.cuda.synchronize()
        assert torch.equal(again[0].view(torch.int32), table.view(torch.int32))
        assert torch.equal(again[1], bounds) and int(again[2]) == int(real)
        assert record.shape == (table.shape[1], pe.RECORD_FLOATS) and record.data_ptr() % 16 == 0
        if cfg.pack_axes_u32:
            torch.testing.assert_close(record, record_p, **FIELD_TOL)
        else:
            assert differing(record, record_p) == 0
    else:
        with pytest.raises(ValueError, match="center packing"):
            pe.prepare_table(proj, WIDTH, HEIGHT, cfg, records=True)
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
    before = cuda_build.launched.copy()
    comp, fields = pe.expand_pairs(table, bounds, k, WIDTH, HEIGHT, cfg)
    comp_p, fields_p = pe.expand_pairs_plain(table, bounds, k, WIDTH, HEIGHT, cfg)
    keys, none = pe.expand_pairs(table, bounds, k, WIDTH, HEIGHT, cfg, keys_only=True)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["expand_pairs_launch"] == 2
    assert torch.equal(comp, comp_p)
    torch.testing.assert_close(fields, fields_p, **FIELD_TOL)
    assert torch.equal(keys, comp) and none is None  # the keys alone: the same keys
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
    fields_s, starts, perm, _, _ = pe.sort_pairs(comp, fields, num_tiles, depth_key_bits(num_tiles))
    return fields_s, starts, perm, bounds


# The sphere, the scenes of EDGE_SCENES that K2 fills or overflows, two clouds
# of dead splats only, and the top strip of the frame under the frame's
# depth bits and under 16 (three passes instead of four).
SORT_SCENES = [
    "sphere", "sphere-headline", "overflow", "overflow-in-long-run", "one-splat", "fewer-than-a-window",
    "empty", "behind-camera", "strip", "strip-16-bit-depth",
]
STRIP_ROWS = HEIGHT // 2


def sort_case(device, name):
    """K2's plain outputs for one of SORT_SCENES, the pair sort's inputs in
    its CPU tests (tests/test_torch_pair_sort.py) and here: ``(comp,
    fields, num_tiles, db, demand)``, the last the slot demand ``bounds[N]``
    (() int32)."""
    height = HEIGHT
    if name.startswith("sphere"):
        proj, cfg = sphere_projection(device), RasterizeConfig(**(HEADLINE if name == "sphere-headline" else {}))
    elif name.startswith("strip"):
        frame_tiles = tile_grid(WIDTH, HEIGHT, RasterizeConfig())
        bits = 16 if name == "strip-16-bit-depth" else depth_key_bits(frame_tiles[0] * frame_tiles[1])
        proj, cfg, height = sphere_projection(device), RasterizeConfig(depth_bits=bits), STRIP_ROWS
    else:
        proj, cfg = edge_scene(device, name)
    tiles_x, tiles_y = tile_grid(WIDTH, height, cfg)
    num_tiles = tiles_x * tiles_y
    table, bounds, _ = pe.prepare_table_plain(proj, WIDTH, height, cfg)
    comp, fields = pe.expand_pairs_plain(table, bounds, pair_budget(table.shape[1], cfg), WIDTH, height, cfg)
    return comp, fields, num_tiles, depth_key_bits(num_tiles, cfg), bounds[-1]


def assert_sort_matches_plain(comp, fields, num_tiles, db):
    """The pair sort against its plain version: every output bit for bit,
    one upsweep, one pass an 8-bit digit of the key and one tile-start
    search launched."""
    before = cuda_build.launched.copy()
    got = pe.sort_pairs(comp, fields, num_tiles, db)
    want = pe.sort_pairs_plain(comp, fields, num_tiles, db)
    torch.cuda.synchronize()
    took = cuda_build.launched - before
    assert {e: took[e] for e in SORT_ENTRIES} == {
        "pair_sort_upsweep_launch": 1, "pair_sort_pass_launch": pe.sort_passes(num_tiles, db),
        "pair_sort_starts_launch": 1}
    for name, a, b in zip(("fields_s", "tile_starts", "perm", "pair_tile", "pair_rank"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), name
    return got


def assert_record_sort_matches_plain(comp, num_tiles, db, demand):
    """The pair sort's record route (no fields, the slots below ``demand``)
    against its plain version: ``tile_starts`` bit for bit, ``pair_tile``
    and ``pair_rank`` on ``[0, tile_starts[num_tiles])``, the pairs of real
    tiles (the route leaves the rest unwritten), no permutation, and the
    launches of the per-slot route.  Returns the sorted pairs' count R."""
    before = cuda_build.launched.copy()
    got = pe.sort_pairs(comp, None, num_tiles, db, demand)
    want = pe.sort_pairs_plain(comp, None, num_tiles, db)
    torch.cuda.synchronize()
    took = cuda_build.launched - before
    assert {e: took[e] for e in SORT_ENTRIES} == {
        "pair_sort_upsweep_launch": 1, "pair_sort_pass_launch": pe.sort_passes(num_tiles, db),
        "pair_sort_starts_launch": 1}
    (none, starts, perm, tiles, ranks), (_, want_starts, _, want_tiles, want_ranks) = got, want
    assert none is None and perm is None
    assert torch.equal(starts, want_starts)
    real = int(starts[-1])
    assert tiles.shape == ranks.shape == comp.shape and tiles.dtype == ranks.dtype == torch.int32
    assert torch.equal(tiles[:real], want_tiles[:real]) and torch.equal(ranks[:real], want_ranks[:real])
    return real


def equal_key_case(device, name, k):
    """``k`` slots of three splats each: every key equal (stability decides
    the whole order), or every key in the sentinel tile with seeded depths."""
    num_tiles = 475
    db = depth_key_bits(num_tiles)
    slot = torch.arange(k, device=device)
    if name == "equal-keys":
        key = torch.full((k,), (123 << db) | 4567, device=device, dtype=torch.int64)
    else:
        gen = torch.Generator(device=device).manual_seed(11)
        depth = torch.randint(0, 1 << db, (k // 3 + 1,), generator=gen, device=device)
        key = (num_tiles << db) | depth[slot // 3]
    comp = (key << pe.SPLAT_BITS) | (slot // 3)
    fields = torch.arange(pe.NUM_FIELDS * k, device=device, dtype=torch.float32).reshape(pe.NUM_FIELDS, k)
    return comp, fields, num_tiles, db, None


@pytest.mark.cuda
@pytest.mark.parametrize("name", SORT_SCENES + ["odd-k", "equal-keys", "sentinel-keys", "bicycle-budget",
                                                "demand-below-k"])
def test_pair_sort_kernel_matches_plain(device, name):
    # Both routes: the per-slot route (fields) over every slot, every output
    # bit for bit; the record route (no fields) over the slots below the
    # demand, the pairs of real tiles alone.
    tile_keys = cuda_build.library("pair_sort").pair_sort_tile_keys()
    if name in SORT_SCENES:
        case = sort_case(device, name)
    elif name in ("odd-k", "demand-below-k"):
        # The sphere at a budget that is no multiple of a pass's tile; or at
        # one more than two tiles above the demand, which is no multiple of
        # a tile either: pass 0's blocks past the demand exit at once, and
        # the last blocks of the demand and of the real pairs are ragged.
        cfg = RasterizeConfig()
        table, bounds, _ = pipeline_inputs(device, cfg)
        demand = int(bounds[-1])
        k = 3 * tile_keys + 1001 if name == "odd-k" else demand + 2 * tile_keys + 123
        tiles_x, tiles_y = tile_grid(WIDTH, HEIGHT, cfg)
        num_tiles = 12 if name == "odd-k" else tiles_x * tiles_y
        comp, fields = pe.expand_pairs(table, bounds, k, WIDTH, HEIGHT, cfg)
        case = comp, fields, num_tiles, depth_key_bits(num_tiles), bounds[-1]
    elif name in ("equal-keys", "sentinel-keys"):
        case = equal_key_case(device, name, 40 * tile_keys + 77)
    else:
        case = bicycle_budget(device)
    comp, fields, num_tiles, db, demand = case
    if name in ("odd-k", "equal-keys", "sentinel-keys"):
        assert comp.shape[0] % tile_keys  # a pass's last tile is ragged
    _, _, perm, _, _ = assert_sort_matches_plain(comp, fields, num_tiles, db)
    if name == "equal-keys":
        assert torch.equal(perm, torch.arange(comp.shape[0], device=device))
    real = assert_record_sort_matches_plain(comp, num_tiles, db, demand)
    if name in ("empty", "behind-camera", "sentinel-keys"):  # every slot in the sentinel tile
        assert real == 0
    if name == "equal-keys":
        assert real == comp.shape[0]
    if name == "demand-below-k":
        demand = int(demand)
        assert demand % tile_keys and real % tile_keys and demand < comp.shape[0] - 2 * tile_keys
    if name == "bicycle-budget":
        assert comp.shape[0] >= 15_000_000 and pe.sort_passes(num_tiles, db) == 4
        assert 0 < real < int(demand) < comp.shape[0]


def bicycle_budget(device):
    """K2's keys and fields for the benchmark's bicycle-class cloud (6.1M
    splats) seen from its orbit at 1200x797, at a budget of 2.5 slots a
    splat: ``(comp, fields, num_tiles, db, demand)``."""
    proj, cfg, width, height = bicycle_projection(device)
    with torch.no_grad():
        table, bounds, _ = pe.prepare_table(proj, width, height, cfg)
        comp, fields = pe.expand_pairs(table, bounds, pair_budget(table.shape[1], cfg), width, height, cfg)
    tiles_x, tiles_y = tile_grid(width, height, cfg)
    return comp, fields, tiles_x * tiles_y, depth_key_bits(tiles_x * tiles_y), bounds[-1]


def route_case(device, name):
    """``(proj, cfg, width, height, k)`` of a frame for one of the pair sort's
    cases (SORT_SCENES, odd-k, bicycle-budget) and of the per-splat pass's
    lattices (TABLE_CONFIGS), each config without center packing, which
    keeps the per-slot fields."""
    width, height, k = WIDTH, HEIGHT, None
    if name in TABLE_CONFIGS:
        proj, cfg = sphere_projection(device), RasterizeConfig(**TABLE_CONFIGS[name])
    elif name.startswith("strip"):
        frame_tiles = tile_grid(WIDTH, HEIGHT, RasterizeConfig())
        bits = 16 if name == "strip-16-bit-depth" else depth_key_bits(frame_tiles[0] * frame_tiles[1])
        proj, cfg, height = sphere_projection(device), RasterizeConfig(depth_bits=bits), STRIP_ROWS
    elif name == "odd-k":  # a budget that is no multiple of a sort pass's tile
        proj, cfg = sphere_projection(device), RasterizeConfig()
        k = 3 * cuda_build.library("pair_sort").pair_sort_tile_keys() + 1001
    elif name == "bicycle-budget":
        proj, cfg, width, height = bicycle_projection(device)
    else:
        proj, cfg = edge_scene(device, name)
    return proj, dataclasses.replace(cfg, pack_center_u32=False), width, height, k


def bicycle_projection(device):
    """The benchmark's bicycle-class cloud (6.1M splats) seen from its orbit
    at 1200x797, and a config of 2.5 budget slots a splat: ``(proj, cfg,
    width, height)``."""
    from splatbench import scenes

    from unitygaussiansplatting_torch.models.gaussians import RawGaussians

    width, height = 1200, 797
    g = RawGaussians(**scenes.outdoor_scene(6_100_000, 2_000_000_033, device)).activate()
    cam = Camera.look_at([5.0, 0.4, 0.0], [0.0, -0.2, 0.0], [0, 1, 0], 47.0, width, height).to(device)
    with torch.no_grad():
        return project_splats(g, cam), RasterizeConfig(pair_multiplier=2.5), width, height


ROUTE_CASES = [name for name in TABLE_CONFIGS if name != "center-f16"] + [
    name for name in SORT_SCENES if name not in ("sphere", "sphere-headline")] + ["odd-k", "bicycle-budget"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROUTE_CASES)
def test_record_route_matches_slot_route(device, name):
    # A frame's two routes on the card: the per-slot fields K2 writes and the
    # sort gathers, against the per-splat records K1 reads through each
    # pair's splat id.  The same keys, tile starts and order of the real
    # tiles' pairs (all the record route sorts), and K1's image, exits and
    # checkpoints bit for bit; the record route launches the same kernels
    # (K2 writing keys only, the sort no permutation) and gathers nothing.
    proj, cfg, width, height, k = route_case(device, name)
    tiles_x, tiles_y = tile_grid(width, height, cfg)
    num_tiles = tiles_x * tiles_y
    db = depth_key_bits(num_tiles, cfg)
    table, bounds, _ = pe.prepare_table(proj, width, height, cfg)
    k = k or pair_budget(table.shape[1], cfg)
    comp, fields = pe.expand_pairs(table, bounds, k, width, height, cfg)
    fields_s, starts, _, _, ranks = pe.sort_pairs(comp, fields, num_tiles, db)
    del fields
    old = rc.composite_tiles(fields_s, starts, width, height, cfg, checkpoints=True)
    del fields_s
    before = cuda_build.launched.copy()
    table_r, bounds_r, _, record = pe.prepare_table(proj, width, height, cfg, records=True)
    comp_r, none = pe.expand_pairs(table_r, bounds_r, k, width, height, cfg, keys_only=True)
    sorted_none, starts_r, perm_none, _, ranks_r = pe.sort_pairs(comp_r, None, num_tiles, db, bounds_r[-1])
    new = rc.composite_tiles(record, starts_r, width, height, cfg, checkpoints=True, pair_rank=ranks_r)
    torch.cuda.synchronize()
    took = cuda_build.launched - before
    assert {e: took[e] for e in ("pair_table_launch", "expand_pairs_launch", "composite_fwd_launch")} == dict.fromkeys(
        ("pair_table_launch", "expand_pairs_launch", "composite_fwd_launch"), 1)
    assert none is None and sorted_none is None and perm_none is None
    assert torch.equal(table_r.view(torch.int32), table.view(torch.int32)) and torch.equal(bounds_r, bounds)
    real = int(starts[-1])
    assert torch.equal(comp_r, comp) and torch.equal(starts_r, starts) and torch.equal(ranks_r[:real], ranks[:real])
    (raw, done, ck), (raw_r, done_r, ck_r) = old, new
    assert torch.equal(raw_r.view(torch.int32), raw.view(torch.int32)) and torch.equal(done_r, done)
    assert torch.equal(ck_r.seg_starts, ck.seg_starts)
    _, pairs = rb.segment_pairs(starts, ck, cfg.chunk_size)
    assert torch.equal(ck_r.state[pairs > 0].view(torch.int32), ck.state[pairs > 0].view(torch.int32))
    if name == "bicycle-budget":
        assert k >= 15_000_000 and int(starts[-1]) > 0
    elif name in ("empty", "behind-camera"):  # every slot in the sentinel tile
        assert int(starts[-1]) == 0 and not bool(raw.any())
    elif num_tiles <= 64:  # and K1 against its plain version reading the same records
        raw_p, done_p, _ = rc.composite_tiles_plain(record, starts_r, width, height, cfg, pair_rank=ranks_r)
        torch.testing.assert_close(raw_r, raw_p, rtol=0, atol=K1_ATOL)
        assert torch.equal(done_r, done_p)


def assert_k1_matches_plain(fields, starts, width, height, cfg, segment_steps=rb.SEGMENT_STEPS):
    """K1 and its checkpoints against the plain version's; returns the
    kernel's ``(raw, pairs_done, checkpoints)``."""
    before = cuda_build.launched.copy()
    raw, done, ck = rc.composite_tiles(fields, starts, width, height, cfg, checkpoints=True,
                                       segment_steps=segment_steps)
    raw_p, done_p, ck_p = rc.composite_tiles_plain(fields, starts, width, height, cfg, checkpoints=True,
                                                   segment_steps=segment_steps)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["composite_fwd_launch"] == 1
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
    before = cuda_build.launched.copy()
    raw, done, none = rc.composite_tiles(fields_s, starts, WIDTH, HEIGHT, cfg)
    raw_p, done_p, _ = rc.composite_tiles_plain(fields_s, starts, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["composite_fwd_launch"] == 1 and none is None
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
    before = cuda_build.launched.copy()
    grads, done = rb.composite_bwd(*args, width, height, cfg, checkpoints=ck)
    again, _ = rb.composite_bwd(*args, width, height, cfg, checkpoints=ck)
    plain, done_p = rb.composite_bwd_plain(*args, width, height, cfg, checkpoints=ck)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["composite_bwd_launch"] == 2
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
    before = cuda_build.launched.copy()
    comp, fields = pe.expand_probe(k, device, keys_only=keys_only)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["expand_probe_launch"] == 1
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
        before = cuda_build.launched.copy()
        got = rb.run_reduce(g, bounds)
        want = rb.run_reduce_plain(g, bounds)
        torch.cuda.synchronize()
        assert (cuda_build.launched - before)["run_reduce_launch"] == 1
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
        before = cuda_build.launched.copy()
        loss = (render(g, cam, config=cfg, device=dev) * wt.to(dev)).sum()
        loss.backward()
        if dev != "cpu":
            since = cuda_build.launched - before
            assert since["composite_bwd_launch"] == since["run_reduce_launch"] == 1
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


@pytest.mark.cuda
def test_bench_pairs_on_card_equal_cpu(device):
    # The bench's pair counts (render_phases on its scenes, cameras and
    # configs at its default width) at 20,000 splats, the clouds activated on
    # the host and copied to each device.
    from unitygaussiansplatting_torch import bench
    from unitygaussiansplatting_torch.utils.config import RenderSettings
    from unitygaussiansplatting_torch.utils.profiling import render_phases
    from unitygaussiansplatting_torch.utils.synthetic import outdoor_scene

    cfg = bench.BenchConfig.from_env({})
    n = 20_000
    scenes = {
        "headline": (bench.headline_scene(n, True, "cpu"), bench.headline_camera(cfg.width, cfg.height),
                     bench.headline_config(cfg)),
        "outdoor": (outdoor_scene(n=n, seed=1).activate(), bench.outdoor_camera(cfg.width, cfg.height),
                    bench.scene_config(cfg, cfg.real_pair_mult)),
    }
    for name, (g, cam, config) in scenes.items():
        pairs = [bench.pair_record(render_phases(g.to(dev), cam, RenderSettings(sh_order=3), config, reps=1,
                                                 device=dev)) for dev in (device, torch.device("cpu"))]
        assert pairs[0] == pairs[1], name
        assert pairs[0]["num_pairs"] > n and not pairs[0]["overflow"], name


# The projection's kernels against its plain version: every field bit for
# bit (NaN against NaN, whatever its payload), valid exact.  Scenes: the
# sphere; the camera looking away (every splat behind it); an identity view
# with every 5th splat at view depth exactly 0, every 7th behind the camera
# and every 3rd killed; planar SH (three strided (N, 15) views); interleaved
# SH at other strides; 1499 splats (the last block's 91 x 45 floats end
# short of a float4) and SH that starts off 16-byte alignment (read in
# place); a model matrix.
PROJ_SCENES = ("sphere", "behind-camera", "depth-zero-and-killed", "planar-sh", "strided-sh", "tail-1499",
               "misaligned-sh", "model")
PROJ_SETTINGS = {
    "default": {}, "sh0": dict(sh_order=0), "sh1": dict(sh_order=1), "sh2": dict(sh_order=2),
    "sh-only": dict(sh_only=True), "fp16": dict(fp16_color=True),
    "scaled": dict(splat_scale=1.7, opacity_scale=3.0, fp16_color=True),
}


def projection_scene(device, scene):
    """``(gaussians, camera, model, kill_mask)`` of one of PROJ_SCENES."""
    g = sphere_scene(n=1500, seed=0).to(device).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
    model = kill = None
    if scene == "behind-camera":
        cam = Camera.look_at([0, 0.5, -3.0], [0, 0.5, -6.0], [0, 1, 0], 45.0, WIDTH, HEIGHT).to(device)
    elif scene == "depth-zero-and-killed":
        cam = dataclasses.replace(cam, view=torch.eye(4, device=device))  # view depth = z, exactly
        means = g.means + torch.tensor([0.0, 0.0, 3.5], device=device)
        means[::5, 2] = 0.0
        means[::7, 2] = -means[::7, 2]
        g = dataclasses.replace(g, means=means)
        kill = torch.zeros(1500, dtype=torch.bool, device=device)
        kill[::3] = True
    elif scene == "planar-sh":
        g = dataclasses.replace(g, sh=tuple(g.sh[..., c] for c in range(3)))
    elif scene == "strided-sh":
        g = dataclasses.replace(g, sh=g.sh.transpose(1, 2).contiguous().transpose(1, 2))
    elif scene == "tail-1499":
        g = dataclasses.replace(g, **{f.name: getattr(g, f.name)[:1499] for f in dataclasses.fields(g)})
    elif scene == "misaligned-sh":
        g = dataclasses.replace(g, **{f.name: getattr(g, f.name)[1:] for f in dataclasses.fields(g)})
    elif scene == "model":
        c, s = 0.8, 0.6
        model = torch.tensor([[c, 0.0, s, 0.2], [0.0, 1.0, 0.0, -0.1], [-s, 0.0, c, 0.3], [0.0, 0.0, 0.0, 1.0]],
                             device=device)
    return g, cam, model, kill


def differing(x, y):
    """Entries whose bits differ, NaN against NaN counting as equal."""
    same = (x.view(torch.int32) == y.view(torch.int32)) | (torch.isnan(x) & torch.isnan(y))
    return int((~same).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("settings", list(PROJ_SETTINGS))
@pytest.mark.parametrize("scene", PROJ_SCENES)
def test_projection_kernels_match_plain(device, scene, settings):
    g, cam, model, kill = projection_scene(device, scene)
    st = RenderSettings(**PROJ_SETTINGS[settings])
    before = cuda_build.launched.copy()
    got = projection.project_splats(g, cam, st, model=model, kill_mask=kill)
    want = projection.project_splats_plain(g, cam, st, model=model, kill_mask=kill)
    torch.cuda.synchronize()
    since = cuda_build.launched - before
    assert since["project_geom_launch"] == since["project_sh_launch"] == 1
    # The SH kernel stages the interleaved, aligned scenes' SH and reads the others in place.
    staged = projection._sh_channels(g.sh, g.means.shape[0], 15, g.means.device)[1]
    assert staged == (scene not in ("planar-sh", "strided-sh", "misaligned-sh"))
    assert torch.equal(got.valid, want.valid)
    if scene == "behind-camera":
        assert not bool(got.valid.any())
    if scene == "depth-zero-and-killed":
        assert bool((got.depth[::5] == 0).all()) and not bool(got.valid[::5].any())
        assert not bool(got.valid[::3].any()) and bool(got.valid.any())
    for field in ProjectedSplats._fields[:-1]:
        x, y = getattr(got, field), getattr(want, field)
        assert x.shape == y.shape and x.dtype == y.dtype == torch.float32, field
        assert differing(x, y) == 0, f"{field}: {differing(x, y)} of {x.numel()} entries differ"


@pytest.mark.cuda
def test_projection_kernels_under_autograd_take_the_plain_version(device):
    g, cam, _, _ = projection_scene(device, "sphere")
    means = g.means.clone().requires_grad_(True)
    before = cuda_build.launched.copy()
    got = projection.project_splats(dataclasses.replace(g, means=means), cam)
    assert cuda_build.launched == before
    assert got.center.requires_grad
    with torch.no_grad():
        got = projection.project_splats(dataclasses.replace(g, means=means), cam)
    since = cuda_build.launched - before
    assert since["project_geom_launch"] == since["project_sh_launch"] == 1
    assert not got.center.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_render_with_projection_kernels_equals_plain_projection(device, layout, monkeypatch):
    g, cam, _, _ = projection_scene(device, "sphere" if layout == "interleaved" else "planar-sh")
    got = render(g, cam, device=device)
    monkeypatch.setattr(renderer, "project_splats", projection.project_splats_plain)
    want = render(g, cam, device=device)
    assert torch.equal(got, want)


def _sync_warnings(fn) -> int:
    """The synchronizing CUDA operations ``fn()`` runs, by the sync debug mode
    (its notice that the mode is a prototype is not one)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(str(w.message).startswith("called a synchronizing CUDA operation") for w in caught)


def _launched_in(trace_path, name):
    """Names of the device operations launched while the host range ``name``
    was open on the launching thread, from a ``torch.profiler`` trace."""
    events = json.load(open(trace_path))["traceEvents"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    launches = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    names = []
    for op in events:
        if op.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            tid, ts = launches.get(op["args"].get("correlation"), (None, None))
            if any(tid == t and lo <= ts <= hi for t, lo, hi in spans):
                names.append(op["name"])
    return names


def _frame_trace(frame, path):
    """Write a ``torch.profiler`` trace of one call of ``frame`` to ``path``.
    A first call runs in the profiler's warm-up step, whose records are
    dropped: the device records the profiler loses as it starts (the first
    launches of its window) fall there, not in the traced call."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
                                on_trace_ready=lambda prof: prof.export_chrome_trace(str(path))) as prof:
        for _ in range(2):
            frame()
            torch.cuda.synchronize()
            prof.step()


@pytest.mark.cuda
def test_projection_launches_and_host_syncs_of_a_frame(device, tmp_path):
    # A frame as a viewer renders it: the cloud on the card, the camera on
    # the host (render_with_stats uploads it: the frame's one host sync).
    g, _, _, _ = projection_scene(device, "sphere")
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    render(g, cam, device=device)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = cuda_build.launched.copy()
    assert _sync_warnings(lambda: render(g, cam, device=device)) == 1
    since = cuda_build.launched - before
    assert since["project_geom_launch"] == since["project_sh_launch"] == 1
    torch.cuda.synchronize()
    cam_card = cam.to(device)
    assert _sync_warnings(lambda: projection.project_splats(g, cam_card)) == 0
    counts = {}
    for path, project in (("kernels", projection.project_splats), ("plain", projection.project_splats_plain)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(renderer, "project_splats", project)
            trace = tmp_path / f"{path}.json"
            _frame_trace(lambda: render(g, cam, device=device), trace)
        counts[path] = (_launched_in(trace, "splat_project"), _launched_in(trace, "splat_sh"))
    kernels, sh = counts["kernels"]
    print({path: (len(p), len(s)) for path, (p, s) in counts.items()}, kernels)
    # project_geom, project_sh and the camera position's product and negation.
    assert sum("project_geom" in k for k in kernels) == 1 and sum("project_sh" in k for k in sh) == 1
    assert len(kernels) <= 6 and set(sh) <= set(kernels)
    assert len(counts["plain"][0]) > 100


def _untemplated(name):
    """A device operation's name without its template arguments (K2's two
    specializations are one kernel of the port)."""
    while (stripped := re.sub(r"<[^<>]*>", "", name)) != name:
        name = stripped
    return name


@pytest.mark.cuda
def test_frame_reads_the_records_with_one_launch_fewer(device, tmp_path):
    # A frame without autograd reads each pair's fields from its splat's
    # record: against the per-slot route (per_splat_fields forced False) the
    # same image bit for bit, the same kernels of the port once each, and
    # one device operation fewer in the traced frame: the gather of the
    # fields by the sort's permutation.
    g, _, _, _ = projection_scene(device, "sphere")
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    images, ports, ops = {}, {}, {}
    for route in ("records", "slots"):
        with pytest.MonkeyPatch.context() as mp:
            if route == "slots":
                mp.setattr(rc, "per_splat_fields", lambda config: False)
            render(g, cam, device=device)
            torch.cuda.synchronize()
            before = cuda_build.launched.copy()
            images[route] = render(g, cam, device=device)
            torch.cuda.synchronize()
            ports[route] = cuda_build.launched - before
            trace = tmp_path / f"{route}.json"
            _frame_trace(lambda: render(g, cam, device=device), trace)
            ops[route] = collections.Counter(map(_untemplated, _launched_in(trace, "splat_rasterize_cuda")))
    assert torch.equal(images["records"].view(torch.int32), images["slots"].view(torch.int32))
    assert ports["records"] == ports["slots"] and ports["records"]["composite_fwd_launch"] == 1
    assert sum(ports["records"].values()) == 2 + 3 + pe.sort_passes(12, depth_key_bits(12)) + 2
    extra = ops["slots"] - ops["records"]
    print(dict(ops["records"]), dict(extra))
    assert not ops["records"] - ops["slots"] and sum(extra.values()) == 1
    assert any("gather" in name for name in extra) and not any("gather" in name for name in ops["records"])


@pytest.mark.cuda
def test_projection_under_a_model_and_a_multi_object_frame_wait_for_nothing_more(device):
    # A model's inverse rotation and origin read back from the card, once a
    # matrix: a projection under a reused model waits for nothing, and a
    # frame of several objects with a host view waits for the view's
    # upload alone, however many objects it holds.
    g, cam, model, _ = projection_scene(device, "model")
    projection.project_splats(g, cam, model=model)  # builds and loads the kernels
    torch.cuda.synchronize()
    assert _sync_warnings(lambda: projection.project_splats(g, cam, model=model)) == 0
    host_cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    models = [model, None, 0.5 * model]
    models[2][3, 3] = 1.0
    renderer.render_multi([g] * 3, host_cam, models=models, device=device)
    torch.cuda.synchronize()
    before = cuda_build.launched.copy()
    assert _sync_warnings(lambda: renderer.render_multi([g] * 3, host_cam, models=models, device=device)) == 1
    since = cuda_build.launched - before
    assert since["project_geom_launch"] == since["project_sh_launch"] == 3


@pytest.mark.cuda
def test_model_constants_are_kept_per_matrix_until_it_is_edited(device):
    model = torch.tensor([[0.0, 0.0, 2.0, 1.0], [0.0, 1.0, 0.0, 2.0], [-2.0, 0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0]],
                         device=device)
    inv, origin = projection.model_constants(model)
    assert origin == (1.0, 2.0, 3.0)
    assert torch.allclose(inv @ model[:3, :3], torch.eye(3, device=device), atol=1e-6)
    assert projection.model_constants(model)[0] is inv
    assert projection.model_constants(model.clone())[0] is not inv
    model[0, 3] = 5.0
    inv2, origin2 = projection.model_constants(model)
    assert origin2 == (5.0, 2.0, 3.0) and inv2 is not inv and torch.equal(inv2, inv)


# The asset decode's kernel against its plain version: every field bit for
# bit (NaN against NaN), on assets of each preset's formats whose words are
# random bits (every code of every field, the top bits included; random
# float16 halves include infinities and NaNs), at splat counts of one
# splat, one chunk, a chunk and one splat, and many chunks with a ragged
# last one.
DECODE_PRESETS = ("very_high", "high", "medium", "low", "very_low")
DECODE_COUNTS = (1, 256, 4097, 200_003)


def random_device_asset(preset: str, n: int, seed: int = 0, device="cpu") -> tda.DeviceAsset:
    """A ``DeviceAsset`` of ``preset``'s formats holding random words, with a
    chunk table of random finite ranges where the preset is chunked; BC7
    colour is held as Norm8x4 words, as ``device_asset_from_asset`` holds it."""
    p = TF.QUALITY_PRESETS[preset]
    gen = torch.Generator().manual_seed(seed)

    def u32(*shape):
        return as_i32(torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64))

    def u16(*shape):
        return as_i16(torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int64))

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    def vector(fmt):
        return {TF.VectorFormat.Float32: lambda: torch.randn((n, 3), generator=gen), TF.VectorFormat.Norm16: lambda:
                u16(n, 3), TF.VectorFormat.Norm11: lambda: u32(n), TF.VectorFormat.Norm6: lambda: u16(n)}[fmt]()

    color = {TF.ColorFormat.Float32x4: lambda: torch.rand((n, 4), generator=gen),
             TF.ColorFormat.Float16x4: lambda: u32(n, 2)}.get(p.color, lambda: u32(n))()
    sh_idx = None
    if TF.is_cluster_format(p.sh):
        k = TF.SH_CLUSTER_COUNT[p.sh]
        sh_q, sh_idx = u32(k, 24), torch.randint(0, k, (n,), generator=gen, dtype=torch.int32)
    else:
        sh_q = {TF.SHFormat.Float32: lambda: torch.randn((n, 45), generator=gen), TF.SHFormat.Float16: lambda:
                u32(n, 24), TF.SHFormat.Norm11: lambda: u32(n, 15), TF.SHFormat.Norm6: lambda: u16(n, 15)}[p.sh]()
    chunk_info = None
    if TF.uses_chunks(p.pos, p.scale, p.color, p.sh):
        c = -(-n // TF.CHUNK_SIZE)

        def f16_ranges(lo, hi, width, count):
            a = uniform(lo, hi, c, count)
            return [tda._f16_pair(a[:, j], a[:, j] + uniform(0.01, width, c)) for j in range(count)]

        pos_lo = uniform(-10.0, 0.0, c, 3)
        pos = torch.stack([pos_lo, pos_lo + uniform(0.1, 10.0, c, 3)], dim=-1).reshape(c, 6)
        chunk_info = torch.stack(
            f16_ranges(-1.0, 0.5, 1.0, 4) + list(pos.view(torch.int32).unbind(-1)) + f16_ranges(0.0, 0.5, 1.0, 3)
            + f16_ranges(-1.0, 0.0, 2.0, 3), dim=-1)
    da = tda.DeviceAsset(
        pos_q=vector(p.pos), rot_q=u32(n), scale_q=vector(p.scale), color_q=color, sh_q=sh_q, sh_idx=sh_idx,
        chunk_info=chunk_info, splat_count=n, pos_format=p.pos, scale_format=p.scale, color_format=p.color,
        sh_format=p.sh,
    )
    return da.to(device)


def gaussians_differing(got, want) -> dict:
    """``{field: entries whose bits differ}`` (NaN against NaN equal) for the
    fields of two clouds that differ, SH as one tensor or three channels
    alike; a field of another shape or layout counts every entry (-1: one
    is planar, the other not)."""
    out = {}
    for f in ("means", "rotations", "scales", "opacities", "base_color", "sh"):
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, tuple) != isinstance(b, tuple):
            out[f] = -1
            continue
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        count = sum(differing(x, y) if x.shape == y.shape and x.dtype == y.dtype == torch.float32 else x.numel()
                    for x, y in pairs)
        if count:
            out[f] = count
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", DECODE_COUNTS)
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("preset", DECODE_PRESETS)
def test_decode_kernel_matches_plain(device, preset, layout, n):
    da = random_device_asset(preset, n, seed=n, device=device)
    planar = layout == "planar"
    before = cuda_build.launched.copy()
    got = tda.decode_device(da, planar_sh=planar)
    want = tda.decode_device_plain(da, planar_sh=planar)
    torch.cuda.synchronize()
    assert (cuda_build.launched - before)["decode_launch"] == 1
    assert gaussians_differing(got, want) == {}
    if isinstance(got.sh, torch.Tensor) and da.sh_format != TF.SHFormat.Float32:
        # The layout project_sh stages: contiguous (N, 15, 3), 16-byte aligned.
        assert projection._sh_channels(got.sh, n, 15, got.means.device)[1]
    assert isinstance(got.sh, tuple) == (planar and da.sh_format in (TF.SHFormat.Norm11, TF.SHFormat.Norm6))


def medium_asset_scene(device):
    g = sphere_scene(n=1500, seed=0).to(device).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    return tda.encode_device(g, device=device), cam


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_asset_frame_through_the_decode_kernel_equals_plain_decode(device, layout, monkeypatch):
    da, cam = medium_asset_scene(device)
    cfg = RasterizeConfig(decode_planar_sh=layout == "planar")
    before = cuda_build.launched.copy()
    got = render(da, cam, config=cfg, device=device)
    assert (cuda_build.launched - before)["decode_launch"] == 1
    want = render(tda.decode_device_plain(da, planar_sh=cfg.decode_planar_sh), cam, config=cfg, device=device)
    assert torch.equal(got, want) and float(want[..., 3].max()) > 0.05
    monkeypatch.setattr(tda, "decode_device", tda.decode_device_plain)
    assert torch.equal(render(da, cam, config=cfg, device=device), want)


@pytest.mark.cuda
def test_asset_frame_launches_the_decode_once_and_waits_for_the_view_alone(device, tmp_path):
    da, cam = medium_asset_scene(device)
    render(da, cam, device=device)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = cuda_build.launched.copy()
    assert _sync_warnings(lambda: render(da, cam, device=device)) == 1  # the view's upload
    assert (cuda_build.launched - before)["decode_launch"] == 1
    torch.cuda.synchronize()
    assert _sync_warnings(lambda: tda.decode_device(da)) == 0
    trace = tmp_path / "asset.json"
    _frame_trace(lambda: render(da, cam, device=device), trace)
    decode = _launched_in(trace, "splat_decode")
    assert len(decode) == 1 and "decode_kernel" in decode[0], decode
