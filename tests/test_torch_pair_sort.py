"""The premise of the pair sort (``csrc/pair_sort.cu``), on the CPU.

K2's slots are splat-major and the splat id sits below bit 31 of its int64
key, so a stable sort of ``comp >> 31`` alone, with each pair's slot as its
value, must give the permutation of ``torch.sort(comp, stable=True)``.  The
kernel sorts that way, as a least-significant-digit radix sort of 8-bit
digits; here the same digit passes (each a stable sort by one digit) run on
K2's plain outputs for the card tests' scenes, and every output of
``sort_pairs_plain`` (the function the kernel is held to) must follow from
the order they give.

A frame's record route sorts less: it drops the keys of the sentinel tile
(every slot past the demand is one) and carries each pair's splat id, not
its slot; the same digit passes over the keys left must give the plain
version's tile starts, and its tiles and splat ids on the real tiles'
pairs.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_cuda import HEIGHT, SORT_SCENES, WIDTH, sort_case  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render_with_stats  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as pe  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import bin_splats  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import project_splats  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402


def digit_passes(comp, num_tiles: int, db: int):
    """The kernel's order: stable passes over the 8-bit digits of ``comp >>
    31``, least significant first, carrying each pair's slot."""
    key = comp >> pe.SPLAT_BITS
    perm = torch.arange(comp.shape[0])
    for p in range(pe.sort_passes(num_tiles, db)):
        digit = (key[perm] >> (pe.SORT_DIGIT_BITS * p)) & ((1 << pe.SORT_DIGIT_BITS) - 1)
        perm = perm[torch.sort(digit, stable=True).indices]
    return perm


@pytest.mark.parametrize("name", SORT_SCENES)
def test_digit_passes_on_the_top_bits_give_the_int64_sort(name):
    comp, fields, num_tiles, db, _ = sort_case("cpu", name)
    key = comp >> pe.SPLAT_BITS
    bits = pe.sort_key_bits(num_tiles, db)
    assert bits <= 32 and int(key.max()) < 2**bits
    if name == "strip-16-bit-depth":
        assert pe.sort_passes(num_tiles, db) == 3
    if name in ("empty", "behind-camera"):  # every slot in the sentinel tile
        assert bool((key >> db == num_tiles).all())

    perm = digit_passes(comp, num_tiles, db)
    comp_s = comp[perm]
    fields_s, tile_starts, perm_p, pair_tile, pair_rank = pe.sort_pairs_plain(comp, fields, num_tiles, db)
    assert torch.equal(perm, perm_p)
    assert torch.equal(comp_s, torch.sort(comp, stable=True).values)
    assert torch.equal(fields[:, perm], fields_s)
    assert torch.equal((key[perm] >> db).to(torch.int32), pair_tile)
    assert torch.equal((comp_s & ((1 << pe.SPLAT_BITS) - 1)).to(torch.int32), pair_rank)
    # The kernel's tile starts: the first sorted pair of each tile or later.
    starts = torch.searchsorted(pair_tile, torch.arange(num_tiles + 1, dtype=torch.int32)).to(torch.int32)
    assert torch.equal(starts, tile_starts)
    # And sort_pairs on CPU tensors is the plain version.
    got = pe.sort_pairs(comp, fields, num_tiles, db)
    assert all(torch.equal(a, b) for a, b in zip(got, (fields_s, tile_starts, perm_p, pair_tile, pair_rank)))


def real_tile_passes(comp, num_tiles: int, db: int):
    """The record route's order: the keys below the sentinel tile alone,
    through the stable digit passes, each carrying its pair's splat id.
    Returns the sorted ``(keys, splat ids)``."""
    key = comp >> pe.SPLAT_BITS
    real = key < (num_tiles << db)  # the sentinel tile is the largest
    key, ids = key[real], comp[real] & ((1 << pe.SPLAT_BITS) - 1)
    for p in range(pe.sort_passes(num_tiles, db)):
        digit = (key >> (pe.SORT_DIGIT_BITS * p)) & ((1 << pe.SORT_DIGIT_BITS) - 1)
        order = torch.sort(digit, stable=True).indices
        key, ids = key[order], ids[order]
    return key, ids


@pytest.mark.parametrize("name", SORT_SCENES)
def test_real_tile_passes_give_the_plain_sort_on_the_real_pairs(name):
    comp, _, num_tiles, db, demand = sort_case("cpu", name)
    key = comp >> pe.SPLAT_BITS
    # The slots the record route does not read, past the demand, are all
    # in the sentinel tile.
    assert bool((key[int(demand):] >> db == num_tiles).all())

    key_s, ids = real_tile_passes(comp[: int(demand)], num_tiles, db)
    real = key_s.shape[0]
    # The plain version takes the kernels' arguments (chip_smoke.plain_kernels
    # swaps it in for sort_pairs) and sorts every slot whatever the demand.
    _, tile_starts, _, pair_tile, pair_rank = pe.sort_pairs_plain(comp, None, num_tiles, db, demand)
    _, starts_all, _, tiles_all, ranks_all = pe.sort_pairs_plain(comp, None, num_tiles, db)
    assert torch.equal(tile_starts, starts_all) and torch.equal(pair_tile, tiles_all)
    assert torch.equal(pair_rank, ranks_all)
    tiles = (key_s >> db).to(torch.int32)
    starts = torch.searchsorted(tiles, torch.arange(num_tiles + 1, dtype=torch.int32)).to(torch.int32)
    assert int(tile_starts[-1]) == real and torch.equal(starts, tile_starts)
    assert torch.equal(tiles, pair_tile[:real]) and torch.equal(ids.to(torch.int32), pair_rank[:real])
    if name in ("empty", "behind-camera"):  # every slot in the sentinel tile
        assert real == 0 and not bool(tile_starts.any())
    else:
        assert 0 < real < comp.shape[0]


def test_sort_pairs_rejects_bad_inputs():
    comp, fields, num_tiles, db, _ = sort_case("cpu", "one-splat")
    with pytest.raises(ValueError):
        pe.sort_pairs(comp.to(torch.int32), fields, num_tiles, db)
    with pytest.raises(ValueError):
        pe.sort_pairs(comp, fields[:, 1:], num_tiles, db)
    with pytest.raises(ValueError):  # neither CPU (plain version) nor CUDA (kernel)
        pe.sort_pairs(comp.to("meta"), fields.to("meta"), num_tiles, db)


@pytest.mark.parametrize("backend", ["cuda", "torch", "reference"])
def test_render_stats_count_the_sorted_pairs(backend):
    # RenderStats.sorted_pairs: the real tiles' pairs, tile_starts[T] of the
    # frame's binning, read as a view (no copy) beside the demand.
    g = sphere_scene(n=1500, seed=0).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, WIDTH, HEIGHT)
    cfg = RasterizeConfig()
    with torch.no_grad():
        _, stats = render_with_stats(g, cam, config=cfg, backend=backend, device="cpu")
        proj = project_splats(g, cam)
        if backend == "cuda":
            want = pe.bin_and_prepare(proj, WIDTH, HEIGHT, cfg, records=True)[0].tile_starts[-1]
        elif backend == "torch":
            want = bin_splats(proj, WIDTH, HEIGHT, cfg).tile_starts[-1]
    sorted_pairs = stats.sorted_pairs
    assert sorted_pairs.shape == () and sorted_pairs.dtype == torch.int32
    if backend == "reference":  # no binning: nothing sorted
        assert int(sorted_pairs) == 0
        return
    assert sorted_pairs._base is not None  # a view of the tile starts
    assert int(sorted_pairs) == int(want) and 0 < int(sorted_pairs) <= int(stats.num_pairs) <= stats.budget
