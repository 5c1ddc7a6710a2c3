"""The premise of the pair sort (``csrc/pair_sort.cu``), on the CPU.

K2's slots are splat-major and the splat id sits below bit 31 of its int64
key, so a stable sort of ``comp >> 31`` alone, with each pair's slot as its
value, must give the permutation of ``torch.sort(comp, stable=True)``.  The
kernel sorts that way, as a least-significant-digit radix sort of 8-bit
digits; here the same digit passes (each a stable sort by one digit) run on
K2's plain outputs for the card tests' scenes, and every output of
``sort_pairs_plain`` (the function the kernel is held to) must follow from
the order they give.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_cuda import SORT_SCENES, sort_case  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as pe  # noqa: E402


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
    comp, fields, num_tiles, db = sort_case("cpu", name)
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


def test_sort_pairs_rejects_bad_inputs():
    comp, fields, num_tiles, db = sort_case("cpu", "one-splat")
    with pytest.raises(ValueError):
        pe.sort_pairs(comp.to(torch.int32), fields, num_tiles, db)
    with pytest.raises(ValueError):
        pe.sort_pairs(comp, fields[:, 1:], num_tiles, db)
    with pytest.raises(ValueError):  # neither CPU (plain version) nor CUDA (kernel)
        pe.sort_pairs(comp.to("meta"), fields.to("meta"), num_tiles, db)
