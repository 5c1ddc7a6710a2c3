"""Port K2 (pair expansion) + sort vs the JAX package's ``bin_and_prepare``.

The JAX side runs its Pallas expansion kernel in interpret mode on the CPU;
the port's wrapper takes its plain PyTorch version on CPU tensors.  Both get
the same JAX projection.  Integer outputs must be exact.  Fields are
compared over the composited pairs (those of real tiles): sentinel-tile
slots are never composited, and the TPU package decodes its unused tail
slots from zero codes while the port writes zeros there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as tpe  # noqa: E402
from unitygaussiansplatting_tpu.ops.pair_expand import bin_and_prepare as jax_bin_and_prepare  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402

torch.set_num_threads(2)

# Field tolerance: values equal up to an ulp (cos/sin/exp2/log differ in the
# last bit between XLA's and PyTorch's CPU implementations); 1e-6 absolute
# below 1, 1e-6 relative above (pixel-scale centers have an ulp of ~1e-5).
FIELD_TOL = dict(rtol=1e-6, atol=1e-6)
# pack_center_u32 quantizes each center offset to 12 + 17 bits.  XLA's CPU
# code contracts a*b + c into one FMA and its log/sqrt differ by an ulp, so
# an offset on a code boundary can round to the neighbouring code: a center
# then moves by one code step (r2/65535 or r1/2047, well under 0.05 px).
CENTER_STEP_PX = 0.05
CENTER_EXACT_FRACTION = 0.99

CASES = dict(tp.CONFIGS, overflow=dict(pair_multiplier=0.5))


@pytest.fixture(scope="module")
def projections():
    jcam, _ = tp.cameras()
    jproj = jax_project(tp.jax_scene().activate(), jcam)
    return jproj, tp.proj_to_torch(jproj)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_k2_and_sort_match_jax(projections, name):
    jproj, tproj = projections
    jcfg, cfg = tp.configs(**CASES[name])
    jb, jfields, jreal = jax_bin_and_prepare(jproj, tp.WIDTH, tp.HEIGHT, jcfg, interpret=True)
    b, fields, real = tpe.bin_and_prepare(tproj, tp.WIDTH, tp.HEIGHT, cfg)

    k = int(jb.pair_rank.shape[0])
    assert fields.shape == (tpe.NUM_FIELDS, k)
    np.testing.assert_array_equal(b.pair_tile.numpy(), np.asarray(jb.pair_tile))
    np.testing.assert_array_equal(b.pair_rank.numpy(), np.asarray(jb.pair_rank))
    np.testing.assert_array_equal(b.tile_starts.numpy(), np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(b.bounds.numpy(), np.concatenate([[0], np.cumsum(np.asarray(jb.rank_counts))]))
    assert int(b.num_pairs) == int(jb.num_pairs)
    assert int(real) == int(jreal)
    if name == "overflow":
        assert int(b.num_pairs) > k

    # (K/C, 16, C) -> (16, K): the JAX fields in sorted pair order.
    jf = np.asarray(jfields).transpose(1, 0, 2).reshape(16, k)[: tpe.NUM_FIELDS]
    used = int(b.tile_starts[-1])
    assert used > 0
    got, want = fields[:, :used].numpy(), jf[:, :used]
    if cfg.pack_center_u32:
        close = np.isclose(got[:2], want[:2], **FIELD_TOL)
        assert close.mean() >= CENTER_EXACT_FRACTION, close.mean()
        assert np.abs(got[:2] - want[:2]).max() <= CENTER_STEP_PX
        got, want = got[2:], want[2:]
    np.testing.assert_allclose(got, want, **FIELD_TOL)


def test_unused_slots_are_sentinel(projections):
    # Slots past the demand: sentinel key, splat id N, zero fields.
    _, tproj = projections
    _, cfg = tp.configs(**tp.HEADLINE)
    table, bounds, _ = tpe.prepare_table(tproj, tp.WIDTH, tp.HEIGHT, cfg)
    k = tpe.pair_budget(tproj.depth.shape[0], cfg)
    comp, fields = tpe.expand_pairs(table, bounds, k, tp.WIDTH, tp.HEIGHT, cfg)
    demand = int(bounds[-1])
    assert demand < k
    num_tiles = 3 * 4
    db = tpe.depth_key_bits(num_tiles)
    n = tproj.depth.shape[0]
    assert (comp[demand:] == (((num_tiles << db) << tpe.SPLAT_BITS) | n)).all()
    assert (fields[:, demand:] == 0).all()
    # Used slots carry splat ids in splat-major runs.
    splat = comp[:demand] & ((1 << tpe.SPLAT_BITS) - 1)
    assert (splat[1:] >= splat[:-1]).all() and int(splat.max()) < n


def test_expand_pairs_rejects_bad_inputs(projections):
    _, tproj = projections
    _, cfg = tp.configs()
    table, bounds, _ = tpe.prepare_table(tproj, tp.WIDTH, tp.HEIGHT, cfg)
    with pytest.raises(ValueError):
        tpe.expand_pairs(table.double(), bounds, 1024, tp.WIDTH, tp.HEIGHT, cfg)
    with pytest.raises(ValueError):
        tpe.expand_pairs(table, bounds[:-1], 1024, tp.WIDTH, tp.HEIGHT, cfg)
    with pytest.raises(ValueError):  # neither CPU (plain version) nor CUDA (kernel)
        tpe.expand_pairs(table.to("meta"), bounds.to("meta"), 1024, tp.WIDTH, tp.HEIGHT, cfg)
