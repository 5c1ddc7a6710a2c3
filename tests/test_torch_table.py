"""The port's K2 per-splat pass (``prepare_table``) and ``bin_and_prepare``
on edge scenes, against the JAX package.

``prepare_table_plain`` (what ``prepare_table`` takes on CPU tensors) is
held against the table the JAX package's ``bin_and_prepare`` builds in XLA
(unitygaussiansplatting_tpu/ops/pair_expand.py:579-640) from
``quantize_view_fp16``, ``tile_rects``, ``axes_u32_codes`` and
``quantize_depth`` on the same projection: all 14 rows bit for bit, the run
bounds and the real pair count exact.  The JAX side of ``bin_and_prepare``
runs its Pallas expansion kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as tpe  # noqa: E402
from unitygaussiansplatting_tpu.ops import binning as jb  # noqa: E402
from unitygaussiansplatting_tpu.ops import tile_common as jtc  # noqa: E402
from unitygaussiansplatting_tpu.ops.pair_expand import bin_and_prepare as jax_bin_and_prepare  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402

torch.set_num_threads(2)

# K2's fields of composited pairs: tests/test_torch_pair_expand.py states the bar.
FIELD_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def sphere():
    jcam, _ = tp.cameras()
    return jax_project(tp.jax_scene().activate(), jcam)


def numpy_projection(jproj, **changes):
    """The projection as numpy arrays (the JAX package takes them as they
    are), with ``changes`` applied to copies."""
    fields = {name: np.array(getattr(jproj, name)) for name in jproj._fields}
    for name, fn in changes.items():
        fn(fields[name])
    return type(jproj)(**fields)


def with_nans(jproj):
    """Behind-camera splats: NaN and infinite geometry, some of it still
    marked valid, a NaN opacity and a NaN depth."""

    def center(c):
        c[::7] = np.nan
        c[5::13, 1] = np.inf

    def invalid(v):
        v[::7] = False

    def nan_every(step, start=0):
        def put(x):
            x[start::step] = np.nan
        return put

    return numpy_projection(jproj, center=center, valid=invalid, axis1=nan_every(11, 3),
                            opacity=nan_every(17, 2), depth=nan_every(19))


def jax_table(jproj, width, height, jcfg):
    """The TPU package's (14, N) table, run bounds and real pair count, as
    its ``bin_and_prepare`` builds them (pair_expand.py:579-640)."""
    proj = jtc.quantize_view_fp16(jproj, jcfg)
    tiles_x, tiles_y = jb.tile_grid(width, height, jcfg)
    num_tiles = tiles_x * tiles_y
    db = jb.depth_key_bits(num_tiles)
    x0, y0, nx, _, counts, valid = jb.tile_rects(proj, width, height, jcfg)
    live = valid & (counts > 0)
    counts_slots = jnp.where(live, counts, 1)
    dq = jnp.where(live, jb.quantize_depth(proj.depth, db), 0).astype(jnp.float32)
    if jcfg.pack_axes_u32:
        tc, n1c, n2c = jtc.axes_u32_codes(proj.axis1, proj.axis2)
        ax_rows = [tc * 1024.0 + n1c, n2c, jnp.zeros_like(tc), jnp.zeros_like(tc)]
    else:
        ax_rows = [proj.axis1[:, 0], proj.axis1[:, 1], proj.axis2[:, 0], proj.axis2[:, 1]]
    table = jnp.stack([
        proj.center[:, 0], proj.center[:, 1], *ax_rows,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2], jnp.where(live, proj.opacity, 0.0),
        jnp.where(live, x0.astype(jnp.float32), float(num_tiles)), jnp.where(live, y0.astype(jnp.float32), 0.0),
        jnp.where(live, nx.astype(jnp.float32), 1.0), dq,
    ])
    table = jnp.where(jnp.isfinite(table), table, 0.0)
    bounds = np.concatenate([[0], np.cumsum(np.asarray(counts_slots))])
    return np.asarray(table), bounds, int(jnp.sum(counts))


@pytest.mark.parametrize("scene", ["sphere", "nan"])
@pytest.mark.parametrize("name", list(tp.CONFIGS))
def test_plain_table_matches_jax(sphere, name, scene):
    jproj = sphere if scene == "sphere" else with_nans(sphere)
    jcfg, cfg = tp.configs(**tp.CONFIGS[name])
    want, want_bounds, want_real = jax_table(jproj, tp.WIDTH, tp.HEIGHT, jcfg)
    table, bounds, real = tpe.prepare_table_plain(tp.proj_to_torch(jproj), tp.WIDTH, tp.HEIGHT, cfg)
    assert table.shape == (tpe.TABLE_ROWS, tp.SCENE_N) and table.dtype == torch.float32
    got = table.numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))  # every row, bit for bit
    np.testing.assert_array_equal(bounds.numpy(), want_bounds)
    assert bounds.dtype == torch.int32 and int(real) == want_real
    assert np.isfinite(got).all()
    if scene == "nan":
        tiles_x, tiles_y = tpe.tile_grid(tp.WIDTH, tp.HEIGHT, cfg)
        assert (got[10, ::7] == tiles_x * tiles_y).all()  # invalid: the sentinel tile


def test_prepare_table_dispatch(sphere):
    # CPU tensors: the plain version, no launch; neither CPU nor CUDA: raise.
    proj = tp.proj_to_torch(sphere)
    _, cfg = tp.configs(**tp.HEADLINE)
    before = tpe.prepare_table.launches
    got = tpe.prepare_table(proj, tp.WIDTH, tp.HEIGHT, cfg)
    want = tpe.prepare_table_plain(proj, tp.WIDTH, tp.HEIGHT, cfg)
    assert tpe.prepare_table.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        tpe.prepare_table(type(proj)(*(x.to("meta") for x in proj)), tp.WIDTH, tp.HEIGHT, cfg)


LONG = 7  # the splat stretched over the frame; LONG_OVERFLOW where the budget ends in its run
LONG_OVERFLOW = 50


def one_splat_all_tiles(jproj, index=LONG):
    """The sphere with splat ``index`` stretched over the whole frame, every
    splat valid and nearly opaque."""

    def stretch(value):
        def put(a):
            a[index] = value
        return put

    return numpy_projection(
        jproj, axis1=stretch((400.0, 0.0)), axis2=stretch((0.0, -300.0)),
        opacity=lambda o: o.fill(0.9), valid=lambda v: v.fill(True),
    )


EDGE_SCENES = {
    # one splat over all 12 tiles; over all 768 tiles of 8x4 (a run longer
    # than the port's 512-slot K2 window); the same overflowing its budget
    # inside that run; every splat dead
    "one-splat-all-tiles": (one_splat_all_tiles, {}),
    "one-splat-768-tiles": (one_splat_all_tiles, dict(tile_w=8, tile_h=4, chunk_size=32, pair_multiplier=8.0)),
    "overflow-in-long-run": (lambda p: one_splat_all_tiles(p, LONG_OVERFLOW),
                             dict(tile_w=8, tile_h=4, chunk_size=32, pair_multiplier=0.5)),
    "all-dead": (lambda p: numpy_projection(p, valid=lambda v: v.fill(False)), {}),
}


@pytest.mark.parametrize("name", list(EDGE_SCENES))
def test_bin_and_prepare_edge_scenes_match_jax(sphere, name):
    make, kw = EDGE_SCENES[name]
    jproj = make(sphere)
    jcfg, cfg = tp.configs(**kw)
    jbin, jfields, jreal = jax_bin_and_prepare(jproj, tp.WIDTH, tp.HEIGHT, jcfg, interpret=True)
    b, fields, real = tpe.bin_and_prepare(tp.proj_to_torch(jproj), tp.WIDTH, tp.HEIGHT, cfg)

    k = int(jbin.pair_rank.shape[0])
    assert fields.shape == (tpe.NUM_FIELDS, k)
    np.testing.assert_array_equal(b.pair_tile.numpy(), np.asarray(jbin.pair_tile))
    np.testing.assert_array_equal(b.pair_rank.numpy(), np.asarray(jbin.pair_rank))
    np.testing.assert_array_equal(b.tile_starts.numpy(), np.asarray(jbin.tile_starts))
    np.testing.assert_array_equal(b.bounds.numpy(), np.concatenate([[0], np.cumsum(np.asarray(jbin.rank_counts))]))
    assert int(b.num_pairs) == int(jbin.num_pairs) and int(real) == int(jreal)
    runs = (b.bounds[1:] - b.bounds[:-1]).numpy()
    num_tiles = b.tile_starts.shape[0] - 1
    if name == "all-dead":
        assert int(real) == 0 and (runs == 1).all() and int(b.tile_starts[-1]) == 0
    else:
        assert runs.max() == num_tiles
    if name == "overflow-in-long-run":
        assert int(b.bounds[LONG_OVERFLOW]) < k < int(b.bounds[LONG_OVERFLOW + 1])  # the budget ends in the long run
    # Fields of the composited pairs (real tiles), as in test_torch_pair_expand.
    used = int(b.tile_starts[-1])
    jf = np.asarray(jfields).transpose(1, 0, 2).reshape(16, k)[: tpe.NUM_FIELDS]
    np.testing.assert_allclose(fields[:, :used].numpy(), jf[:, :used], **FIELD_TOL)
