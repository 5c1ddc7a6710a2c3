"""Port K1 (tile composite) vs the JAX package's Pallas rasterizer.

Both packages rasterize the same JAX projection: the JAX side through
``rasterize_tiles_pallas`` (Pallas kernels in interpret mode on the CPU), the
port through ``bin_and_prepare`` + ``composite_tiles``, whose wrappers take
the plain PyTorch versions on CPU tensors.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
import unitygaussiansplatting_tpu.ops.rasterize_pallas as rpal  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera as TCamera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render_with_stats  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as tpe  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as trc  # noqa: E402
from unitygaussiansplatting_torch.ops.pair_expand import bin_and_prepare  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import project_splats as tproject  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene as tsphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.models.renderer import render_with_stats as jax_render_with_stats  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402

torch.set_num_threads(2)

ATOL = 5e-6  # tests/test_pallas.py:49
# pack_center_u32: XLA's CPU code contracts the center encode's a*b + c into
# one FMA (and its log/sqrt differ by an ulp), so ~0.3% of pair centers land
# one code step (~2e-4 px) from the port's.  Such a pair moves every pixel it
# covers by up to ~2e-4: measured 99.66% of channels within 5e-6, 99.997%
# within 1e-4, max 1.9e-4.  A flip across 1/255 or the |q| <= 2 clip would
# show as a larger, isolated difference, bounded by CENTER_MAX.
CENTER_FRACTION_ATOL = 0.995
CENTER_FRACTION_1E4 = 0.9999
CENTER_MAX = 1e-2


@pytest.fixture(scope="module")
def projections():
    jcam, _ = tp.cameras()
    jproj = jax_project(tp.jax_scene().activate(), jcam)
    return jproj, tp.proj_to_torch(jproj)


def port_image(tproj, cfg):
    binning, fields, _ = bin_and_prepare(tproj, tp.WIDTH, tp.HEIGHT, cfg)
    raw, done, _ = trc.composite_tiles(fields, binning.tile_starts, tp.WIDTH, tp.HEIGHT, cfg)
    return trc.untile(raw, tp.WIDTH, tp.HEIGHT, cfg), raw, done, binning


@pytest.mark.parametrize("name", list(tp.CONFIGS))
def test_plain_k1_matches_pallas(projections, name):
    jproj, tproj = projections
    jcfg, cfg = tp.configs(**tp.CONFIGS[name])
    want = np.asarray(rpal.rasterize_tiles_pallas(jproj, tp.WIDTH, tp.HEIGHT, jcfg, interpret=True))
    got, raw, done, binning = port_image(tproj, cfg)
    got = got.numpy()
    assert got.shape == (tp.HEIGHT, tp.WIDTH, 4)
    if cfg.pack_center_u32:
        assert tp.within_fraction(got, want, ATOL) >= CENTER_FRACTION_ATOL
        assert tp.within_fraction(got, want, 1e-4) >= CENTER_FRACTION_1E4
        assert np.abs(got - want).max() <= CENTER_MAX
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)
    # The sentinel tile's row is zero; no tile composites more than it holds.
    assert (raw[-1] == 0).all()
    counts = binning.tile_starts[1:] - binning.tile_starts[:-1]
    assert ((done >= 0) & (done <= counts)).all()


@pytest.mark.parametrize("chunk", [64, 128])
def test_plain_k1_matches_pallas_past_early_exits(chunk):
    jproj = tp.saturating_projection()
    jcfg, cfg = tp.configs(pair_multiplier=24.0, chunk_size=chunk)
    want = np.asarray(rpal.rasterize_tiles_pallas(jproj, tp.WIDTH, tp.HEIGHT, jcfg, interpret=True))
    got, _, done, binning = port_image(tp.proj_to_torch(jproj), cfg)
    counts = binning.tile_starts[1:] - binning.tile_starts[:-1]
    assert not bool(binning.num_pairs > binning.pair_rank.shape[0])
    assert int((done < counts).sum()) >= counts.numel() // 3  # measured 10 / 6 of 12 tiles
    assert int(done.sum()) < 0.9 * int(counts.sum())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_empty_scene():
    # Zero-opacity cloud: every tile comes out exactly empty
    # (tests/test_pallas.py:52).
    jcam, _ = tp.cameras()
    g = tp.jax_scene(n=256, seed=1).activate()
    g = dataclasses.replace(g, opacities=np.zeros_like(np.asarray(g.opacities)))
    tproj = tp.proj_to_torch(jax_project(g, jcam))
    _, cfg = tp.configs()
    img, raw, done, _ = port_image(tproj, cfg)
    assert (img == 0).all() and (raw == 0).all() and (done == 0).all()


def test_overflow_is_reported(projections):
    # Under budget overflow the frame is wrong, so what matters is that it
    # is reported, with the same demand as the JAX pallas path
    # (tests/test_pallas.py:72).
    jcfg, cfg = tp.configs(pair_multiplier=0.5)
    jcam, tcam = tp.cameras()
    raw = tp.jax_scene()
    _, jstats = jax_render_with_stats(raw.activate(), jcam, config=jcfg, backend="pallas")
    img, stats = render_with_stats(tp.port_scene(raw).activate(), tcam, config=cfg, device="cpu")
    assert bool(jstats.overflowed) and bool(stats.overflowed)
    assert int(stats.num_pairs) == int(jstats.num_pairs)
    assert stats.budget == jstats.budget
    assert torch.isfinite(img).all()


def test_untile_layout():
    # Tile t, pixel (y, x) of the tile lands at image (ty*th + y, tx*tw + x).
    cfg = tp.configs(tile_h=2, tile_w=4)[1]
    width, height = 7, 3  # 2 x 2 tiles, cropped
    raw = torch.arange(5 * 4 * 8, dtype=torch.float32).reshape(5, 4, 8)
    img = trc.untile(raw, width, height, cfg)
    assert img.shape == (height, width, 4)
    for y in range(height):
        for x in range(width):
            t = (y // 2) * 2 + x // 4
            p = (y % 2) * 4 + x % 4
            assert torch.equal(img[y, x], raw[t, :, p])


def test_composite_tiles_rejects_bad_inputs(projections):
    _, tproj = projections
    _, cfg = tp.configs()
    binning, fields, _ = bin_and_prepare(tproj, tp.WIDTH, tp.HEIGHT, cfg)
    with pytest.raises(ValueError):
        trc.composite_tiles(fields[:9], binning.tile_starts, tp.WIDTH, tp.HEIGHT, cfg)
    with pytest.raises(ValueError):
        trc.composite_tiles(fields, binning.tile_starts.long(), tp.WIDTH, tp.HEIGHT, cfg)
    with pytest.raises(ValueError):  # neither CPU (plain version) nor CUDA (kernel)
        trc.composite_tiles(fields.to("meta"), binning.tile_starts.to("meta"), tp.WIDTH, tp.HEIGHT, cfg)


# The plain twin of a frame's record route (per-splat records read through
# the sort's splat ids) against its slot route (per-slot fields gathered by
# the permutation): the port's own sphere scene under every pack flag but
# center packing (which keeps the slot route), a few splats spanning most of
# the frame's tiles, the parity scenes' saturating stack, and a cloud of
# dead splats whose every slot is in the sentinel tile.
RECORD_CONFIGS = {
    "default": {}, "small-tiles": dict(tile_h=8, chunk_size=64), "axes-f16": dict(pack_axes_f16=True),
    "axes-u32": dict(pack_axes_u32=True), "color-rgba8": dict(pack_color_rgba8=True),
    "color-f32": dict(pack_color_f16=False), "no-discard": dict(alpha_discard=0.0, quad_clip=False),
    "headline-no-center": dict(tp.HEADLINE, pack_center_u32=False),
}
RECORD_SCENES = ("sphere", "many-tiles", "saturating", "sentinel-only")


def record_scene(scene):
    """The port's projection of one of RECORD_SCENES at 192x128."""
    if scene == "saturating":
        return tp.proj_to_torch(tp.saturating_projection())
    g = tsphere_scene(n=1500, seed=0).activate()
    cam = TCamera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, tp.WIDTH, tp.HEIGHT)
    proj = tproject(g, cam)
    if scene == "many-tiles":
        axis1, axis2 = proj.axis1.clone(), proj.axis2.clone()
        axis1[[7, 800]] = torch.tensor([90.0, 20.0])
        axis2[[7, 800]] = torch.tensor([-15.0, 60.0])
        proj = proj._replace(axis1=axis1, axis2=axis2)
    elif scene == "sentinel-only":
        proj = proj._replace(opacity=torch.zeros_like(proj.opacity))
    return proj


@pytest.mark.parametrize("scene, name", [(s, "default") for s in RECORD_SCENES[1:]]
                         + [("sphere", n) for n in RECORD_CONFIGS])
def test_plain_record_route_equals_slot_route(scene, name):
    proj, cfg = record_scene(scene), dataclasses.replace(tp.configs()[1], **RECORD_CONFIGS[name])
    if scene == "saturating":
        cfg = dataclasses.replace(cfg, pair_multiplier=24.0)
    b, fields, real = bin_and_prepare(proj, tp.WIDTH, tp.HEIGHT, cfg)
    b_r, record, real_r = bin_and_prepare(proj, tp.WIDTH, tp.HEIGHT, cfg, records=True)
    assert record.shape == (proj.depth.shape[0], tpe.RECORD_FLOATS) and int(real_r) == int(real)
    for field in ("pair_rank", "pair_tile", "tile_starts", "bounds", "num_pairs"):
        assert torch.equal(getattr(b_r, field), getattr(b, field)), field
    assert b_r.perm is None and b.perm is not None  # nothing per slot to move on the record route
    raw, done, ck = trc.composite_tiles(fields, b.tile_starts, tp.WIDTH, tp.HEIGHT, cfg, checkpoints=True)
    raw_r, done_r, ck_r = trc.composite_tiles(record, b_r.tile_starts, tp.WIDTH, tp.HEIGHT, cfg, checkpoints=True,
                                              pair_rank=b_r.pair_rank)
    assert torch.equal(raw_r.view(torch.int32), raw.view(torch.int32)) and torch.equal(done_r, done)
    assert torch.equal(ck_r.state.view(torch.int32), ck.state.view(torch.int32))
    used = int(b.tile_starts[-1])
    if scene == "sentinel-only":
        assert used == 0 and not raw.any()
    else:
        assert used > 0 and bool(raw[:, 3].max() > 0.5)
    if scene == "many-tiles":
        spans = torch.bincount(b.pair_rank[:used].long(), minlength=proj.depth.shape[0])
        assert int(spans[7]) > 6 and int(spans[800]) > 6  # of the 12 tiles
    if scene == "saturating":
        assert int((done < b.tile_starts[1:] - b.tile_starts[:-1]).sum()) > 0  # early exits taken


@pytest.mark.parametrize("name", ["default", "center-packing"])
def test_frame_route_follows_the_config(name, monkeypatch):
    # Rasterize without autograd hands K1 the records and the splat ids,
    # except under center packing, whose centers depend on the tile.
    cfg = tp.configs(**(tp.HEADLINE if name == "center-packing" else {}))[1]
    assert tpe.per_splat_fields(cfg) == (name == "default")
    proj = record_scene("sphere")
    if name == "center-packing":
        with pytest.raises(ValueError, match="center packing"):
            bin_and_prepare(proj, tp.WIDTH, tp.HEIGHT, cfg, records=True)
    seen = []
    real = trc.composite_tiles

    def spy(fields, *args, pair_rank=None, **kwargs):
        seen.append((tuple(fields.shape), pair_rank is not None))
        return real(fields, *args, pair_rank=pair_rank, **kwargs)

    monkeypatch.setattr(trc, "composite_tiles", spy)
    img, *_ = trc.rasterize(proj, tp.WIDTH, tp.HEIGHT, cfg)
    k = tpe.pair_budget(proj.depth.shape[0], cfg)
    want = [((1500, tpe.RECORD_FLOATS), True)] if name == "default" else [((tpe.NUM_FIELDS, k), False)]
    assert seen == want and bool(img[..., 3].max() > 0.5)
