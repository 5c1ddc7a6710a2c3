"""K1's checkpoints and K3's segments, on the CPU through the plain versions.

K1 saves every pixel's state at the start of each segment of a tile's walk;
K3 runs each segment from its checkpoint.  The segmented walk must be the
whole-tile walk: checkpoints equal the walk's state, and the segmented K3
equals the whole-tile K3 and the JAX package's Pallas backward.  Small
segment lengths make the 1500-splat scene's busiest tile span several
segments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
import unitygaussiansplatting_tpu.ops.rasterize_pallas as rpal  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.ops import cuda_build  # noqa: E402
from unitygaussiansplatting_torch.ops import pair_expand as tpe  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda as trc  # noqa: E402
from unitygaussiansplatting_torch.ops import rasterize_cuda_bwd as tbwd  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_tpu.ops import pair_expand as jpe  # noqa: E402
from unitygaussiansplatting_tpu.ops import rasterize_pallas_bwd as jbwd  # noqa: E402
from unitygaussiansplatting_tpu.ops.binning import tile_grid  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402

torch.set_num_threads(2)

W, H = tp.WIDTH, tp.HEIGHT
CASES = {
    "default": {},
    "small-tiles": dict(tile_h=8, chunk_size=64),
    "headline": dict(tp.HEADLINE, pack_grads_bf16=False),
    # Nearly opaque splats: most tiles exit part-way, inside a segment.
    "saturating": dict(pair_multiplier=24.0, chunk_size=64),
}
# The segmented K3 against the whole-tile K3: the same terms, except that a
# segment's prefix of u starts at D . (K1's color sums) instead of K3's own
# running sum; measured <= 2e-7 of each field's max on these scenes.
SEGMENT_REL_TO_MAX = 1e-6
K3_PALLAS_REL_TO_MAX = 1e-4  # tests/test_torch_backward.py


@pytest.fixture(scope="module")
def projections():
    jcam, _ = tp.cameras()
    jproj = jax_project(tp.jax_scene().activate(), jcam)
    return {"sphere": tp.proj_to_torch(jproj), "saturating": tp.proj_to_torch(tp.saturating_projection())}


def sorted_pairs(projections, name):
    cfg = RasterizeConfig(**CASES[name])
    proj = projections["saturating" if name == "saturating" else "sphere"]
    binning, fields, _ = tpe.bin_and_prepare(proj, W, H, cfg)
    return cfg, binning, fields


def upstream(cfg, num_tiles):
    rng = np.random.default_rng(5)
    dout = torch.from_numpy(rng.normal(size=(num_tiles + 1, 4, cfg.tile_w * cfg.tile_h)).astype(np.float32))
    dout[-1] = 0.0
    return dout


@pytest.mark.parametrize("name", list(CASES))
def test_plain_k1_checkpoints_match_walk(projections, name):
    cfg, binning, fields = sorted_pairs(projections, name)
    ts = binning.tile_starts
    raw, done, none = trc.composite_tiles_plain(fields, ts, W, H, cfg)
    assert none is None  # no checkpoints unless asked
    every = trc.composite_tiles_plain(fields, ts, W, H, cfg, checkpoints=True, segment_steps=1)
    third = trc.composite_tiles_plain(fields, ts, W, H, cfg, checkpoints=True, segment_steps=3)
    # Saving checkpoints does not change the walk.
    for got in (every, third):
        assert torch.equal(got[0], raw) and torch.equal(got[1], done)
    ck1, ck3 = every[2], third[2]
    assert ck3.segment_steps == 3 and torch.equal(ck3.pairs_done, done)
    c = cfg.chunk_size
    starts = ts.tolist()
    for t in range(ts.numel() - 1):
        s, e = starts[t], starts[t + 1]
        steps = 0 if e <= s else (e - 1) // c - s // c + 1
        seg1, seg3 = int(ck1.seg_starts[t]), int(ck3.seg_starts[t])
        assert int(ck1.seg_starts[t + 1]) - seg1 == steps
        assert int(ck3.seg_starts[t + 1]) - seg3 == -(-steps // 3)
        for step in range(steps):
            lo = max(s, (s // c + step) * c)
            if lo - s >= int(done[t]):
                assert (ck1.state[seg1 + step] == 0).all()  # never reached: never written
                continue
            # The state at a segment start is the state at that step (exact).
            if step % 3 == 0:
                assert torch.equal(ck3.state[seg3 + step // 3], ck1.state[seg1 + step])
            # ... and the walk truncated there ends in it: its color sums
            # exactly, its coverage as 1 - T (T carried as a product).
            cut = ts.clone()
            cut[t + 1:] = torch.clamp(cut[t + 1:], min=lo)
            cut[t + 1] = lo
            part, _, _ = trc.composite_tiles_plain(fields, cut, W, H, cfg)
            assert torch.equal(ck1.state[seg1 + step, 1:], part[t, :3])
            torch.testing.assert_close(ck1.state[seg1 + step, 0], 1.0 - part[t, 3], rtol=0, atol=1e-6)
    assert int(ck3.seg_starts[-1]) <= ck3.state.shape[0]
    if name == "default":
        assert int(((ck3.seg_starts[1:] - ck3.seg_starts[:-1])).max()) >= 2


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_segmented_plain_k3_matches_whole_walk(projections, name, bf16):
    cfg, binning, fields = sorted_pairs(projections, name)
    cfg = RasterizeConfig(**dict(CASES[name], pack_grads_bf16=bf16))
    ts, perm = binning.tile_starts, binning.perm
    raw, done, ck = trc.composite_tiles_plain(fields, ts, W, H, cfg, checkpoints=True, segment_steps=1)
    segs = ck.seg_starts[1:] - ck.seg_starts[:-1]
    assert int(segs.max()) >= 3  # the busiest tile spans at least 3 segments
    dout = upstream(cfg, ts.numel() - 1)
    # One segment per tile, from the walk's start: K3's whole-tile walk.
    _, _, whole_ck = trc.composite_tiles_plain(fields, ts, W, H, cfg, checkpoints=True,
                                               segment_steps=tp.WHOLE_TILE_STEPS)
    assert torch.equal(whole_ck.seg_starts[1:] - whole_ck.seg_starts[:-1], (ts[1:] > ts[:-1]).int())
    whole, done_whole = tbwd.composite_bwd(fields, ts, raw, dout, perm, W, H, cfg, checkpoints=whole_ck)
    seg, done_seg = tbwd.composite_bwd(fields, ts, raw, dout, perm, W, H, cfg, checkpoints=ck)
    assert seg.dtype == whole.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert torch.equal(done_seg, done_whole) and torch.equal(done_seg, done)
    scale = whole.float().abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    rel = (seg.float() - whole.float()).abs() / scale
    if bf16:
        # Each rounds its own f32 sum: at most the neighbouring bf16 value.
        distance, limit = tbwd.k3_distance(seg, whole)
        assert distance <= limit
    else:
        assert float(rel.max()) <= SEGMENT_REL_TO_MAX
        assert torch.equal(seg != 0, whole != 0)


@pytest.mark.parametrize("name", ["default", "headline"])
def test_segmented_plain_k3_matches_pallas_bwd(name):
    # tests/test_torch_backward.py::test_k3_plain_matches_pallas_bwd with the
    # port's K1 checkpoints, one segment per step.
    jcfg, cfg = tp.configs(**dict(tp.CONFIGS[name], pack_grads_bf16=False))
    jcam, _ = tp.cameras()
    jproj = jax_project(tp.jax_scene(n=600, seed=2).activate(), jcam)
    tiles_x, tiles_y = tile_grid(W, H, jcfg)
    binning, jfields, _ = jpe.bin_and_prepare(jproj, W, H, jcfg, interpret=True)
    schedule = rpal.build_schedule(binning, tiles_x * tiles_y, jcfg.chunk_size)
    _, raw = rpal.composite_pallas(jfields, schedule, W, H, jcfg, interpret=True, return_raw=True)
    rng = np.random.default_rng(5)
    dout = rpal.tile_layout(rng.normal(size=(H, W, 4)).astype(np.float32), W, H, jcfg)
    dsteps = jbwd.composite_pallas_bwd(jfields, schedule, raw, dout, W, H, jcfg, interpret=True)
    dpairs = np.asarray(jbwd.steps_to_pair_gradients(dsteps, binning, tiles_x * tiles_y, jcfg.chunk_size))
    want = dpairs.transpose(1, 0, 2).reshape(dpairs.shape[1], -1)

    f10 = torch.from_numpy(np.asarray(jfields).transpose(1, 0, 2).reshape(jfields.shape[1], -1)[:10].copy())
    ts = torch.from_numpy(np.array(binning.tile_starts))
    _, _, ck = trc.composite_tiles_plain(f10, ts, W, H, cfg, checkpoints=True, segment_steps=1)
    assert int((ck.seg_starts[1:] - ck.seg_starts[:-1]).max()) >= 2
    got, _ = tbwd.composite_bwd(f10, ts, torch.from_numpy(np.array(raw)), torch.from_numpy(np.array(dout)),
                                torch.arange(f10.shape[1]), W, H, cfg, checkpoints=ck)
    got = got.numpy()
    for f in range(10):
        scale = max(np.abs(want[f]).max(), 1e-12)
        assert np.abs(got[f] - want[f]).max() / scale <= K3_PALLAS_REL_TO_MAX, f
        np.testing.assert_array_equal(got[f] != 0, want[f] != 0)


@pytest.mark.parametrize("steps", [1, 4, 16])
def test_segment_layout_fits_capacity(steps):
    # Tile ranges cut from random splits of K pairs, empty tiles included.
    rng = np.random.default_rng(steps)
    for chunk in (32, 256):
        k, tiles = int(rng.integers(1, 20_000)), int(rng.integers(1, 60))
        cuts = np.sort(rng.integers(0, k + 1, size=tiles))
        ts = torch.from_numpy(np.concatenate([[0], cuts]).astype(np.int32))
        seg_starts = tbwd.segment_starts(ts, chunk, steps)
        assert seg_starts.dtype == torch.int32 and seg_starts.shape == (tiles + 1,)
        lengths = (ts[1:] - ts[:-1]).long()
        n_steps = torch.where(lengths > 0, (ts[1:].long() - 1) // chunk - ts[:-1].long() // chunk + 1, 0)
        assert torch.equal((seg_starts[1:] - seg_starts[:-1]).long(), -(-n_steps // steps))
        assert int(seg_starts[-1]) <= tbwd.segment_capacity(k, tiles, chunk, steps)


def test_segment_pairs_cover_the_walk(projections):
    cfg, binning, fields = sorted_pairs(projections, "saturating")
    ts = binning.tile_starts
    _, done, ck = trc.composite_tiles_plain(fields, ts, W, H, cfg, checkpoints=True, segment_steps=2)
    tile, pairs = tbwd.segment_pairs(ts, ck, cfg.chunk_size)
    total = int(ck.seg_starts[-1])
    assert (pairs[total:] == -1).all() and (pairs[:total] >= 0).all()
    assert pairs.max() <= 2 * cfg.chunk_size
    per_tile = torch.zeros_like(done, dtype=torch.int64).index_add_(0, tile[:total], pairs[:total])
    assert torch.equal(per_tile, done.long())
    assert int((done < ts[1:] - ts[:-1]).sum()) > 0  # some tiles exit inside a segment


def test_render_under_no_grad_saves_no_checkpoints(monkeypatch):
    asked = []
    real = trc.composite_tiles

    def spy(*args, **kwargs):
        asked.append(kwargs.get("checkpoints", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(trc, "composite_tiles", spy)
    _, cam = tp.cameras()
    g = tp.port_scene(tp.jax_scene(n=200, seed=1)).activate()
    with torch.no_grad():
        trd.render(g, cam, device="cpu")
    trd.render(g, cam, device="cpu")  # nothing requires a gradient
    g.opacities.requires_grad_(True)
    img = trd.render(g, cam, device="cpu")
    assert asked == [False, False, True]
    img.sum().backward()
    assert torch.isfinite(g.opacities.grad).all() and float(g.opacities.grad.abs().max()) > 0


def test_composite_bwd_rejects_bad_checkpoints(projections):
    cfg, binning, fields = sorted_pairs(projections, "default")
    ts = binning.tile_starts
    raw, _, ck = trc.composite_tiles_plain(fields, ts, W, H, cfg, checkpoints=True)
    args = (fields, ts, raw, torch.zeros_like(raw), binning.perm, W, H, cfg)
    tbwd.composite_bwd(*args, checkpoints=ck)
    for bad in (ck._replace(state=ck.state[:, :3]), ck._replace(seg_starts=ck.seg_starts.long()),
                ck._replace(pairs_done=ck.pairs_done[:-1]), ck._replace(segment_steps=0)):
        with pytest.raises(ValueError):
            tbwd.composite_bwd(*args, checkpoints=bad)
    with pytest.raises(ValueError):
        trc.composite_tiles(fields, ts, W, H, cfg, checkpoints=True, segment_steps=0)


@pytest.mark.parametrize("keys_only", [False, True])
def test_expand_probe_plain_writes_zeros(keys_only):
    before = cuda_build.launched.copy()
    comp, fields = tpe.expand_probe(1000, "cpu", keys_only=keys_only)
    assert cuda_build.launched == before  # the plain version launches nothing
    assert comp.shape == (1000,) and comp.dtype == torch.int64 and not comp.any()
    if keys_only:
        assert fields is None
    else:
        assert fields.shape == (tpe.NUM_FIELDS, 1000) and fields.dtype == torch.float32 and not fields.any()
    with pytest.raises(ValueError):
        tpe.expand_probe(10, "meta")
