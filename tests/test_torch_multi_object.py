"""A viewer session of several objects against the benchmark's plain
reference (``splatbench/reference/multi.py``), on the CPU.

``ViewerSession`` given a list of ``SplatObject`` renders its frame through
``render_multi``: the objects ordered by render order, then by their
origins' view depth, then by index; each projected under its model matrix,
binned and composited alone; the frames composited front to back.  The
reference does the same in plain PyTorch from the same seeded raw clouds,
views and model matrices.  A one-cloud session keeps its own path, and a
frame of several objects opens ``splat_order`` once and ``splat_object``
and ``splat_under`` once per object.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from splatbench import harness, poses, scenes  # noqa: E402
from splatbench.drivers.viewer import program_cameras, raster_config  # noqa: E402
from splatbench.reference import multi as ref_multi  # noqa: E402
from splatbench.reference import render as ref  # noqa: E402
from unitygaussiansplatting_torch.models import renderer, viewer  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import RawGaussians  # noqa: E402
from unitygaussiansplatting_torch.models.viewer import SplatObject, ViewerSession  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RenderSettings  # noqa: E402

torch.set_num_threads(2)

N, W, H = 2000, 96, 64
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
# The program and the reference project with the same operations in the
# same order (the model-view and inverse rotation by the same torch calls),
# so they differ only where the composite stops a tile: once every pixel's
# transmittance is under 1e-4, the program at global chunk boundaries of its
# pair list, the reference at its own.  What one object's frame leaves out
# or adds there is under 1e-4 of a color of at most 1.5 (1.5e-4), and its
# alpha moves by under 1e-4, which scales the frames behind it (1.5e-4
# more).  The bfloat16 reference misses by whole steps of a color.
TOL = 3e-4


def yaw(deg):
    a = math.radians(deg)
    return np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0], [-math.sin(a), 0.0, math.cos(a)]])


def models():
    """A rotated model at the origin, a translated one, one scaled by 0.5 (and moved)."""
    rotated, moved, scaled = (np.eye(4, dtype=np.float32) for _ in range(3))
    rotated[:3, :3] = yaw(50.0) @ np.array([[1.0, 0.0, 0.0], [0.0, math.cos(0.3), -math.sin(0.3)],
                                           [0.0, math.sin(0.3), math.cos(0.3)]])
    moved[:3, 3] = [1.5, 0.2, 1.0]
    scaled[:3, :3] = 0.5 * np.eye(3)
    scaled[:3, 3] = [-1.4, 0.0, -0.8]
    return [rotated, moved, scaled]


def config(sh_order):
    base = harness.load_json(harness.HERE / "configs" / "bicycle-6.1M.json")
    return dict(base, n_splats=N, width=W, height=H, sh_degree=sh_order)


VIEW = poses.look_at([2.5, 1.0, -5.5], [0.0, -0.2, 0.0])


@pytest.fixture(scope="module")
def raws():
    return [scenes.outdoor_scene(N, seed, "cpu") for seed in SEEDS]


def session(raws, sh_order, render_order=(0.0, 0.0, 0.0), pair_multiplier=None):
    cfg = config(sh_order)
    cam = program_cameras(cfg, [VIEW])[0]
    settings = RenderSettings(sh_order=sh_order)
    clouds = [RawGaussians(**raw).activate() for raw in raws]
    mats = [torch.from_numpy(m) for m in models()]
    if pair_multiplier is None:
        pair_multiplier = max(renderer.suggest_pair_multiplier(g, cam, settings, raster_config(cfg, 4.0), model=m,
                                                               device="cpu")[0] for g, m in zip(clouds, mats))
    scene = [SplatObject(g, model=m, render_order=o) for g, m, o in zip(clouds, mats, render_order)]
    return ViewerSession(scene, cam, settings, raster_config(cfg, pair_multiplier), device="cpu")


def reference_frame(raws, sh_order, render_order, dtype=torch.float32):
    ras = ref.Raster.from_config(config(sh_order))
    mats = models()
    parts = []
    for raw, m in zip(raws, mats):
        g = {k: v.to(dtype) for k, v in ref.activate(raw).items()}
        parts.append(ref_multi.render_object(g, VIEW, m, ras))
    order = ref_multi.object_order(VIEW, mats, list(render_order))
    return ref_multi.under([parts[i] for i in order]).float(), order


def depth_order():
    return ref_multi.object_order(VIEW, models(), [0.0, 0.0, 0.0])


def reversed_render_order():
    """Explicit render orders that put the farthest object in front."""
    out = [0.0] * 3
    for rank, i in enumerate(depth_order()):
        out[i] = float(rank)
    return tuple(out)


@pytest.mark.parametrize("sh_order", [0, 3])
@pytest.mark.parametrize("ordering", ["depth", "explicit_reversed"])
def test_session_frame_matches_reference(raws, sh_order, ordering):
    render_order = (0.0, 0.0, 0.0) if ordering == "depth" else reversed_render_order()
    with torch.no_grad():
        got = session(raws, sh_order, render_order).frame(view=torch.from_numpy(VIEW))
    want, order = reference_frame(raws, sh_order, render_order)
    assert order == (depth_order() if ordering == "depth" else depth_order()[::-1])
    assert got.shape == (H, W, 4) and float(want[..., 3].mean()) > 0.3
    err = float((got - want).abs().max())
    assert err <= TOL, err


def test_objects_overlap_so_the_order_matters(raws):
    """The depth order and its reverse give frames far apart: every case
    above checks the order, not only each object's frame."""
    a, _ = reference_frame(raws, 3, (0.0, 0.0, 0.0))
    b, _ = reference_frame(raws, 3, reversed_render_order())
    assert float((a - b).abs().max()) > 0.1


@pytest.mark.parametrize("sh_order", [0, 3])
def test_bf16_reference_fails_the_tolerance(raws, sh_order):
    want, _ = reference_frame(raws, sh_order, (0.0, 0.0, 0.0))
    low, _ = reference_frame(raws, sh_order, (0.0, 0.0, 0.0), dtype=torch.bfloat16)
    assert float((low - want).abs().max()) > TOL


def test_one_cloud_session_keeps_its_path(raws, monkeypatch):
    """One cloud without a model renders through ``render``, as before this
    session took scenes of several objects: ``render_multi`` is never
    called, and the frame equals ``render_with_stats``'s bit for bit."""
    cfg = config(3)
    cam = program_cameras(cfg, [VIEW])[0]
    g = RawGaussians(**raws[0]).activate()
    settings = RenderSettings(sh_order=3)
    rcfg = raster_config(cfg, 8.0)

    def no_multi(*a, **kw):
        raise AssertionError("a one-cloud session called render_multi")

    monkeypatch.setattr(viewer, "render_multi", no_multi)
    with torch.no_grad():
        got = ViewerSession(g, cam, settings, rcfg, device="cpu").frame(view=torch.from_numpy(VIEW))
        want, _ = renderer.render_with_stats(g, cam, settings, rcfg, device="cpu")
    assert torch.equal(got, want)


def test_memo_hit_renders_nothing(raws, monkeypatch):
    calls = []
    render = renderer.render
    monkeypatch.setattr(renderer, "render", lambda *a, **kw: calls.append(1) or render(*a, **kw))
    s = session(raws, 0, pair_multiplier=8.0)
    view = torch.from_numpy(VIEW)
    with torch.no_grad():
        first = s.frame(view=view)
        assert len(calls) == 3  # one render a object
        again = s.frame(view=view)
    assert again is first and len(calls) == 3
    assert (s.stats.frames, s.stats.rendered, s.stats.reused) == (2, 1, 1)
    s.update_gaussians([SplatObject(RawGaussians(**raws[0]).activate())])
    with torch.no_grad():
        s.frame(view=view)
    assert len(calls) == 4  # the new scene dropped the memo


def test_frame_spans(raws, tmp_path):
    """``splat_order`` once a frame, then ``splat_object`` (holding the
    render's ranges) and ``splat_under`` once per object, all inside
    ``splat_frame``."""
    s = session(raws, 3, pair_multiplier=8.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            s.frame(view=torch.from_numpy(VIEW))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("name", "").startswith("splat_")), key=lambda x: x[1])

    def inside(a, b):
        return b[1] <= a[1] and a[2] <= b[2]

    named = {}
    for sp in spans:
        named.setdefault(sp[0], []).append(sp)
    assert len(named["splat_frame"]) == 1 and len(named["splat_order"]) == 1
    assert len(named["splat_object"]) == 3 and len(named["splat_under"]) == 3
    frame = named["splat_frame"][0]
    assert all(inside(sp, frame) for sp in spans if sp is not frame)
    assert named["splat_order"][0][2] <= named["splat_object"][0][1]
    for obj, under in zip(named["splat_object"], named["splat_under"]):
        assert obj[2] <= under[1]  # each object composites after its render
        held = sorted(sp[0] for sp in spans if sp is not obj and inside(sp, obj))
        assert held == ["splat_bin", "splat_project", "splat_rasterize_cuda", "splat_sh", "splat_sort"], held
