"""The port's ``torch.profiler`` ranges inside a viewer frame, on the CPU.

``ViewerSession.frame`` opens ``splat_frame`` once a call, a memo hit too;
inside a rendered frame ``splat_decode`` (a ``DeviceAsset`` only),
``splat_project`` holding the SH shading's ``splat_sh``, and
``splat_rasterize_cuda`` holding ``splat_bin``, which holds the sort's
``splat_sort``.  The ranges label the trace and change nothing: the image is
bit-identical with the profiler on and off.  The ``"torch"`` backend labels
its binning ``splat_bin`` and nothing after it.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from unitygaussiansplatting_torch.io.device_asset import encode_device  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.viewer import ViewerSession  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402

torch.set_num_threads(2)

W, H = 128, 64
SETTINGS = RenderSettings(sh_order=3)
CONFIG = RasterizeConfig(pair_multiplier=8.0)


def views():
    """Two poses looking at the sphere from either side of its axis."""
    out = []
    for angle in (0.0, 0.4):
        eye = (3.0 * math.sin(angle), 0.3, -3.0 * math.cos(angle))
        out.append(Camera.look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 50.0, W, H).view)
    return out


def scene(kind):
    g = sphere_scene(n=1500, seed=5).activate()
    return encode_device(g, device="cpu") if kind == "asset" else g


def session(g, backend="cuda"):
    cam = Camera.look_at((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 50.0, W, H)
    return ViewerSession(g, cam, SETTINGS, CONFIG, backend=backend, device="cpu")


def spans(prof, path):
    """The ``splat_*`` ranges of a trace: (name, start, end, thread), by start."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events
           if e.get("ph") == "X" and e.get("name", "").startswith("splat_")]
    return sorted(out, key=lambda s: s[1])


def inside(child, parent):
    return child[3] == parent[3] and parent[1] <= child[1] and child[2] <= parent[2]


@pytest.fixture(scope="module", params=["float", "asset"])
def profiled(request, tmp_path_factory):
    """Two rendered frames and a memo hit under the profiler, and the same
    two frames from a session that was never profiled."""
    g = scene(request.param)
    v0, v1 = views()
    s = session(g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            imgs = [s.frame(view=v0), s.frame(view=v1), s.frame(view=v1)]
    plain = session(g)
    with torch.no_grad():
        unprofiled = [plain.frame(view=v0), plain.frame(view=v1)]
    found = spans(prof, tmp_path_factory.mktemp("spans") / "trace.json")
    return {"kind": request.param, "spans": found, "imgs": imgs, "unprofiled": unprofiled, "stats": s.stats}


def _one_range_per_frame(p):
    frames = [s for s in p["spans"] if s[0] == "splat_frame"]
    assert len(frames) == 3 and p["stats"].frames == 3 and p["stats"].rendered == 2
    assert not any(inside(a, b) for a in frames for b in frames if a is not b)
    for s in p["spans"]:
        if s[0] != "splat_frame":
            assert sum(inside(s, f) for f in frames) == 1, s


def _nesting(p):
    frames = [s for s in p["spans"] if s[0] == "splat_frame"][:2]
    for f in frames:
        within = [s for s in p["spans"] if s is not f and inside(s, f)]
        names = sorted(s[0] for s in within)
        want = ["splat_bin", "splat_project", "splat_rasterize_cuda", "splat_sh", "splat_sort"]
        assert names == sorted(want + (["splat_decode"] if p["kind"] == "asset" else [])), names
        named = {s[0]: s for s in within}
        assert inside(named["splat_sh"], named["splat_project"])
        assert inside(named["splat_bin"], named["splat_rasterize_cuda"])
        assert inside(named["splat_sort"], named["splat_bin"])
        if p["kind"] == "asset":
            assert named["splat_decode"][2] <= named["splat_project"][1]


def _memo_hit(p):
    hit = [s for s in p["spans"] if s[0] == "splat_frame"][2]
    assert not [s for s in p["spans"] if s is not hit and inside(s, hit)]
    assert p["imgs"][2] is p["imgs"][1]


def _bit_identical(p):
    for got, want in zip(p["imgs"][:2], p["unprofiled"]):
        assert got.shape == (H, W, 4) and float(want[..., 3].max()) > 0
        assert torch.equal(got, want)


CHECKS = {"one_range_per_frame": _one_range_per_frame, "nesting": _nesting, "memo_hit": _memo_hit,
          "bit_identical": _bit_identical}


@pytest.mark.parametrize("check", list(CHECKS))
def test_view_frame_spans(profiled, check):
    CHECKS[check](profiled)


def test_torch_backend_labels_binning_alone(tmp_path):
    s = session(scene("float"), backend="torch")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            s.frame(view=views()[0])
    names = {x[0] for x in spans(prof, tmp_path / "trace.json")}
    assert names == {"splat_frame", "splat_project", "splat_sh", "splat_bin"}, names
