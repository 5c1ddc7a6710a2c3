"""The multi-object cell (``five-bicycle-view``) on the CPU at a small size:
its result line, ``correct`` false when the frame or the objects' order is
wrong, its reference against the one-object reference, and its bfloat16
control over the limit."""

import json
import time

import pytest
import torch
from conftest import SMALL

from splatbench import harness, poses, scenes
from splatbench.drivers import multi_viewer
from splatbench.reference import multi as ref_multi
from splatbench.reference import render as ref
from unitygaussiansplatting_torch.models import renderer, viewer

CELL = "five-bicycle-view"


def run(trace: bool = False, seed: int = 2**31 + 99):
    line, _ = harness.run_cell(CELL, seed, 0.05, trace, "cpu", time.time(), overrides=SMALL)
    json.dumps(line)
    return line


def test_line_is_correct_and_has_its_metrics():
    line = run()
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "peak_mem_gib", "setup_s"}
    assert line["checks"]["img_max_err"]["value"] <= 1e-5


def test_traced_line_leaves_out_what_the_cpu_cannot_read():
    line = run(trace=True)
    assert line["correct"] and "breakdown" in line and line["metrics"] == {}


def test_layout_of_the_configuration():
    _, config, traffic = harness.resolve(harness.load_benchmark(), CELL)
    assert len(config["objects"]) == 5 and config["reduced"] == [] and traffic["driver"] == "multi_viewer"
    m = [multi_viewer.model_matrix(o) for o in config["objects"]]
    assert [float(x[0, 0]) for x in m] == pytest.approx([1.0, 0.309017, -0.809017, -0.809017, 0.154508], abs=1e-6)
    assert all(abs(float((x[:3, 3] ** 2).sum()) - 16.0) < 1e-5 for x in m)


def test_wrong_object_order_is_not_correct(monkeypatch):
    multi = viewer.render_multi
    monkeypatch.setattr(viewer, "render_multi",
                        lambda clouds, cam, *a, render_order=None, **kw:
                        multi(clouds, cam, *a, render_order=list(range(len(clouds))), **kw))
    assert not run()["correct"]


def test_altered_frame_is_not_correct(monkeypatch):
    frame = viewer.ViewerSession.frame

    def one_pixel(self, *a, **kw):
        img = frame(self, *a, **kw).clone()
        img[img.shape[0] // 2, img.shape[1] // 2, 0] += 0.01
        return img

    monkeypatch.setattr(viewer.ViewerSession, "frame", one_pixel)
    assert not run()["correct"]


def test_identity_model_is_the_one_object_reference():
    cfg = dict(harness.load_json(harness.HERE / "configs" / "bicycle-6.1M.json"), width=96, height=64)
    ras = ref.Raster.from_config(cfg)
    g = ref.activate(scenes.outdoor_scene(3000, 5, "cpu"))
    view = poses.look_at([2.0, 0.5, -5.0], [0.0, 0.0, 0.0])
    one = ref.render(g, view, ras)
    assert float(one[..., 3].mean()) > 0.2
    assert torch.equal(ref_multi.render_object(g, view, torch.eye(4), ras), one)


def test_bf16_control_reads_over_the_limit():
    _, config, traffic = harness.resolve(harness.load_benchmark(), CELL, SMALL)
    seed = 2**31 + 7
    want, _ = multi_viewer.reference_frames(config, traffic, seed, torch.device("cpu"), [0, 3])
    low, _ = multi_viewer.reference_frames(config, traffic, seed, torch.device("cpu"), [0, 3], dtype=torch.bfloat16)
    err = max(float((low[p].float() - want[p]).abs().max()) for p in want)
    assert err > traffic["limits"]["img_max_err"]


def test_pair_budget_covers_every_object(monkeypatch):
    """Set-up takes the largest multiplier any object asks for under its model."""
    seen = []
    suggest = renderer.suggest_pair_multiplier

    def spy(*a, **kw):
        out = suggest(*a, **kw)
        seen.append((kw["model"], out[0]))
        return out

    monkeypatch.setattr(renderer, "suggest_pair_multiplier", spy)
    _, config, traffic = harness.resolve(harness.load_benchmark(), CELL, SMALL)
    ctx = harness.Context(seed=3, seconds=0.0, device=torch.device("cpu"), config=config, traffic=traffic,
                          started=time.time())
    st = multi_viewer.setup(ctx)
    assert len(seen) == 5 and all(m is not None for m, _ in seen)
    assert st.session._config.pair_multiplier == max(x for _, x in seen)
