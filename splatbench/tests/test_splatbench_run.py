"""A run of a cell past the look for a card, on the CPU at a small size: the
result line's keys, and ``correct`` false when the timed path is broken
underneath; the controls read over the limits."""

import json
import time

import pytest
import torch
from conftest import bench_with_pending, small

from splatbench import control, harness
from unitygaussiansplatting_torch.models import trainer, viewer

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(workload: str, trace: bool = False, seed: int = 2**31 + 99):
    line, _ = harness.run_cell(workload, seed, 0.05, trace, "cpu", time.time(), overrides=small(workload),
                               bench=bench_with_pending())
    json.dumps(line)  # the line is JSON
    return line


@pytest.mark.parametrize("workload", ["bicycle-train", "bicycle-medium-view", "bicycle-view"])
def test_line_has_the_result_keys(workload):
    line = run(workload)
    assert set(line) == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    b = bench_with_pending()
    want = {m["name"] for m in b["end_to_end"] if harness.applies(m, workload)}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} and c["value"] <= c["limit"] for c in line["checks"].values())


def test_traced_line_adds_breakdown_and_window():
    line = run("bicycle-view", trace=True)
    assert set(line) == LINE_KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_state_left_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(trainer.GroupAdam, "update", lambda self, opt: None)
    line = run("bicycle-train")
    assert not line["correct"] and line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(monkeypatch):
    loss = trainer.photometric_loss
    monkeypatch.setattr(trainer, "photometric_loss", lambda img, target, w=0.2: loss(img[: img.shape[0] // 2],
                                                                                     target[: img.shape[0] // 2], w))
    assert not run("bicycle-train")["correct"]


def _one_pixel(img):
    img = img.clone()
    img[img.shape[0] // 2, img.shape[1] // 2, 0] += 0.01  # one channel of one pixel
    return img


def _half_rows(img):
    img = img.clone()
    img[img.shape[0] // 2:] = 0.0  # half of the frame left out
    return img


@pytest.mark.parametrize("workload", ["bicycle-medium-view", "bicycle-view"])
@pytest.mark.parametrize("fault", [_one_pixel, _half_rows])
def test_altered_frame_is_not_correct(monkeypatch, workload, fault):
    frame = viewer.ViewerSession.frame
    monkeypatch.setattr(viewer.ViewerSession, "frame", lambda self, *a, **kw: fault(frame(self, *a, **kw)))
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", ["bicycle-medium-view", "bicycle-view"])
def test_stale_frame_is_not_correct(monkeypatch, workload):
    """A viewer that hands back its last frame whatever the pose (its memo key never changes)."""
    monkeypatch.setattr(viewer.ViewerSession, "_key", staticmethod(lambda view, s, o: b"same"))
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload,fault", [("bicycle-train", "bf16"), ("bicycle-train", "half_batch"),
                                            ("bicycle-view", "bf16"), ("bicycle-medium-view", "bf16")])
def test_controls_read_over_the_limits(workload, fault):
    _, config, traffic = harness.resolve(bench_with_pending(), workload, small(workload))
    numbers = control.train_numbers if workload == "bicycle-train" else control.view_numbers
    got = numbers(config, traffic, 2**31 + 7, torch.device("cpu"), fault)
    assert any(not got[k] <= traffic["limits"][k] for k in got), got  # NaN fails too


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bicycle-train", "bicycle-view"])
def test_small_cell_on_the_card(card, workload):
    line, _ = harness.run_cell(workload, 2**31 + 3, 0.5, True, card, time.time(), overrides=small(workload),
                               bench=bench_with_pending())
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert line["metrics"], line
