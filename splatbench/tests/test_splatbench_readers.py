"""The trace readers on a small trace with known numbers, and on a trace
recorded on the CPU (no device operations: every reader returns nothing)."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, record_function

from splatbench import harness, trace
from splatbench.harness import HERE


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": args}


# Two units of 1000 us on thread 1; the autograd engine on thread 2.
EVENTS = [
    _x("user_annotation", trace.UNIT, 1, 0, 1000), _x("user_annotation", trace.UNIT, 1, 1000, 1000),
    _x("user_annotation", "splat_project", 1, 100, 200), _x("user_annotation", "splat_project", 1, 1100, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 1, 150, 5, correlation=1),
    _x("kernel", "proj_kernel", 7, 200, 100, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernelExC", 1, 400, 5, correlation=2),
    _x("kernel", "void composite_fwd_kernel<1>(float const*)", 7, 450, 300, correlation=2),
    _x("cpu_op", "autograd::engine::evaluate_function: RasterizeBackward", 2, 500, 100),
    _x("cuda_runtime", "cudaLaunchKernel", 2, 520, 5, correlation=3),
    _x("kernel", "bwd_kernel", 7, 800, 100, correlation=3),
    _x("user_annotation", "Optimizer.step#Adam.step", 1, 900, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 1, 910, 5, correlation=4),
    _x("kernel", "adam_kernel", 7, 920, 40, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 1, 1150, 5, correlation=5),
    _x("kernel", "proj_kernel", 7, 1200, 100, correlation=5),
    _x("cuda_runtime", "cudaLaunchKernelExC", 1, 1400, 5, correlation=6),
    _x("kernel", "void composite_fwd_kernel<1>(float const*)", 7, 1450, 300, correlation=6),
    _x("cpu_op", "aten::sort", 1, 1750, 200),
]
LEAST = [{"k1": 150e-6, "project": 230e-6}, {"k1": 150e-6, "project": 125e-6}]


@pytest.fixture
def fixture_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.load(path)


def _read(name, tr, least=LEAST):
    spec = harness.load_json(HERE / "metrics" / f"{name}.json")
    return harness.module("readers", spec["reader"]).read(tr, least, **spec.get("args", {}))


def test_readers_on_known_numbers(fixture_trace):
    tr = fixture_trace
    assert tr.autograd_tids == {2} and len(tr.units) == 2
    assert tr.busy_us() == pytest.approx(940.0)
    assert _read("idle_pct.view", tr) == pytest.approx(100 * (1 - 940 / 2000))
    assert _read("project_ms.view", tr) == pytest.approx(0.1)  # 2 x 100 us over 2 units
    assert _read("decode_ms.view", tr) is None  # no such range: nothing to read
    assert _read("backward_ms.train", tr) == pytest.approx(0.05)
    assert _read("adam_ms.train", tr) == pytest.approx(0.02)
    assert _read("k1_roofline.view", tr) == pytest.approx(50.0)  # 300 us needed over 600 us of K1
    assert _read("k3_roofline.train", tr) is None
    # spans 200..960 and 1200..1750 us; 655 us needed
    assert _read("frame_mfu.view", tr) == pytest.approx(100 * 655 / 1310)
    gaps = tr.idle_gaps(1)
    assert gaps[0] == ["aten::sort", pytest.approx(250e-6)]  # 1750..2000 us
    assert gaps[1] == ["host", pytest.approx(240e-6)]  # 960..1200 us, between the units
    assert gaps[2] == ["splat_project", pytest.approx(200e-6)]  # 0..200 us


def test_recorded_cpu_trace_has_units_and_nothing_to_read(tmp_path):
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(trace.UNIT):
                with record_function("splat_project"):
                    torch.ones(64).cumsum(0)
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    tr = trace.load(path)
    assert len(tr.units) == 2 and any(r.name == "splat_project" for r in tr.ranges)
    assert not tr.ops
    for name in ("idle_pct.view", "project_ms.view", "k1_roofline.view", "frame_mfu.view", "backward_ms.train"):
        assert _read(name, tr) is None, name
