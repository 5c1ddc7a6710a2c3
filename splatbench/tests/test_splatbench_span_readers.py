"""The readers of the program's spans inside a frame (``idle_in``,
``launched``) on a small trace with known numbers and on a trace recorded on
the CPU, and, on a card, ``host_syncs.view`` against the synchronizing
operations ``torch.cuda.set_sync_debug_mode`` reports in the same frame."""

import gc
import json
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, record_function

from splatbench import harness, trace
from splatbench.harness import HERE

FRAME = "splat_frame"
HTOD_PAGEABLE = "Memcpy HtoD (Pageable -> Device)"
DTOH_PAGEABLE = "Memcpy DtoH (Device -> Pageable)"


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _op(cat, name, launch, start, end, corr, launcher="cudaLaunchKernel"):
    """A device operation on stream 7 and its launch on thread 1."""
    return [_x("cuda_runtime", launcher, 1, launch, 5, correlation=corr),
            _x(cat, name, 7, start, end - start, correlation=corr)]


# Two units of 1000 us on thread 1, each with one frame range.
# Frame 1, 10..900 us: a pageable upload at 20..30, kernels at 100..300 and
# 250..950 (past the frame's end): busy 10 + 800, idle 80.
# Frame 2, 1010..1500 us: a pageable download at 1100..1110, a kernel at
# 1200..1400, a pinned upload at 1450..1460: busy 220, idle 270; then a kernel
# launched after the frame closed (1600), which is not the frame's.
EVENTS = [
    _x("user_annotation", trace.UNIT, 1, 0, 1000), _x("user_annotation", trace.UNIT, 1, 1000, 1000),
    _x("user_annotation", FRAME, 1, 10, 890), _x("user_annotation", FRAME, 1, 1010, 490),
    *_op("gpu_memcpy", HTOD_PAGEABLE, 15, 20, 30, 1, "cudaMemcpyAsync"),
    *_op("kernel", "proj_kernel", 40, 100, 300, 2),
    *_op("kernel", "sort_kernel", 60, 250, 950, 3),
    *_op("gpu_memcpy", DTOH_PAGEABLE, 1020, 1100, 1110, 4, "cudaMemcpyAsync"),
    *_op("kernel", "proj_kernel", 1050, 1200, 1400, 5),
    *_op("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1060, 1450, 1460, 6, "cudaMemcpyAsync"),
    *_op("kernel", "after_kernel", 1600, 1600, 1700, 7),
]

# One unit whose frame (100..200 us) launched nothing and found the device busy
# with a kernel launched before it.
BUSY_EVENTS = [
    _x("user_annotation", trace.UNIT, 1, 0, 1000), _x("user_annotation", FRAME, 1, 100, 100),
    *_op("kernel", "long_kernel", 10, 50, 300, 1),
]


def _load(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


def _read(name, tr, **override):
    spec = harness.load_json(HERE / "metrics" / f"{name}.json")
    return harness.module("readers", spec["reader"]).read(tr, None, **{**spec.get("args", {}), **override})


def test_span_readers_on_known_numbers(tmp_path):
    tr = _load(tmp_path, EVENTS)
    assert _read("frame_idle_ms.view", tr) == pytest.approx(0.175)  # median of 80 and 270 us
    assert _read("launches.view", tr) == pytest.approx(3.0)  # 3 + 3 over 2 frames
    assert _read("host_syncs.view", tr) == pytest.approx(1.0)  # the two pageable copies over 2 frames
    assert _read("launches.view", tr, names=["proj_kernel"]) == pytest.approx(1.0)


def test_span_readers_read_zero_when_the_frame_had_nothing(tmp_path):
    tr = _load(tmp_path, BUSY_EVENTS)
    for name in ("frame_idle_ms.view", "launches.view", "host_syncs.view"):
        value = _read(name, tr)
        assert value == 0.0 and isinstance(value, float), name


def test_span_readers_find_nothing_without_the_range(tmp_path):
    tr = _load(tmp_path, EVENTS)
    for name in ("frame_idle_ms.view", "launches.view", "host_syncs.view"):
        assert _read(name, tr, range="splat_other") is None, name


def test_span_readers_find_nothing_on_a_recorded_cpu_trace(tmp_path):
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(trace.UNIT):
                with record_function(FRAME):
                    with record_function("splat_sort"):
                        torch.ones(64).cumsum(0)
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    tr = trace.load(path)
    assert len(tr.units) == 2 and sum(r.name == FRAME for r in tr.ranges) == 2
    for name in ("frame_idle_ms.view", "launches.view", "host_syncs.view", "sort_ms.view", "sh_ms.view"):
        assert _read(name, tr) is None, name


def _sync_warnings(fn) -> int:
    """The synchronizing CUDA operations ``fn()`` runs, by the sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # The mode's own first use adds a notice that it is a prototype: not a sync.
    return sum(str(w.message).startswith("called a synchronizing CUDA operation") for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bicycle-medium-view", "bicycle-view"])
def test_host_syncs_equal_the_sync_debug_count(card, workload, tmp_path):
    bench = harness.load_benchmark()
    _, config, traffic = harness.resolve(bench, workload)
    ctx = harness.Context(seed=2**31 + 11, seconds=0.0, device=card, config=config, traffic=traffic,
                          started=time.time())
    driver = harness.module("drivers", traffic["driver"])
    st = driver.setup(ctx)
    pose = traffic["trace_poses"][0]
    try:
        st.session.invalidate()  # both frames below render
        ctx.sync()
        syncs = _sync_warnings(lambda: driver.run_unit(ctx, st, pose))
        ctx.sync()
        st.session.invalidate()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.UNIT):
                driver.run_unit(ctx, st, pose)
                ctx.sync()
        path = tmp_path / "frame.json"
        prof.export_chrome_trace(str(path))
        tr = trace.load(path)
        copies = sorted({op.name for op in tr.ops if "Memcpy" in op.name})
        print(f"{workload}: {syncs} sync warnings; copies in the frame's trace: {copies}")
        assert syncs >= 1
        assert _read("host_syncs.view", tr) == syncs
    finally:
        driver.release(ctx, st)
        del st
        gc.collect()
        torch.cuda.empty_cache()
