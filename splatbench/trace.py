"""Read a ``torch.profiler`` Chrome trace into what the per-layer readers need.

Device operations (kernels, copies, sets) are tied to the host call that
launched them through the trace's ``correlation`` ids; a host range
(``record_function``) owns the operations launched on its thread while it
was open.  The harness wraps each profiled frame or step in a range named
``UNIT``; an operation belongs to the unit whose range was open when it was
launched, on any thread (a unit ends in a synchronize, so units do not
overlap).
"""

from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
from pathlib import Path

UNIT = "splatbench_unit"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
RANGE_CATS = {"user_annotation", "cpu_op", "python_function"}
AUTOGRAD_PREFIX = "autograd::engine::evaluate_function"


@dataclasses.dataclass
class Op:
    name: str
    start: float  # us
    end: float
    tid: object = None  # the launching host thread
    launch: float | None = None  # the launch's time, us


@dataclasses.dataclass
class Range:
    name: str
    tid: object
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    ops: list[Op]  # device operations, by start
    ranges: list[Range]  # host ranges and operators
    units: list[Range]  # the profiled units, in order
    autograd_tids: set

    @property
    def window(self) -> tuple[float, float]:
        return self.units[0].start, self.units[-1].end

    def unit_ops(self) -> list[list[Op]]:
        """The device operations of each unit, by their launch time."""
        starts = [u.start for u in self.units]
        out = [[] for _ in self.units]
        for op in self.ops:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= self.units[i].end:
                out[i].append(op)
        return out

    def busy_us(self) -> float:
        """Microseconds of the window in which some device operation ran."""
        lo, hi = self.window
        busy, cur_s, cur_e = 0.0, None, None
        for op in self.ops:
            s, e = max(op.start, lo), min(op.end, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def launched_in(self, ops: list[Op], name: str, prefix: bool = False) -> list[Op]:
        """The operations of ``ops`` launched on a thread while a range
        ``name`` (or one whose name starts with it) was open there."""
        spans: dict = {}
        for r in self.ranges:
            if r.name.startswith(name) if prefix else r.name == name:
                spans.setdefault(r.tid, []).append((r.start, r.end))
        for v in spans.values():
            v.sort()
        out = []
        for op in ops:
            v = spans.get(op.tid)
            if op.launch is None or not v:
                continue
            # Ranges of one name follow each other on a thread: the last
            # one opened before the launch is the only one that can hold it.
            i = bisect.bisect_right(v, (op.launch, float("inf"))) - 1
            if i >= 0 and v[i][0] <= op.launch <= v[i][1]:
                out.append(op)
        return out

    def idle_gaps(self, main_tid, top: int = 10) -> list[list]:
        """The longest spans of the window with no device operation, each
        named by the innermost host range open on ``main_tid`` at its middle."""
        lo, hi = self.window
        gaps, edge = [], lo
        for op in sorted(self.ops, key=lambda o: o.start):
            if op.start > edge:
                gaps.append((edge, min(op.start, hi)))
            edge = max(edge, op.end)
            if edge >= hi:
                break
        if edge < hi:
            gaps.append((edge, hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            open_ = [r for r in self.ranges if r.tid == main_tid and r.start <= mid <= r.end and r.name != UNIT]
            name = min(open_, key=lambda r: r.end - r.start).name if open_ else "host"
            out.append([name, (e - s) * 1e-6])
        return out


def load(path: str | Path) -> Trace:
    """Parse a Chrome trace written by ``torch.profiler``'s ``export_chrome_trace``."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    launches, ops, ranges, autograd = {}, [], [], set()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((Op(name, ts, ts + dur), args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if "correlation" in args:
                launches[args["correlation"]] = (ev.get("tid"), ts)
        elif cat in RANGE_CATS:
            ranges.append(Range(name, ev.get("tid"), ts, ts + dur))
            if name.startswith(AUTOGRAD_PREFIX):
                autograd.add(ev.get("tid"))
    out = []
    for op, corr in ops:
        if corr in launches:
            op.tid, op.launch = launches[corr]
        out.append(op)
    out.sort(key=lambda o: o.start)
    units = sorted((r for r in ranges if r.name == UNIT), key=lambda r: r.start)
    return Trace(out, [r for r in ranges if r.name != UNIT], units, autograd)
