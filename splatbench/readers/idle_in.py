"""Idle device time inside a named host range, in ms a frame.

For each time the range opened inside a profiled unit (one
``record_function`` call of the program: ``splat_frame`` is one call of
``ViewerSession.frame``), the time while it was open on its thread and no
device operation ran on any stream; the metric is the median of these over
the traced frames, so that the profiler's own start, which falls in the
first traced frame, does not set it.  The time after the range closes, while
the device finishes what the frame queued, is not the range's.

Returns None when the trace holds no device operation (a CPU trace) or the
range never opened inside a unit; 0.0 when the device was busy all the
while the range was open.
"""

import bisect
import statistics


def opened(trace, name: str) -> list:
    """Every host range ``name`` that opened inside a profiled unit, by start."""
    starts = [u.start for u in trace.units]
    out = []
    for r in trace.ranges:
        if r.name != name:
            continue
        i = bisect.bisect_right(starts, r.start) - 1
        if i >= 0 and r.start <= trace.units[i].end:
            out.append(r)
    return sorted(out, key=lambda r: r.start)


def idle_us(ops, start: float, end: float) -> float:
    """Microseconds of ``[start, end]`` in which none of ``ops`` (by start) ran."""
    busy, edge = 0.0, start
    for op in ops:
        if op.start >= end:
            break
        s, e = max(op.start, edge), min(op.end, end)
        if e > s:
            busy += e - s
            edge = e
    return (end - start) - busy


def read(trace, least, range, **_):
    spans = opened(trace, range)
    if not trace.ops or not spans:
        return None
    return statistics.median(idle_us(trace.ops, r.start, r.end) for r in spans) * 1e-3
