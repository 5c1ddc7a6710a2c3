"""Device operations (kernels, copies, sets) launched inside a named host
range, as a mean per time the range opened inside a profiled unit (a frame
for ``splat_frame``).

``names`` keeps only the operations whose name contains one of them.  With
the names of the copies from and to pageable host memory (CUPTI's
``Memcpy HtoD (Pageable -> Device)`` and ``Memcpy DtoH (Device ->
Pageable)``) it counts the blocking copies: torch returns from such a copy
only after the stream has drained to it, so each is a point where the
device's queue empties.  On the H100 that count equals the synchronizing
operations ``torch.cuda.set_sync_debug_mode("warn")`` reports in a view
frame of each view cell (``splatbench/tests/test_splatbench_span_readers.py``).

Returns None when the trace holds no device operation (a CPU trace) or the
range never opened inside a unit; 0.0 when it opened and nothing launched
inside it matched.
"""

from .idle_in import opened


def read(trace, least, range, names=None, **_):
    frames = len(opened(trace, range))
    if not trace.ops or not frames:
        return None
    ops = trace.launched_in([op for unit in trace.unit_ops() for op in unit], range)
    if names is not None:
        ops = [op for op in ops if any(n in op.name for n in names)]
    return len(ops) / frames
