"""Device ms a unit of the operations launched by the autograd engine's
threads: the backward pass."""


def read(trace, least, **_):
    ops = [op for unit in trace.unit_ops() for op in unit if op.tid in trace.autograd_tids]
    if not ops:
        return None
    return sum(op.end - op.start for op in ops) * 1e-3 / len(trace.units)
