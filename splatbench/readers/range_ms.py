"""Device ms a unit of the operations launched inside a named host range
(``record_function`` of the program, or an operator's own range)."""


def read(trace, least, range, prefix=False, **_):
    ops = [op for unit in trace.unit_ops() for op in unit]
    mine = trace.launched_in(ops, range, prefix)
    if not mine:
        return None
    return sum(op.end - op.start for op in mine) * 1e-3 / len(trace.units)
