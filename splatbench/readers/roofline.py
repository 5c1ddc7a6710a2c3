"""A kernel's share of its roofline, in %: the reference's least time of
its stage over the kernel's device time, summed over the units."""


def read(trace, least, kernel, stage, **_):
    ops = [op for unit in trace.unit_ops() for op in unit if kernel in op.name]
    busy = sum(op.end - op.start for op in ops) * 1e-6
    need = sum(u.get(stage, 0.0) for u in least)
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * need / busy
