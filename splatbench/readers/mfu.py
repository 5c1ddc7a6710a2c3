"""The whole unit's share of the chip's peak, in %: the sum of the least
times of all its stages over the unit's device span (first operation's
start to last operation's end), summed over the units."""


def read(trace, least, **_):
    span = sum(max(op.end for op in ops) - min(op.start for op in ops) for ops in trace.unit_ops() if ops) * 1e-6
    need = sum(sum(u.values()) for u in least)
    if span <= 0 or need <= 0:
        return None
    return 100.0 * need / span
