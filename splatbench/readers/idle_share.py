"""Share of the traced window, in %, in which no operation ran on the device."""


def read(trace, least, **_):
    lo, hi = trace.window
    if hi <= lo or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_us() / (hi - lo))
