"""Per-layer metric readers.  Each module has ``read(trace, least, **args)``:
``trace`` a ``splatbench.trace.Trace`` of the profiled units, ``least`` the
reference's least seconds of each stage, one dict a unit
(``splatbench.counts``); it returns the metric's value, or None when the
trace holds nothing for it (the harness then leaves the metric out)."""
