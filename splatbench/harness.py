"""The benchmark's run of one cell: set-up, the measured window, the traced
units, the comparison with the reference, and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (its ``driver`` key names
``drivers/<driver>.py``), ``metrics/<metric>.json`` (its ``reader`` key
names ``readers/<reader>.py``).  A driver module has:

- ``setup(ctx) -> state``: the program's objects, built from the seed and
  warmed up on the cell's own shapes;
- ``pass_units(ctx, state)``: one pass of the traffic, in order;
- ``run_unit(ctx, state, unit)``: one frame or step, as the program's user
  calls it (the harness synchronizes after it);
- ``trace_units(ctx, state)``: the fixed units a traced run profiles, and
  optionally ``before_trace(ctx, state)``;
- ``release(ctx, state) -> outputs``: what the check reads, the program's
  state freed;
- ``reference(ctx, outputs, traced) -> (checks, least)``: the comparison
  with ``reference/`` (a list of ``(name, value, limit)``, a run is correct
  when every value is at or under its limit) and, for a traced run, the
  least seconds of each stage of each traced unit (``counts.py``);
- ``UNIT``: ``"frame"`` or ``"step"``, which names the end-to-end metrics
  ``<unit>_ms`` and ``<unit>_p95_ms``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "splatbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "unitygaussiansplatting_tpu"}
GIB = 2.0**30


def process_start_s() -> float:
    """The host clock (``time.time``) when this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs() -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port builds its CUDA libraries into ``build/cuda`` by itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending``, also the entries of the cells that
    wait in ``pending/`` for a fault of the program to be mended (the tests
    and the controls run them; the benchmark does not)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if pending:
        for path in sorted((HERE / "pending").glob("*.json")):
            for part, entries in load_json(path).items():
                if part in bench:
                    bench[part] = bench[part] + entries
    return bench


def module(kind: str, name: str):
    """``splatbench.<kind>.<name>``: a driver or a reader, by its file name."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad {kind} name {name!r}")
    return importlib.import_module(f"splatbench.{kind}.{name}")


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


@dataclasses.dataclass
class Context:
    """What a driver knows of its run."""

    seed: int
    seconds: float
    device: object
    config: dict
    traffic: dict
    started: float = 0.0
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note that a part of the set-up ended (seconds since the process started)."""
        self.sync()
        self.marks.append((name, time.time() - self.started))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def resolve(bench: dict, workload: str, overrides: dict | None = None):
    """The workload's entry, configuration and traffic, each found by name."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise SystemExit(f"unknown workload {workload!r}")
    w = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if len(conf) != 1:
        raise SystemExit(f"workload {workload!r}: unknown config {w['config']!r}")
    config = load_json(ROOT / conf[0]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    for key, value in (overrides or {}).get("config", {}).items():
        config[key] = value
    for key, value in (overrides or {}).get("traffic", {}).items():
        traffic[key] = value
    return w, config, traffic


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window(ctx: Context, driver, state) -> tuple[float, list[float]]:
    """Closed loop, one client: whole passes of the traffic until
    ``ctx.seconds`` have gone by.  Returns the window's seconds and each
    unit's seconds (its call to a synchronize)."""
    units = driver.pass_units(ctx, state)
    times = []
    clock = time.perf_counter
    start = clock()
    while True:
        for unit in units:
            t0 = clock()
            driver.run_unit(ctx, state, unit)
            ctx.sync()
            times.append(clock() - t0)
        if clock() - start >= ctx.seconds:
            break
    return clock() - start, times


def profile(ctx: Context, driver, state):
    """Profile the driver's fixed units; returns the parsed trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    from . import trace

    if hasattr(driver, "before_trace"):
        driver.before_trace(ctx, state)
    units = driver.trace_units(ctx, state)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    ctx.sync()
    with torch.profiler.profile(activities=activities) as prof:
        for unit in units:
            with record_function(trace.UNIT):
                driver.run_unit(ctx, state, unit)
                ctx.sync()
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    return trace.load(path), units


def per_layer(bench: dict, workload: str, tr, least) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, workload):
            continue
        spec = load_json(HERE / "metrics" / f"{m['name']}.json")
        value = module("readers", spec["reader"]).read(tr, least, **spec.get("args", {}))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(tr, main_tid) -> dict:
    """The device operations that took most time in the traced window, and
    its longest idle gaps, named by what the host was doing."""
    totals: dict[str, float] = {}
    lo, hi = tr.window
    for op in tr.ops:
        if op.end > lo and op.start < hi:
            totals[op.name] = totals.get(op.name, 0.0) + (op.end - op.start) * 1e-6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top], "idle_gaps": tr.idle_gaps(main_tid)}


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, device, started: float,
             overrides: dict | None = None, bench: dict | None = None) -> tuple[dict, list]:
    """Run one cell once; returns ``(result line, checks)``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    bench = bench if bench is not None else load_benchmark()
    w, config, traffic = resolve(bench, workload, overrides)
    device = torch.device(device)
    ctx = Context(seed=seed, seconds=seconds, device=device, config=config, traffic=traffic, started=started)
    if device.type == "cuda":
        torch.cuda.init()
    ctx.mark("python, torch and the card")
    driver = module("drivers", traffic["driver"])

    state = driver.setup(ctx)
    ctx.sync()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    print("set-up parts (s since process start): " + ", ".join(f"{n} {t:.2f}" for n, t in ctx.marks),
          file=sys.stderr)
    window_s, times = window(ctx, driver, state)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    tr = traced = None
    if trace_on:
        tr, traced = profile(ctx, driver, state)
    outputs = driver.release(ctx, state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, least = driver.reference(ctx, outputs, traced)
    del outputs
    gc.collect()

    unit = driver.UNIT
    e2e = {
        f"{unit}_ms": window_s * 1e3 / len(times),
        f"{unit}_p95_ms": percentile(times, 95.0) * 1e3,
        "peak_mem_gib": peak / GIB,
        "setup_s": setup_s,
    }
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    if trace_on:
        metrics = per_layer(bench, workload, tr, least)
        lo, hi = tr.window
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if applies(m, workload):
                if m["name"] not in e2e:
                    raise RuntimeError(f"{workload}: the harness has no {m['name']!r} for a {unit}")
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    failed = [c for c in checks if not c[1] <= c[2]]
    line = {"correct": not failed, "attempted": len(times), "failed": len(failed), "metrics": metrics,
            "device": dev}
    if trace_on:
        line["breakdown"] = breakdown(tr, tr.units[0].tid)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return line, checks
