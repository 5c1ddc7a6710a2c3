"""Per-stage timing, frame traces and a bytes model of the forward frame.

The analog of the reference's ProfilerMarkers
(GaussianSplatRenderer.cs:20-22 ``GaussianSplat.{Draw,Compose,CalcView}``
and :287 ``GaussianSplat.Sort``), which give the readme's published phase
breakdown (readme.md:84).  Two mechanisms:

- ``torch.profiler.record_function`` ranges inside ``render_with_stats``
  (``splat_decode``; ``splat_project`` with the SH shading's ``splat_sh``
  inside it; ``splat_rasterize_cuda`` with ``splat_bin`` inside it and the
  pair sort's ``splat_sort`` inside that), and
  ``splat_frame`` around a whole ``ViewerSession.frame``, label the frame's
  kernels in a ``torch.profiler`` trace; :func:`trace_frame` captures one.
- :func:`render_phases` times each stage of the forward as its own call.
  The stage boundaries follow the frame's dataflow, so their sum comes
  close to the fused frame's time.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import torch

from ..ops.binning import pair_budget, tile_grid
from ..ops.pair_expand import NUM_FIELDS, TABLE_ROWS, bin_and_prepare, per_splat_fields
from ..ops.projection import project_splats
from ..ops.rasterize_cuda import composite_tiles, untile
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device

# The H100 SXM's published HBM rate (NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
# The stage model counts the pair sort as a library radix sort of the int64
# keys (torch.sort): all 64 key bits, 8 bits a pass, each pass reading and
# writing the keys and the int64 indices.  splatbench/counts.py's yardstick
# holds the same figures (its tests hold the two equal); the port's own
# sort (csrc/pair_sort.cu) moves about a third of those bytes.
SORT_KEY_BITS, SORT_BITS_PER_PASS = 64, 8


def trace_frame(fn, *args, logdir: str | None = None):
    """A ``torch.profiler`` trace of one call ``fn(*args)``, with CPU and,
    where a card is present, CUDA activity; one untraced call first builds
    the kernels and fills the allocator.  Writes a Chrome trace
    (``frame_trace.json``) to ``logdir`` (a new temporary directory when
    None) and returns ``(out, trace path)``.  The ranges inside the render
    path label its stages in the trace.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    out = fn(*args)
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
    logdir = logdir or tempfile.mkdtemp(prefix="splat_trace_")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "frame_trace.json")
    prof.export_chrome_trace(path)
    return out, path


def _time_call(fn, device: torch.device, reps: int):
    """Mean ms of ``reps`` calls of ``fn`` and its last output: CUDA events on
    a card, the host clock on the CPU.  Two untimed calls first, both outputs
    alive, so that the timed calls find the allocator holding what they
    need."""
    first = fn()
    out = fn()
    del first
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def binning_bytes(n: int, k: int) -> dict:
    """The bytes the per-splat pass and K2 must move at ``n`` splats and a
    pair budget of ``k`` slots, each input read once and each output written
    once: the pass reads the projected view fields (center, both axes,
    color, opacity, depth, the valid byte; not the conic) and writes the
    (TABLE_ROWS, n) table, the n + 1 run bounds and the real-pair count; K2
    reads the table and the bounds and writes an int64 key and NUM_FIELDS
    float32 fields a slot.  The kernels' bounds and :func:`phase_roofline`
    both count with this."""
    view_in = (2 + 2 + 2 + 3 + 1 + 1) * 4 + 1
    table_and_bounds = n * TABLE_ROWS * 4 + (n + 1) * 4
    return {
        "per_splat_pass": n * view_in + table_and_bounds + 4,
        "k2": table_and_bounds + k * (8 + NUM_FIELDS * 4),
    }


def phase_roofline(
    n: int,
    k: int,
    width: int,
    height: int,
    config: RasterizeConfig,
    sh_order: int,
    phases_ms: dict,
) -> dict:
    """The bytes each stage must move and its measured ms against that bound.

    Counts each stage's inputs read once and outputs written once at the
    pair budget ``k``; ``pct_of_bound`` is the bytes' time at
    ``HBM_BYTES_PER_S`` over the measured time.  This models what the port
    runs, and so differs from the JAX package's model:

    - the card's 3.35 TB/s, not a TPU's rate;
    - ``bin_prepare`` is the per-splat pass and K2 (:func:`binning_bytes`),
      the scan of the run bounds, the sort as a library's radix passes
      over the 64-bit keys and their int64 indices (``SORT_KEY_BITS``; the
      port's own sort moves fewer bytes), and the gather of the fields;
    - no ``schedule`` stage: K1 reads the tile starts itself;
    - ``kernel_untile`` is K1 (the fields in, the tile buffer out) and the
      untile; K1 is bound by instruction issue, not bytes, so its bytes
      bound is far under its time.
    """
    sh_floats = {0: 0, 1: 9, 2: 24, 3: 45}[sh_order]
    splat_in = (3 + 4 + 3 + 1 + 3 + sh_floats) * 4  # means, rotations, scales, opacity, base color, sh
    proj_out = (1 + 2 + 2 + 2 + 3 + 3 + 1) * 4 + 1  # ProjectedSplats: 14 float32 and the valid byte
    binning = binning_bytes(n, k)
    tiles_x, tiles_y = tile_grid(width, height, config)
    tile_bytes = (tiles_x * tiles_y + 1) * 4 * config.tile_h * config.tile_w * 4
    passes = math.ceil(SORT_KEY_BITS / SORT_BITS_PER_PASS)
    fields = k * NUM_FIELDS * 4
    modeled = {
        "project": n * (splat_in + proj_out),
        "bin_prepare": binning["per_splat_pass"] + binning["k2"]
        + 2 * n * 4  # scan of the run bounds
        + passes * 2 * k * (8 + 8)  # sort
        + k * 8 + 2 * fields,  # gather by the permutation
        "kernel_untile": fields + tile_bytes + tile_bytes + height * width * 4 * 4,
    }
    out = {}
    for name, nbytes in modeled.items():
        ms = phases_ms.get(name)
        if ms is None:
            continue
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "ms": ms,
            "modeled_gb": nbytes / 1e9,
            "achieved_gbps": nbytes / 1e9 / (ms / 1e3) if ms > 0 else None,
            "hbm_bound_ms": bound_ms,
            "pct_of_bound": 100.0 * bound_ms / ms if ms > 0 else None,
        }
    if "bin_prepare" in out:
        out["bin_prepare"]["bound"] = f"sort: {passes} radix passes over int64 keys + int64 indices"
    if "kernel_untile" in out:
        out["kernel_untile"]["bound"] = "K1: instruction issue (pair x pixel evaluations)"
    return out


def render_phases(
    gaussians,
    camera,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    reps: int = 3,
    device=None,
) -> dict:
    """Time each stage of the forward frame as its own call.

    Stages: ``decode`` (a ``DeviceAsset`` only), ``project``,
    ``bin_prepare`` (the per-splat pass, the scan, K2 and the sort, on the
    frame's route: the gather of the per-slot fields only under center
    packing), ``kernel_untile`` (K1 and the untile), and their sum
    ``total_unfused``.  The JAX package's ``schedule`` stage has no
    counterpart: K1 reads the tile starts directly.  Each stage is the mean
    of ``reps`` calls after two untimed ones: CUDA events on a card, the host
    clock on the CPU (``"timer"`` says which).  Runs on ``device`` (CUDA
    unless told otherwise).

    Returns ``{"phases_ms", "timer", "num_pairs", "num_real_pairs",
    "pair_budget", "overflow", "roofline"}``; ``roofline`` is
    :func:`phase_roofline`'s on a card and None on the CPU, whose times say
    nothing of the card's.
    """
    dev = resolve_device(device)
    camera = camera.to(dev)
    w, h = camera.width, camera.height
    phases: dict[str, float] = {}
    with torch.no_grad():
        if hasattr(gaussians, "pos_q"):  # DeviceAsset: time its decode
            from ..io.device_asset import decode_device

            da = gaussians.to(dev)
            phases["decode"], g = _time_call(
                lambda: decode_device(da, planar_sh=config.decode_planar_sh, device=dev), dev, reps)
        else:
            g = gaussians.to(dev)
        phases["project"], proj = _time_call(lambda: project_splats(g, camera, settings), dev, reps)
        records = per_splat_fields(config)
        phases["bin_prepare"], (binning, fields, num_real) = _time_call(
            lambda: bin_and_prepare(proj, w, h, config, records), dev, reps)
        pair_rank = binning.pair_rank if records else None
        phases["kernel_untile"], _ = _time_call(
            lambda: untile(composite_tiles(fields, binning.tile_starts, w, h, config, pair_rank=pair_rank)[0], w, h,
                           config), dev, reps)
    phases["total_unfused"] = sum(phases.values())
    budget = pair_budget(g.num_splats, config)
    num_pairs = int(binning.num_pairs)
    cuda = dev.type == "cuda"
    return {
        "phases_ms": phases,
        "timer": "cuda_events" if cuda else "host_clock",
        "num_pairs": num_pairs,
        "num_real_pairs": int(num_real),
        "pair_budget": budget,
        "overflow": num_pairs > budget,
        "roofline": phase_roofline(g.num_splats, budget, w, h, config, settings.sh_order, phases) if cuda else None,
    }
