"""Benchmark: forward(+backward) render throughput on the headline-class scene.

The port of the JAX package's ``bench.py``: its headline and its six extras,
measured on the card, at its defaults and under its environment knobs.

    python -m unitygaussiansplatting_torch.bench [--device cpu] [--out-json PATH]

The headline is the reference's bicycle-class scene: 6.1M splats at
1200x797, SH3, the reference doing 6.8 ms/frame forward on an RTX 3080 Ti
(readme.md:79-84).  The scene is synthetic with the same splat count,
resolution and SH order.  Default mode ``fwd_bwd``: one frame is the image
and ``torch.autograd.grad`` of its mean w.r.t. every field of the activated
cloud (``bench.py:533-540``).  ``vs_baseline`` is 6.8 / our ms (the
reference has no backward).  Frames are timed by CUDA events around the
loop; the full record also keeps the host clock to a synchronize.

Extras, in the JAX bench's order, each gated on the time left before the
deadline by the JAX bench's cost estimate: ``fwd_headline``,
``phases_headline`` (``render_phases``, pair counts, the bytes roofline and
the rgba8 clip probe), ``outdoor_scene``, ``viewer_amortization``,
``device_asset`` and ``imported_scene`` (PLY -> ``create_asset`` ->
``DeviceAsset`` -> frame).

Output.  One JSON line on stdout, printed the moment the headline exists and
again after each extra, so the last line is always the most complete; it
stays within :data:`LINE_MAX_BYTES`.  The full record (the JAX bench's keys,
each extra's seconds and peak device memory, tracebacks) is written to
``--out-json`` each time.  Progress goes to stderr.

Exit codes: 0 when the headline and every extra that ran succeeded (an extra
skipped for the deadline is listed in ``skipped`` and is not a failure); 1
when an extra failed (listed in ``errors``; the others still run); 3 when
the watchdog (``BENCH_WATCHDOG_S`` after start) or SIGTERM/SIGINT cut the
run, after printing the partial line with ``truncated``.  The watchdog and
the signal handlers exist only while :func:`main` runs.

Where this differs from the JAX bench: it runs on CUDA unless ``--device
cpu`` is given, and raises without a card (no CPU fallback line, no
``BENCH_ALLOW_CPU``); a failed extra makes the exit code 1 instead of
hiding in ``skipped``; the last line is compact (the JAX line grew to
~3.5 KB, past the 2 KB its reader takes); it signals no other process and
opens no connection (the JAX bench's relay, re-exec and compile-cache knobs
have no function on the card).  Backend names map ``"pallas"`` -> ``"cuda"``
and ``"jax"`` -> ``"torch"``.
"""

from __future__ import annotations

import _thread
import argparse
import contextlib
import dataclasses
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import torch

from .examples._common import Stopwatch
from .io.asset import encode_asset
from .io.bridge import gaussians_to_input_splats
from .io.creator import create_asset
from .io.device_asset import device_asset_from_asset
from .io.ply import write_ply
from .models.camera import Camera
from .models.gaussians import Gaussians
from .models.renderer import render
from .models.viewer import ViewerSession
from .utils.config import RasterizeConfig, RenderSettings
from .utils.device import card_name_power, resolve_device
from .utils.profiling import render_phases
from .utils.quality import rgba8_clip_fraction
from .utils.synthetic import captured_scene, outdoor_scene, sphere_scene, sphere_scene_device

REFERENCE_MS = 6.8  # readme.md:84, RTX 3080 Ti, forward only
LINE_MAX_BYTES = 2048
OUT_JSON = Path(__file__).resolve().parents[1] / "build" / "bench" / "bench.json"
FIELDS = ("means", "rotations", "scales", "opacities", "base_color", "sh")
# The JAX bench's environment knobs at its defaults (bench.py:56-57,
# :464-525, :633-638, :760, :777), read as it reads them.
ENV_DEFAULTS = {
    "BENCH_N": 6_100_000,
    "BENCH_W": 1200,
    "BENCH_H": 797,
    "BENCH_FRAMES": 8,
    "BENCH_BACKEND": "pallas",
    "BENCH_MODE": "fwd_bwd",
    "BENCH_SKIP_EXTRAS": "0",
    "BENCH_HOST_SCENE": None,
    "BENCH_PAIR_MULT": 4.0,
    "BENCH_CHUNK": 256,
    "BENCH_PACK_CENTER": "1",
    "BENCH_RGBA8": "1",
    "BENCH_REAL_PAIR_MULT": 2.5,
    "BENCH_IMPORT_N": 2_000_000,
    "BENCH_IMPORT_PAIR_MULT": 3.0,
    "BENCH_DEADLINE_S": 900,
    "BENCH_WATCHDOG_S": 1080,
}
# The JAX package's backend names -> the port's.
PORT_BACKENDS = {"pallas": "cuda", "jax": "torch"}
# The extras in the JAX bench's order, with its cost estimates in seconds.
EXTRA_ESTIMATES = {
    "fwd_headline": 60,
    "phases_headline": 90,
    "outdoor_scene": 150,
    "viewer_amortization": 45,
    "device_asset": 150,
    "imported_scene": 240,
}
ERROR_CHARS = 120  # of an error's text in the compact line; the record keeps it whole


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One run's sizes and switches: the JAX bench's knobs, parsed."""

    n: int
    width: int
    height: int
    frames: int
    backend: str
    mode: str
    skip_extras: bool
    host_scene: bool
    pair_mult: float
    chunk: int
    pack_center: bool
    rgba8: bool
    real_pair_mult: float
    import_n: int
    import_pair_mult: float
    deadline_s: float
    watchdog_s: float

    @classmethod
    def from_env(cls, env=None) -> "BenchConfig":
        """The knobs from ``env`` (``os.environ`` when None), each absent one
        at the JAX bench's default."""
        env = os.environ if env is None else env

        def get(name):
            return env.get(name, ENV_DEFAULTS[name])

        backend = get("BENCH_BACKEND")
        mode = get("BENCH_MODE")
        if mode not in ("fwd", "fwd_bwd"):
            raise ValueError(f"BENCH_MODE must be fwd or fwd_bwd, not {mode!r}")
        return cls(
            n=int(get("BENCH_N")),
            width=int(get("BENCH_W")),
            height=int(get("BENCH_H")),
            frames=int(get("BENCH_FRAMES")),
            backend=PORT_BACKENDS.get(backend, backend),
            mode=mode,
            skip_extras=get("BENCH_SKIP_EXTRAS") == "1",
            host_scene=get("BENCH_HOST_SCENE") == "1",
            pair_mult=float(get("BENCH_PAIR_MULT")),
            chunk=int(get("BENCH_CHUNK")),
            pack_center=get("BENCH_PACK_CENTER") == "1",
            rgba8=get("BENCH_RGBA8") == "1",
            real_pair_mult=float(get("BENCH_REAL_PAIR_MULT")),
            import_n=int(get("BENCH_IMPORT_N")),
            import_pair_mult=float(get("BENCH_IMPORT_PAIR_MULT")),
            deadline_s=float(get("BENCH_DEADLINE_S")),
            watchdog_s=float(get("BENCH_WATCHDOG_S")),
        )


# --- the scenes, cameras and configs of bench.py ---------------------------


def headline_scene(n: int, host_scene: bool, device) -> Gaussians:
    """The activated sphere scene, seed 0: drawn on ``device``, or with
    ``host_scene`` the host ``sphere_scene`` (the JAX package's bits)."""
    with torch.no_grad():
        if host_scene:
            return sphere_scene(n=n, seed=0).to(device).activate()
        return sphere_scene_device(n=n, seed=0, device=device).activate()


def headline_camera(width: int, height: int) -> Camera:
    # bench.py:492-499
    return Camera.look_at([0.0, 0.6, -3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 47.0, width, height)


def outdoor_camera(width: int, height: int) -> Camera:
    # bench.py:625-632
    return Camera.look_at([0.0, 0.4, -5.0], [0.0, -0.2, 0.0], [0.0, 1.0, 0.0], 47.0, width, height)


def import_camera(width: int, height: int) -> Camera:
    # bench.py:768-775
    return Camera.look_at([6.5, 2.2, -8.0], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0], 47.0, width, height)


def headline_config(cfg: BenchConfig) -> RasterizeConfig:
    # bench.py:511-525: ~3.85 slots a splat demanded, 4.0 holds the opacity sweep.
    return RasterizeConfig(pair_multiplier=cfg.pair_mult, chunk_size=cfg.chunk, pack_axes_u32=True,
                           pack_grads_bf16=True, pack_center_u32=cfg.pack_center, pack_color_rgba8=cfg.rgba8)


def scene_config(cfg: BenchConfig, pair_multiplier: float) -> RasterizeConfig:
    """The outdoor and the imported scene's config (bench.py:633-638,
    :776-781): the headline's without its center and color packs."""
    return RasterizeConfig(pair_multiplier=pair_multiplier, chunk_size=cfg.chunk, pack_axes_u32=True,
                           pack_grads_bf16=True)


def make_frames(camera: Camera, config: RasterizeConfig, backend: str, device):
    """``(frame, frame_bwd)`` as the JAX bench's ``make_fns``: ``frame(g, s)``
    is the image at opacity scale ``s`` (``g`` a cloud or a ``DeviceAsset``);
    ``frame_bwd(g, s)`` the gradients of its mean w.r.t. every field of the
    cloud ``g``."""

    def settings(s):
        return RenderSettings(sh_order=3, opacity_scale=s)

    def frame(g, s):
        with torch.no_grad():
            return render(g, camera, settings(s), config, backend, device=device)

    def frame_bwd(g, s):
        leaves = Gaussians(**{f: getattr(g, f).detach().requires_grad_(True) for f in FIELDS})
        img = render(leaves, camera, settings(s), config, backend, device=device)
        return torch.autograd.grad(img.mean(), [getattr(leaves, f) for f in FIELDS])

    return frame, frame_bwd


def time_frames(fn, scene, frames: int, device: torch.device) -> dict:
    """One warm call, then ``frames`` calls at opacity scales ``1 + 0.001 i``
    (no call can reuse another's result): ``ms`` a frame by CUDA events
    around the loop on a card (the host clock on the CPU), ``host_ms`` a
    frame by the host clock to a synchronize."""
    out = fn(scene, 1.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    watch = Stopwatch(device)
    t0 = time.perf_counter()
    watch.start()
    for i in range(frames):
        out = fn(scene, 1.0 + 0.001 * i)
    ms = watch.stop() / frames
    return dict(ms=ms, host_ms=(time.perf_counter() - t0) * 1e3 / frames)


def pair_record(prof: dict) -> dict:
    return dict(num_pairs=prof["num_pairs"], budget=prof["pair_budget"], overflow=prof["overflow"])


# --- the run ---------------------------------------------------------------


class Truncated(BaseException):
    """Raised in the main thread by the watchdog or a signal: the run stops
    where it is.  A ``BaseException``, so that an extra's failure handler
    does not take it for the extra's own error."""


class Bench:
    """One run: its settings, the compact line's fields and the full record,
    grown as the run goes, and their output.  Every change to them and every
    output holds ``lock``: the watchdog thread prints them too."""

    def __init__(self, cfg: BenchConfig, device: torch.device, out_json: Path):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.out_json = Path(out_json)
        self.t0 = time.time()
        self.card = torch.cuda.get_device_name(self.dev) if self.cuda else "cpu"
        self.result: dict = {}  # the headline's keys, in the line and the record
        self.extras: dict = {}  # each extra's headline numbers, in the line
        self.record: dict = {"config": dataclasses.asdict(cfg), "extra_metrics": [], "extras_run": {}}
        self.skipped: list = []
        self.errors: list = []
        self.lock = threading.RLock()
        self.armed = False

    def elapsed(self) -> float:
        return time.time() - self.t0

    def remaining(self) -> float:
        return self.cfg.deadline_s - self.elapsed()

    def log(self, msg: str) -> None:
        print(f"bench: {msg}", file=sys.stderr, flush=True)

    def line(self, truncated: str | None = None) -> dict:
        """The compact result: the headline, each extra's numbers, what was
        skipped or failed, and where the full record is."""
        line = dict(self.result) if self.result else {
            "metric": f"{'fwd+bwd' if self.cfg.mode == 'fwd_bwd' else 'fwd'} ms/frame (no headline)",
            "value": None, "unit": "ms", "vs_baseline": 0.0}
        line.update(extras=self.extras, skipped=[s["extra"] for s in self.skipped],
                    errors=[f"{e['extra']}: {e['error']}"[:ERROR_CHARS] for e in self.errors],
                    record=str(self.out_json))
        if "total_bench_s" in self.record:
            line["total_bench_s"] = self.record["total_bench_s"]
        if truncated:
            line["truncated"] = truncated[:ERROR_CHARS]
        if len(json.dumps(line).encode()) > LINE_MAX_BYTES:  # the record has every number
            line["extras"] = {}
        return line

    def emit(self, truncated: str | None = None, **record) -> None:
        """Add ``record``'s keys to the full record, write it, then print the
        compact line (one write)."""
        with self.lock:
            self.record.update(record)
            line = self.line(truncated)
            full = dict(self.record, **self.result, skipped=self.skipped, errors=self.errors)
            if truncated:
                full["truncated"] = truncated
            self.out_json.parent.mkdir(parents=True, exist_ok=True)
            self.out_json.write_text(json.dumps(full, indent=1))
            print(json.dumps(line), flush=True)

    def peak_reset(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_bytes(self) -> int | None:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else None

    def run_extra(self, name: str, fn) -> None:
        """One extra: skipped when the time left cannot cover its estimate; a
        failure is recorded in ``errors`` and the run goes on.  ``fn()``
        returns ``(numbers for the line, keys for the record)``; a record key
        ``extra_metric`` is appended to ``extra_metrics``."""
        est, rem = EXTRA_ESTIMATES[name], self.remaining()
        if rem < est:
            self.log(f"skipping extra '{name}' (needs ~{est:.0f}s, {rem:.0f}s left)")
            with self.lock:
                self.skipped.append(dict(extra=name, est_s=est, remaining_s=round(rem, 1)))
            self.emit()
            return
        self.log(f"extra '{name}' (est {est:.0f}s, {rem:.0f}s left)")
        self.peak_reset()
        t0 = time.perf_counter()
        numbers, record = None, {}
        try:
            numbers, record = fn()
        except Exception as e:
            self.log(f"extra '{name}' failed: {e!r}")
            with self.lock:
                self.errors.append(dict(extra=name, error=repr(e), traceback=traceback.format_exc()))
        finally:
            if self.cuda:
                torch.cuda.synchronize(self.dev)
                torch.cuda.empty_cache()
        run = dict(seconds=round(time.perf_counter() - t0, 3), peak_memory_bytes=self.peak_bytes())
        with self.lock:
            if numbers is not None:
                self.extras[name] = numbers
            if "extra_metric" in record:
                self.record["extra_metrics"].append(record.pop("extra_metric"))
            self.record["extras_run"][name] = run
        self.emit(**record)


def run(bench: Bench) -> None:
    """The headline, then the extras: grows ``bench`` and prints its line
    after each part."""
    cfg, dev = bench.cfg, bench.dev
    w, h, frames = cfg.width, cfg.height, cfg.frames
    mode = "fwd+bwd" if cfg.mode == "fwd_bwd" else "fwd"

    bench.peak_reset()
    scene = headline_scene(cfg.n, cfg.host_scene, dev)
    bench.log(f"scene ready at t+{bench.elapsed():.0f}s")
    camera = headline_camera(w, h)
    config = headline_config(cfg)
    frame, frame_bwd = make_frames(camera, config, cfg.backend, dev)
    bench.log(f"headline measurement starting at t+{bench.elapsed():.0f}s")
    head = time_frames(frame_bwd if cfg.mode == "fwd_bwd" else frame, scene, frames, dev)
    ms = head["ms"]
    peak = bench.peak_bytes()
    device = card_name_power() if bench.cuda else "cpu"
    with bench.lock:
        bench.result.update(
            metric=f"{mode} ms/frame, synthetic bicycle-class {cfg.n} splats @{w}x{h} SH3 "
                   f"({cfg.backend} backend, {bench.card})",
            value=round(ms, 3),
            unit="ms",
            vs_baseline=round(REFERENCE_MS / ms, 4),
            headline_done_at_s=round(bench.elapsed(), 1),
            device=device,
        )
    bench.emit(headline=dict(head, frames=frames, peak_memory_bytes=peak))  # safe the moment it exists
    if not cfg.skip_extras:
        run_extras(bench, scene, camera, config, frame)
    bench.emit(total_bench_s=round(bench.elapsed(), 1))


def run_extras(bench: Bench, scene, camera, config, frame) -> None:
    """The six extras of the JAX bench, in its order, on the headline's
    scene, camera, config and forward frame."""
    cfg, dev, backend = bench.cfg, bench.dev, bench.cfg.backend
    w, h, frames = cfg.width, cfg.height, cfg.frames
    mode = "fwd+bwd" if cfg.mode == "fwd_bwd" else "fwd"
    settings = RenderSettings(sh_order=3)

    def fwd_headline():
        fwd = time_frames(frame, scene, frames, dev)["ms"]
        return dict(ms=round(fwd, 3)), dict(extra_metric=dict(
            metric="fwd ms/frame, same headline scene", value=round(fwd, 3), unit="ms",
            vs_baseline=round(REFERENCE_MS / fwd, 4)))

    def phases_headline():
        prof = render_phases(scene, camera, settings, config, device=dev)
        numbers = dict(total_unfused_ms=round(prof["phases_ms"]["total_unfused"], 3), overflow=prof["overflow"])
        record = dict(phases=prof["phases_ms"], pairs=pair_record(prof), roofline=prof["roofline"])
        if config.pack_color_rgba8:  # the knob's validity on this scene, bench.py:604-619
            clip = rgba8_clip_fraction(scene, camera, settings, device=dev)
            record["rgba8_clip"] = {k: (round(float(v), 8) if v == v else None) for k, v in clip.items()}
            numbers["clipped_high"] = record["rgba8_clip"]["clipped_high"]
        return numbers, record

    def outdoor():
        with torch.no_grad():
            real = outdoor_scene(n=cfg.n, seed=1).to(dev).activate()
        real_cam, real_cfg = outdoor_camera(w, h), scene_config(cfg, cfg.real_pair_mult)
        rf, rfb = make_frames(real_cam, real_cfg, backend, dev)
        real_ms = time_frames(rfb if cfg.mode == "fwd_bwd" else rf, real, max(2, frames // 2), dev)["ms"]
        rprof = render_phases(real, real_cam, settings, real_cfg, device=dev)
        return dict(ms=round(real_ms, 3), overflow=rprof["overflow"]), dict(
            extra_metric=dict(metric=f"{mode} ms/frame, outdoor-statistics scene {cfg.n} splats @{w}x{h} SH3",
                              value=round(real_ms, 3), unit="ms", vs_baseline=round(REFERENCE_MS / real_ms, 4)),
            phases_outdoor=rprof["phases_ms"], pairs_outdoor=pair_record(rprof))

    def viewer():
        # Exact reuse of an idle camera's frame (models/viewer.py): moving
        # frames render, idle ones are cache hits that touch no kernel.
        sess = ViewerSession(scene, camera, settings, config, backend=backend, device=dev)
        base = camera.view.to(dev)

        def moved(dx):
            view = base.clone()
            view[0, 3] += dx
            return view

        with torch.no_grad():
            sess.frame()
            sess.frame(view=moved(1e-5))
            watch = Stopwatch(dev).start()
            for i in range(4):
                sess.frame(view=moved(1e-4 * (i + 1)))
            moving_ms = watch.stop() / 4
            sess.frame()
            if bench.cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(50):
                sess.frame()
            idle_ms = (time.perf_counter() - t0) / 50 * 1e3
        return dict(moving_ms=round(moving_ms, 3), idle_ms=round(idle_ms, 4)), dict(viewer_amortization=dict(
            moving_camera_ms_per_frame=round(moving_ms, 3), idle_camera_ms_per_frame=round(idle_ms, 4),
            frames_rendered=sess.stats.rendered, frames_reused=sess.stats.reused))

    def device_asset():
        # The headline cloud from Medium quantized blobs decoded every frame
        # (the reference's 1.3 GB-VRAM story, readme.md:83-84).
        asset = encode_asset(gaussians_to_input_splats(scene))
        da = device_asset_from_asset(asset, device=dev)
        del asset
        da_ms = time_frames(frame, da, max(2, frames // 2), dev)["ms"]
        float_bytes = sum(getattr(scene, f).numel() * 4 for f in FIELDS)
        ratio = round(float_bytes / da.device_bytes(), 2)
        return dict(ms=round(da_ms, 3), device_bytes=da.device_bytes(), compression=ratio), dict(device_asset=dict(
            fwd_ms_from_compressed=round(da_ms, 3), device_bytes=da.device_bytes(), float_bytes=int(float_bytes),
            compression_on_device=ratio))

    def imported():
        # A capture-like scene through the whole import: PLY bytes on disk ->
        # creator (Morton order, chunks, Medium quantization) -> DeviceAsset.
        n_imp = cfg.import_n
        with torch.no_grad():
            cap = gaussians_to_input_splats(captured_scene(n=n_imp, seed=3).to(dev).activate())
        bench.out_json.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=bench.out_json.parent) as td:
            ply_path = os.path.join(td, "captured.ply")
            write_ply(ply_path, cap)
            del cap
            imp_asset = create_asset(ply_path, quality="medium", import_cameras=False, device=dev)
        imp_da = device_asset_from_asset(imp_asset, device=dev)
        imp_cam, imp_cfg = import_camera(w, h), scene_config(cfg, cfg.import_pair_mult)
        imp_frame, _ = make_frames(imp_cam, imp_cfg, backend, dev)
        imp_ms = time_frames(imp_frame, imp_da, max(2, frames // 2), dev)["ms"]
        iprof = render_phases(imp_da, imp_cam, settings, imp_cfg, device=dev)
        numbers = dict(ms=round(imp_ms, 3), asset_bytes=imp_asset.total_bytes(), overflow=iprof["overflow"])
        return numbers, dict(imported_scene=dict(
            metric=f"fwd ms/frame, imported capture-like scene {n_imp} splats @{w}x{h} SH3, Medium asset via "
                   "PLY->creator->DeviceAsset",
            value=round(imp_ms, 3), unit="ms", vs_baseline=round(REFERENCE_MS / imp_ms, 4),
            asset_bytes=imp_asset.total_bytes(), pairs=pair_record(iprof)))

    if cfg.mode == "fwd_bwd":
        bench.run_extra("fwd_headline", fwd_headline)
    bench.run_extra("phases_headline", phases_headline)
    bench.run_extra("outdoor_scene", outdoor)
    bench.run_extra("viewer_amortization", viewer)
    bench.run_extra("device_asset", device_asset)
    bench.run_extra("imported_scene", imported)


@contextlib.contextmanager
def armed(bench: Bench):
    """Within the block SIGTERM, SIGINT and the watchdog (``watchdog_s``
    after the run's start) raise :class:`Truncated` in the main thread; the
    watchdog first prints the partial line itself, in case the main thread
    is held in a call that does not return.  Both are undone on leaving:
    no thread outlives the block and the previous handlers are back."""
    reason = []

    def on_signal(signum, frame):
        if bench.armed:
            raise Truncated(reason[0] if reason else f"terminated by signal {signum}")

    def fire():
        with bench.lock:
            if not bench.armed:
                return
            reason.append(f"bench watchdog fired at {bench.cfg.watchdog_s:g}s")
            bench.emit(truncated=reason[0])
        _thread.interrupt_main(signal.SIGINT)

    previous = {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    timer = threading.Timer(max(bench.cfg.watchdog_s - bench.elapsed(), 0.0), fire)
    timer.name, timer.daemon = "bench-watchdog", True
    bench.armed = True
    timer.start()
    try:
        yield
    finally:
        with bench.lock:
            bench.armed = False
        timer.cancel()
        timer.join()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if reason:  # the watchdog fired as the run ended: its line was printed last
        raise Truncated(reason[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="device to run on (default: cuda; raises without a GPU unless given 'cpu')")
    p.add_argument("--out-json", default=str(OUT_JSON), help="where the full record goes")
    args = p.parse_args(argv)
    cfg = BenchConfig.from_env()
    dev = resolve_device(args.device)
    bench = Bench(cfg, dev, Path(args.out_json))
    try:
        with armed(bench):
            run(bench)
    except Truncated as stop:
        bench.emit(truncated=str(stop))
        return 3
    return 1 if bench.errors else 0


if __name__ == "__main__":
    sys.exit(main())
