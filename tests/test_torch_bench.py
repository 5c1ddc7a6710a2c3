"""The port's benchmark program (``unitygaussiansplatting_torch.bench``) vs
the JAX package, on the CPU at a small size.

The JAX side is built from the JAX package's functions the way the root
``bench.py`` builds them (its scene, cameras, configs, ``render`` with the
Pallas kernels in interpret mode, ``jax.grad``, ``render_phases``,
``rgba8_clip_fraction``, the asset codecs and the creator); the root
``bench.py`` itself is only parsed, never imported (importing it arms a
watchdog and stops processes).  The port's side is one in-process run of
``bench.main`` with ``--device cpu`` and small ``BENCH_*`` sizes, and the
bench's own frame functions.  Bars: the headline image at
tests/test_torch_render.py's headline-config bars, its gradients at
tests/test_torch_backward.py's ``"headline"`` bars, pair counts and byte
counts exactly, the rgba8 clip fractions to 1e-6.
"""

import ast
import contextlib
import io
import json
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_backward import E2E_TOL, assert_grads_close  # noqa: E402
from test_torch_render import E2E_ATOL, E2E_FRACTION, E2E_MAX  # noqa: E402
from unitygaussiansplatting_torch import bench  # noqa: E402
from unitygaussiansplatting_tpu.io import asset as jas  # noqa: E402
from unitygaussiansplatting_tpu.io import bridge as jbr  # noqa: E402
from unitygaussiansplatting_tpu.io import creator as jcr  # noqa: E402
from unitygaussiansplatting_tpu.io import device_asset as jda  # noqa: E402
from unitygaussiansplatting_tpu.io import ply as jply  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.utils import profiling as jprof  # noqa: E402
from unitygaussiansplatting_tpu.utils import quality as jqual  # noqa: E402
from unitygaussiansplatting_tpu.utils import synthetic as jsyn  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RasterizeConfig as JaxConfig  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxSettings  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL_ENV = dict(BENCH_N="1500", BENCH_W="192", BENCH_H="128", BENCH_FRAMES="2", BENCH_IMPORT_N="2000",
                 BENCH_HOST_SCENE="1")
# The full record's keys that the JAX bench's result carries.
JAX_KEYS = ("phases", "pairs", "roofline", "rgba8_clip", "extra_metrics", "phases_outdoor", "pairs_outdoor",
            "viewer_amortization", "device_asset", "imported_scene")
# Knobs of the JAX bench with no function on the card: the CPU run (the
# port's --device cpu), the relay wait and init hang, the compile cache.
DROPPED_KNOBS = {"BENCH_ALLOW_CPU", "BENCH_INIT_WAIT_S", "BENCH_INIT_HANG_S", "BENCH_JAX_CACHE"}
JAX_SETTINGS = JaxSettings(sh_order=3)
CLIP_ATOL = 1e-6


def run_main(monkeypatch, tmp_path, argv=("--device", "cpu"), **env):
    """``bench.main`` in this process with the small sizes (and ``env`` on
    top): ``(rc, stdout lines, record)``."""
    for k, v in dict(SMALL_ENV, **env).items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "bench.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([*argv, "--out-json", str(out)])
    return rc, buf.getvalue().splitlines(), json.loads(out.read_text())


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        rc, lines, record = run_main(mp, tmp_path_factory.mktemp("bench"))
    return dict(rc=rc, lines=lines, record=record, cfg=bench.BenchConfig.from_env(SMALL_ENV))


def jax_camera(eye, target, cfg):
    return JaxCamera.look_at(eye=eye, target=target, up=[0.0, 1.0, 0.0], fov_y_deg=47.0, width=cfg.width,
                             height=cfg.height)


def jax_config(pair_multiplier, cfg, **packs):
    return JaxConfig(pair_multiplier=pair_multiplier, chunk_size=cfg.chunk, pack_axes_u32=True, pack_grads_bf16=True,
                     **packs)


@pytest.fixture(scope="module")
def jax_headline():
    # bench.py:483-525 with BENCH_HOST_SCENE=1.
    cfg = bench.BenchConfig.from_env(SMALL_ENV)
    g = jsyn.sphere_scene(n=cfg.n, seed=0).activate()
    cam = jax_camera([0.0, 0.6, -3.0], [0.0, 0.0, 0.0], cfg)
    jcfg = jax_config(cfg.pair_mult, cfg, pack_center_u32=cfg.pack_center, pack_color_rgba8=cfg.rgba8)
    return g, cam, jcfg


@pytest.fixture(scope="module")
def jax_imported(tmp_path_factory):
    # bench.py:760-808: captured_scene -> PLY -> create_asset(medium) -> DeviceAsset.
    cfg = bench.BenchConfig.from_env(SMALL_ENV)
    splats = jbr.gaussians_to_input_splats(jsyn.captured_scene(n=cfg.import_n, seed=3).activate())
    ply = str(tmp_path_factory.mktemp("jax_import") / "captured.ply")
    jply.write_ply(ply, splats)
    asset = jcr.create_asset(ply, quality="medium", import_cameras=False)
    prof = jprof.render_phases(jda.device_asset_from_asset(asset), jax_camera([6.5, 2.2, -8.0], [0.0, 0.3, 0.0], cfg),
                               JAX_SETTINGS, jax_config(cfg.import_pair_mult, cfg), reps=1)
    return asset.total_bytes(), prof


def jax_pairs(prof):
    return dict(num_pairs=prof["num_pairs"], budget=prof["pair_budget"], overflow=bool(prof["overflow"]))


# --- one run end to end -----------------------------------------------------


def test_main_end_to_end_on_the_cpu(small_run):
    assert small_run["rc"] == 0
    last = small_run["lines"][-1]
    assert len(last.encode()) <= bench.LINE_MAX_BYTES
    line = json.loads(last)
    assert {"metric", "value", "unit", "vs_baseline", "headline_done_at_s", "device", "total_bench_s"} <= set(line)
    assert line["unit"] == "ms" and line["value"] > 0 and line["device"] == "cpu"
    assert line["skipped"] == [] and line["errors"] == []
    assert list(line["extras"]) == list(bench.EXTRA_ESTIMATES)
    # The headline line came first, and every later line is at most as long.
    first = json.loads(small_run["lines"][0])
    assert first["value"] == line["value"] and first["extras"] == {}
    record = small_run["record"]
    assert set(JAX_KEYS) <= set(record)
    assert record["value"] == line["value"] and record["errors"] == []
    assert list(record["extras_run"]) == list(bench.EXTRA_ESTIMATES)
    assert record["viewer_amortization"]["frames_reused"] == 50
    assert record["viewer_amortization"]["frames_rendered"] == 7
    assert [m["metric"].split(",")[0] for m in record["extra_metrics"]] == ["fwd ms/frame", "fwd+bwd ms/frame"]
    assert not any(t.name == "bench-watchdog" for t in threading.enumerate())


# --- parity with the JAX package ---------------------------------------------


def test_headline_frame_matches_jax(small_run, jax_headline):
    cfg = small_run["cfg"]
    g, cam, jcfg = jax_headline
    want = np.asarray(jrd.render(g, cam, JaxSettings(sh_order=3, opacity_scale=1.0), jcfg, backend="pallas"))
    frame, _ = bench.make_frames(bench.headline_camera(cfg.width, cfg.height), bench.headline_config(cfg),
                                 cfg.backend, torch.device("cpu"))
    got = frame(bench.headline_scene(cfg.n, cfg.host_scene, "cpu"), 1.0).numpy()
    d = np.abs(got.astype(np.float64) - want)
    assert d.max() <= E2E_MAX, d.max()
    assert np.mean(d <= E2E_ATOL) >= E2E_FRACTION["headline"], np.mean(d <= E2E_ATOL)


def test_headline_gradients_match_jax(small_run, jax_headline):
    # bench.py:533-540: jax.grad of the image's mean w.r.t. the whole cloud.
    cfg = small_run["cfg"]
    g, cam, jcfg = jax_headline
    grads = jax.grad(lambda gg: jnp.mean(jrd.render(gg, cam, JAX_SETTINGS, jcfg, backend="pallas")))(g)
    want = {f: np.asarray(getattr(grads, f)) for f in bench.FIELDS}
    _, frame_bwd = bench.make_frames(bench.headline_camera(cfg.width, cfg.height), bench.headline_config(cfg),
                                     cfg.backend, torch.device("cpu"))
    got = frame_bwd(bench.headline_scene(cfg.n, cfg.host_scene, "cpu"), 1.0)
    assert_grads_close(dict(zip(bench.FIELDS, (t.numpy() for t in got))), want, E2E_TOL["headline"])


@pytest.mark.parametrize("scene", ["headline", "outdoor", "imported"])
def test_pair_counts_match_jax(small_run, jax_headline, jax_imported, scene):
    cfg, record = small_run["cfg"], small_run["record"]
    if scene == "headline":
        g, cam, jcfg = jax_headline
        got, want = record["pairs"], jax_pairs(jprof.render_phases(g, cam, JAX_SETTINGS, jcfg, reps=1))
    elif scene == "outdoor":
        # bench.py:625-667
        real = jsyn.outdoor_scene(n=cfg.n, seed=1).activate()
        cam = jax_camera([0.0, 0.4, -5.0], [0.0, -0.2, 0.0], cfg)
        got = record["pairs_outdoor"]
        want = jax_pairs(jprof.render_phases(real, cam, JAX_SETTINGS, jax_config(cfg.real_pair_mult, cfg), reps=1))
    else:
        got, want = record["imported_scene"]["pairs"], jax_pairs(jax_imported[1])
    assert got == want
    assert not got["overflow"]


def test_rgba8_clip_matches_jax(small_run, jax_headline):
    g, cam, _ = jax_headline
    want = jqual.rgba8_clip_fraction(g, cam, JAX_SETTINGS)
    got = small_run["record"]["rgba8_clip"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= CLIP_ATOL, (k, got[k], v)


@pytest.mark.parametrize("what", ["device_asset", "imported"])
def test_byte_counts_match_jax(small_run, jax_headline, jax_imported, what):
    record = small_run["record"]
    if what == "device_asset":
        # bench.py:714-742
        g = jax_headline[0]
        da = jda.device_asset_from_asset(jas.encode_asset(jbr.gaussians_to_input_splats(g)))
        float_bytes = sum(np.prod(getattr(g, f).shape) * 4 for f in bench.FIELDS)
        got = record["device_asset"]
        assert (got["device_bytes"], got["float_bytes"]) == (da.device_bytes(), int(float_bytes))
        assert got["compression_on_device"] == round(float_bytes / da.device_bytes(), 2)
    else:
        assert record["imported_scene"]["asset_bytes"] == jax_imported[0]


# --- the knobs ----------------------------------------------------------------


def jax_bench_knobs() -> dict:
    """Every ``os.environ.get("BENCH_...", default)`` of the root bench.py:
    name -> default (None when it has none), parsed, not imported."""
    knobs = {}
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "get"
                and ast.unparse(node.func.value) == "os.environ" and isinstance(node.args[0], ast.Constant)
                and node.args[0].value.startswith("BENCH_")):
            default = None if len(node.args) < 2 else (
                ast.literal_eval(node.args[1]) if isinstance(node.args[1], ast.Constant) else ast.unparse(node.args[1]))
            assert knobs.setdefault(node.args[0].value, default) == default, node.args[0].value
    return knobs


def test_knobs_keep_the_jax_defaults():
    knobs = jax_bench_knobs()
    assert DROPPED_KNOBS <= set(knobs)
    kept = {k: v for k, v in knobs.items() if k not in DROPPED_KNOBS}
    assert bench.ENV_DEFAULTS == kept
    cfg = bench.BenchConfig.from_env({})
    assert (cfg.n, cfg.width, cfg.height, cfg.frames, cfg.mode) == (6_100_000, 1200, 797, 8, "fwd_bwd")
    assert (cfg.pair_mult, cfg.chunk, cfg.real_pair_mult, cfg.import_n, cfg.import_pair_mult) == (
        4.0, 256, 2.5, 2_000_000, 3.0)
    assert cfg.pack_center and cfg.rgba8 and not cfg.skip_extras and not cfg.host_scene
    assert (cfg.deadline_s, cfg.watchdog_s) == (900, 1080)
    assert bench.headline_config(cfg) == bench.RasterizeConfig(
        pair_multiplier=4.0, chunk_size=256, pack_axes_u32=True, pack_grads_bf16=True, pack_center_u32=True,
        pack_color_rgba8=True)


@pytest.mark.parametrize("name,port", [("pallas", "cuda"), ("jax", "torch"), ("cuda", "cuda"), ("torch", "torch")])
def test_backend_names_map_to_the_port(name, port):
    assert bench.BenchConfig.from_env({"BENCH_BACKEND": name}).backend == port
    assert bench.BenchConfig.from_env({}).backend == "cuda"


# --- the JAX bench's faults, not copied ---------------------------------------


def test_a_failed_extra_is_reported_and_exits_1(monkeypatch, tmp_path):
    def broken(*args, **kwargs):
        raise RuntimeError("viewer broke")

    monkeypatch.setattr(bench, "ViewerSession", broken)
    rc, lines, record = run_main(monkeypatch, tmp_path)
    assert rc == 1
    line = json.loads(lines[-1])
    assert line["errors"] == ["viewer_amortization: RuntimeError('viewer broke')"]
    assert [e["extra"] for e in record["errors"]] == ["viewer_amortization"]
    assert "viewer broke" in record["errors"][0]["traceback"]
    # The extras after it still ran.
    assert {"device_asset", "imported_scene"} <= set(line["extras"]) and "viewer_amortization" not in line["extras"]


def test_the_deadline_skips_extras_and_exits_0(monkeypatch, tmp_path):
    rc, lines, record = run_main(monkeypatch, tmp_path, BENCH_DEADLINE_S="0")
    assert rc == 0
    line = json.loads(lines[-1])
    assert line["value"] > 0 and line["errors"] == [] and line["extras"] == {}
    assert line["skipped"] == list(bench.EXTRA_ESTIMATES)
    assert [s["est_s"] for s in record["skipped"]] == list(bench.EXTRA_ESTIMATES.values())
    assert all(s["remaining_s"] <= 0 for s in record["skipped"])


def slow_scene(*args, **kwargs):
    for _ in range(200):  # 10 s unless interrupted
        time.sleep(0.05)
    raise AssertionError("the bench was not interrupted")


@pytest.mark.parametrize("cause", ["watchdog", "sigterm"])
def test_a_cut_run_prints_truncated_and_exits_3(monkeypatch, tmp_path, cause):
    before = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    if cause == "watchdog":
        monkeypatch.setattr(bench, "headline_scene", slow_scene)
        env = dict(BENCH_WATCHDOG_S="0.3")
    else:
        def terminated(*args, **kwargs):
            signal.raise_signal(signal.SIGTERM)
            return slow_scene()

        monkeypatch.setattr(bench, "headline_scene", terminated)
        env = {}
    rc, lines, record = run_main(monkeypatch, tmp_path, **env)
    assert rc == 3
    line = json.loads(lines[-1])
    assert line["value"] is None
    assert line["truncated"] == ("bench watchdog fired at 0.3s" if cause == "watchdog" else "terminated by signal 15")
    assert record["truncated"] == line["truncated"]
    # Nothing of the run is left: no watchdog thread, the handlers restored.
    assert not any(t.name == "bench-watchdog" for t in threading.enumerate())
    assert {sig: signal.getsignal(sig) for sig in before} == before


def test_the_source_kills_scans_and_dials_nothing():
    src = Path(bench.__file__).read_text()
    for word in ("os.kill", "os._exit", "/proc", "socket", "execv"):
        assert word not in src, word
    imported = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "unitygaussiansplatting_tpu", "bench") for m in imported)


def test_main_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
