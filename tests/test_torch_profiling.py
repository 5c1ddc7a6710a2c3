"""The port's phase timing, frame traces and quality probe against the JAX
package's, on the CPU, and the default device of this slice's entry points.

- ``render_phases``: the pair counts, budget and overflow equal the JAX
  package's ``render_phases`` on the same scene; the port reports its own
  stages (no ``schedule``: K1 reads the tile starts itself), timed by the
  host clock on the CPU, with no roofline (a CPU time says nothing of the
  card's).
- ``phase_roofline`` and ``binning_bytes``: the port's stage bytes, and the
  per-splat pass's and K2's bytes equal to the tensors they read and write.
- ``trace_frame``: the four ``record_function`` ranges of the frame appear.
- ``rgba8_clip_fraction``: equal to the JAX package's, exactly.
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.editing import EditState  # noqa: E402
from unitygaussiansplatting_torch.io.device_asset import encode_device  # noqa: E402
from unitygaussiansplatting_torch.models import debug_render as tdr  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.models.viewer import ViewerSession  # noqa: E402
from unitygaussiansplatting_torch.ops.binning import pair_budget  # noqa: E402
from unitygaussiansplatting_torch.ops.pair_expand import NUM_FIELDS, TABLE_ROWS, expand_pairs, prepare_table  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import project_splats  # noqa: E402
from unitygaussiansplatting_torch.utils import profiling as tprof  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.quality import rgba8_clip_fraction  # noqa: E402
from unitygaussiansplatting_torch.validate import validate_render  # noqa: E402
from unitygaussiansplatting_tpu.utils import profiling as jprof  # noqa: E402
from unitygaussiansplatting_tpu.utils import quality as jqual  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

STAGES = ["project", "bin_prepare", "kernel_untile", "total_unfused"]


def test_render_phases_match_jax_counts():
    raw = tp.jax_scene(n=400, seed=1)
    jcam, tcam = tp.cameras(128, 64)
    want = jprof.render_phases(raw.activate(), jcam, JaxRenderSettings(sh_order=1), reps=1)
    got = tprof.render_phases(tp.port_scene(raw).activate(), tcam, RenderSettings(sh_order=1), reps=1, device="cpu")
    for key in ("num_pairs", "num_real_pairs", "pair_budget", "overflow"):
        assert got[key] == want[key], key
    assert list(got["phases_ms"]) == STAGES and "schedule" not in got["phases_ms"]
    assert got["timer"] == "host_clock" and got["roofline"] is None
    stages = got["phases_ms"]
    assert all(v > 0 for v in stages.values())
    assert stages["total_unfused"] == pytest.approx(sum(stages[k] for k in STAGES[:-1]))


def test_render_phases_times_the_decode_of_a_device_asset():
    g = tp.port_scene(tp.jax_scene(n=300, seed=2)).activate()
    _, tcam = tp.cameras(128, 64)
    got = tprof.render_phases(encode_device(g, device="cpu"), tcam, reps=1, device="cpu")
    assert list(got["phases_ms"]) == ["decode", *STAGES]
    assert got["phases_ms"]["decode"] > 0 and not got["overflow"]


def test_phase_roofline_counts_the_port_stages():
    cfg = RasterizeConfig()
    n, k, w, h = 1000, 4096, 128, 64
    out = tprof.phase_roofline(n, k, w, h, cfg, 3, {"project": 1.0, "bin_prepare": 2.0, "kernel_untile": 4.0})
    assert set(out) == {"project", "bin_prepare", "kernel_untile"}
    # project: the splat (14 + 45 SH floats) in, ProjectedSplats (14 floats + the valid byte) out.
    assert out["project"]["modeled_gb"] == pytest.approx(n * (59 * 4 + 57) / 1e9)
    # The per-splat pass (view fields in; table, n + 1 bounds and the count out),
    # the scan, and K2's reads of the table and the bounds.
    per_splat = n * (11 * 4 + 1) + 2 * (n * TABLE_ROWS * 4 + (n + 1) * 4) + 4 + 2 * n * 4
    per_slot = k * 8 + k * NUM_FIELDS * 4 + 8 * 2 * k * 16 + k * 8 + 2 * k * NUM_FIELDS * 4
    assert out["bin_prepare"]["modeled_gb"] == pytest.approx((per_splat + per_slot) / 1e9)
    tiles = math.ceil(w / cfg.tile_w) * math.ceil(h / cfg.tile_h)
    k1 = k * NUM_FIELDS * 4 + 2 * (tiles + 1) * 4 * cfg.tile_h * cfg.tile_w * 4 + h * w * 16
    assert out["kernel_untile"]["modeled_gb"] == pytest.approx(k1 / 1e9)
    for name, row in out.items():
        assert row["hbm_bound_ms"] == pytest.approx(row["modeled_gb"] * 1e9 / tprof.HBM_BYTES_PER_S * 1e3)
        assert row["pct_of_bound"] == pytest.approx(100 * row["hbm_bound_ms"] / row["ms"])
    assert "radix" in out["bin_prepare"]["bound"] and "issue" in out["kernel_untile"]["bound"]


def test_binning_bytes_match_the_pass_and_k2_tensors():
    g = tp.port_scene(tp.jax_scene(n=300, seed=5)).activate()
    _, tcam = tp.cameras(128, 64)
    cfg = RasterizeConfig()
    proj = project_splats(g, tcam, RenderSettings(sh_order=1))
    table, bounds, num_real = prepare_table(proj, 128, 64, cfg)
    k = pair_budget(g.num_splats, cfg)
    comp, fields = expand_pairs(table, bounds, k, 128, 64, cfg)
    nbytes = tprof.binning_bytes(g.num_splats, k)
    view = (proj.center, proj.axis1, proj.axis2, proj.color, proj.opacity, proj.depth, proj.valid)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    assert nbytes["per_splat_pass"] == size(*view, table, bounds, num_real)
    assert nbytes["k2"] == size(table, bounds, comp, fields)


def test_trace_frame_shows_the_named_ranges(tmp_path):
    g = tp.port_scene(tp.jax_scene(n=200, seed=3)).activate()
    _, tcam = tp.cameras(128, 64)
    asset = encode_device(g, device="cpu")
    (img, _), path = tprof.trace_frame(lambda: trd.render_with_stats(asset, tcam, device="cpu"),
                                       logdir=str(tmp_path))
    assert img.shape == (64, 128, 4)
    names = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
    assert {"splat_decode", "splat_project", "splat_bin", "splat_rasterize_cuda"} <= names


@pytest.mark.parametrize("brightness", [1.0, 3.0])
def test_rgba8_clip_fraction_equals_jax(brightness):
    jg = tp.jax_scene(n=600, seed=4).activate()
    jg = dataclasses.replace(jg, base_color=jg.base_color * brightness)
    tg = tp.port_cloud(jg)
    jcam, tcam = tp.cameras()
    want = jqual.rgba8_clip_fraction(jg, jcam, JaxRenderSettings(sh_order=3))
    got = rgba8_clip_fraction(tg, tcam, RenderSettings(sh_order=3), device="cpu")
    assert got == want
    assert (got["clipped_high"] > 0) == (brightness > 1)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    # This slice's entry points run on the card unless the caller asks for
    # the CPU; with no GPU they raise instead of continuing on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tp.port_scene(tp.jax_scene(n=16, seed=0)).activate()
    _, cam = tp.cameras(64, 32)
    calls = [
        lambda: ViewerSession(g, cam).frame(),
        lambda: trd.render_multi([g], cam),
        lambda: trd.GaussianSplatRenderer(g).render_frame(cam),
        lambda: tdr.render_debug_points(g, cam),
        lambda: tdr.render_debug_boxes(g, cam),
        lambda: tdr.render_debug_chunk_bounds(g, cam),
        lambda: validate_render(g, cam, "unused.png"),
        lambda: rgba8_clip_fraction(g, cam),
        lambda: tprof.render_phases(g, cam),
        lambda: EditState.empty(16),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
