"""``splatbench/counts.py``'s frozen copies equal the program's today.

Later divergence is expected and allowed: the program may change its own
bytes model or instruction counts, and this test then fails and is brought
up to date, but ``counts.py`` stays, because it is the yardstick."""

import ast

import pytest

from splatbench import counts
from splatbench.harness import ROOT
from splatbench.reference.render import Work
from unitygaussiansplatting_torch.ops import pair_expand
from unitygaussiansplatting_torch.utils import profiling
from unitygaussiansplatting_torch.utils.config import RasterizeConfig


def _chip_smoke_constants() -> dict:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            if isinstance(node.value, ast.Constant):
                out[node.targets[0].id] = node.value.value
    return out


def test_instruction_counts_equal_chip_smoke():
    c = _chip_smoke_constants()
    for name in ("K1_INSTR_PER_EVAL", "K1_INSTR_PER_KEPT", "K3_INSTR_PER_EVAL", "K3_INSTR_PER_KEPT"):
        assert getattr(counts, name) == c[name], name


@pytest.mark.parametrize("n,k", [(1, 1024), (6_100_000, 13_451_505), (123_457, 500_000)])
def test_bytes_model_equals_the_program(n, k):
    assert counts.binning_bytes(n, k) == profiling.binning_bytes(n, k)
    assert (counts.NUM_FIELDS, counts.TABLE_ROWS) == (pair_expand.NUM_FIELDS, pair_expand.TABLE_ROWS)
    assert counts.HBM_BYTES_PER_S == profiling.HBM_BYTES_PER_S
    assert (counts.SORT_KEY_BITS, counts.SORT_BITS_PER_PASS) == (profiling.SORT_KEY_BITS, profiling.SORT_BITS_PER_PASS)
    cfg = RasterizeConfig()
    w, h = 1200, 797
    ms = {"project": 1.0, "bin_prepare": 1.0, "kernel_untile": 1.0}
    model = profiling.phase_roofline(n, k, w, h, cfg, 3, ms)
    least = counts.frame_least(n, Work(demand=k), w, h, cfg.tile_w, cfg.tile_h, 3)
    assert least["project"] * 1e3 == pytest.approx(model["project"]["hbm_bound_ms"], rel=1e-12)
    assert least["bin"] * 1e3 == pytest.approx(model["bin_prepare"]["hbm_bound_ms"], rel=1e-12)
    assert (least["k1"] + least["untile"]) * 1e3 == pytest.approx(model["kernel_untile"]["hbm_bound_ms"], rel=1e-12)


def test_least_time_is_the_larger_bound():
    work = Work(demand=10, evals=10**12, kept=10**11)
    least = counts.frame_least(10, work, 64, 32, 64, 32, 3)
    assert least["k1"] == pytest.approx((25 * 10**12 + 10 * 10**11) / counts.INSTR_PER_S)
    assert counts.least_s(3.35e12) == pytest.approx(1.0)
