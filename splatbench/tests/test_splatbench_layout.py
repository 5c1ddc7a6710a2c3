"""``BENCHMARK.json`` and the files it names: every configuration, traffic
mix and per-layer metric resolves by name, a new one added as files alone
is found, and no module imports what it must not."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

from splatbench import harness
from splatbench.harness import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_file_has_its_shape():
    b = harness.load_benchmark()
    assert set(b) == KEYS
    assert b["command"] == ["python3", "splatbench/run.py"] and b["paths"] == ["splatbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in b[part]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_every_file_resolves_by_name():
    b = harness.load_benchmark()
    for w in b["workloads"]:
        _, config, traffic = harness.resolve(b, w["name"])
        assert config["reduced"] == next(c for c in b["configs"] if c["name"] == w["config"])["reduced"]
        assert hasattr(harness.module("drivers", traffic["driver"]), "reference")
    for m in b["per_layer"]:
        spec = harness.load_json(HERE / "metrics" / f"{m['name']}.json")
        assert hasattr(harness.module("readers", spec["reader"]), "read")


def test_new_config_traffic_and_metric_are_files_alone(tmp_path):
    """In a copy of the benchmark, a configuration, a traffic mix and a
    per-layer metric of a known reader kind, added as new files and named
    in BENCHMARK.json, run with no edit of a file that was there."""
    shutil.copytree(HERE, tmp_path / "splatbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = harness.load_benchmark()
    cfg = harness.load_json(HERE / "configs" / "bicycle-6.1M.json")
    cfg.update(n_splats=3000, width=128, height=96)
    (tmp_path / "splatbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = harness.load_json(HERE / "traffic" / "orbit72.json")
    mix.update(poses=4, step_deg=90.0, check_frames=1, trace_poses=[0, 1])
    (tmp_path / "splatbench" / "traffic" / "orbit4.json").write_text(json.dumps(mix))
    (tmp_path / "splatbench" / "metrics" / "k2_ms.view.json").write_text(
        json.dumps({"reader": "range_ms", "args": {"range": "splat_bin"}}))
    b["configs"].append({"name": "tiny", "source": "x", "file": "splatbench/configs/tiny.json", "reduced": [],
                         "why": "x"})
    b["workloads"].append({"name": "tiny.orbit4", "config": "tiny", "traffic": "orbit4", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "k2_ms.view", "unit": "ms", "better": "lower", "source": "device_trace",
                           "layer": "binning", "moves": "frame_ms", "workloads": ["tiny.orbit4"]})
    next(m for m in b["end_to_end"] if m["name"] == "frame_ms")["workloads"].append("tiny.orbit4")
    next(m for m in b["end_to_end"] if m["name"] == "frame_p95_ms")["workloads"].append("tiny.orbit4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    probe = (
        "import json, sys, time; sys.path.insert(0, '.');"
        "from splatbench import harness;"
        "line, _ = harness.run_cell('tiny.orbit4', 9, 0.1, True, 'cpu', time.time(), bench=harness.load_benchmark());"
        "print(json.dumps(line))"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] == 4
    # No device operations on the CPU: the new metric's reader finds nothing and the line leaves it out.
    assert "k2_ms.view" not in line["metrics"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_imports():
    forbidden = {"jax", "jaxlib", "flax", "unitygaussiansplatting_tpu"}
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & forbidden, (path, tops & forbidden)
        if "reference" in path.relative_to(HERE).parts:
            assert "unitygaussiansplatting_torch" not in tops, path


def test_loaded_module_check_compares_whole_top_level_names(monkeypatch):
    for name in ("unitygaussiansplatting_torch.ops", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "unitygaussiansplatting_tpu.ops", sys)
    assert harness.forbidden_modules() == ["jax", "unitygaussiansplatting_tpu"]


def test_run_without_a_card_fails_and_prints_no_result():
    t0 = time.time()
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "bicycle-view", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    assert "CUDA card" in out.stderr and time.time() - t0 < 120
