"""Tests of the benchmark: ``python -m pytest splatbench/tests`` from the
repository's root.  They run on the CPU at small sizes; those that need a
card are marked ``cuda`` and skip without one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(4)

# The small cell every CPU run of the harness uses.
SMALL = {"config": {"n_splats": 6000, "width": 192, "height": 128},
         "traffic": {"poses": 8, "step_deg": 45.0, "check_frames": 2, "trace_poses": [0, 1]}}
SMALL_TRAIN = {"config": dict(SMALL["config"]), "traffic": {"poses": 4, "step_deg": 90.0, "trace_poses": [0, 1]}}


def bench_with_pending() -> dict:
    from splatbench import harness

    return harness.load_benchmark(pending=True)


def small(workload: str) -> dict:
    return SMALL_TRAIN if workload == "bicycle-train" else SMALL


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
