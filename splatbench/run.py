"""Run one cell of the benchmark once.

    python3 splatbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Measures ``unitygaussiansplatting_torch`` on CUDA cards only: without a
card, or with fewer than the cell asks for, it exits with code 2 and prints
no result.  The last line of standard output is the result as one JSON
object; the numbers compared with the reference, each beside its limit,
are also the last lines of standard error.  See ``splatbench/README.md``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench import harness  # noqa: E402  (after the path is set)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = harness.process_start_s()
    args = parse(argv)
    harness.set_cache_dirs()
    bench = harness.load_benchmark()
    w, _, _ = harness.resolve(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"splatbench: {args.workload} needs {w['chips']} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    print(f"splatbench: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    line, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started,
                                    bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"splatbench: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
