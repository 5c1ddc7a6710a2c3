"""The controls of the comparison that decides ``correct``: the reference put
in the program's place and computed one precision lower (bfloat16 for the
configurations' float32), and, for a train cell, a planted fault (the loss
taken over half of the image's rows, the mean over the rest).  Each must
read over the cell's limits.  The benchmark's runs never run this.

    python3 splatbench/control.py --workload <name> --seeds 1,2,3 [--fault bf16|half_batch]

Prints one JSON line a seed with the numbers the cell compares, read at the
cell's own size and views, beside the limits.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from splatbench import harness, poses, scenes  # noqa: E402
from splatbench.drivers import train as train_driver  # noqa: E402
from splatbench.reference import asset as ref_asset  # noqa: E402
from splatbench.reference import render as ref  # noqa: E402
from splatbench.reference import train as ref_train  # noqa: E402


def view_numbers(config: dict, traffic: dict, seed: int, device, fault: str) -> dict:
    """``img_max_err`` of the control's frames against the reference's, at
    the poses a run of this seed checks."""
    import random

    if fault != "bf16":
        raise SystemExit(f"a view cell has no fault {fault!r}")
    ras = ref.Raster.from_config(config)
    views = poses.ring(traffic)
    sample = sorted(random.Random(seed).sample(range(len(views)), traffic["check_frames"]))
    raw = scenes.outdoor_scene(config["n_splats"], seed, device)
    g = ref.activate(raw)
    del raw
    if config["storage"] == "medium":
        g = ref_asset.decode(ref_asset.encode(g))
    low = {k: v.to(torch.bfloat16) for k, v in g.items()}
    err = 0.0
    for pose in sample:
        want = ref.render(g, views[pose], ras)
        got = ref.render(low, views[pose], ras)
        err = max(err, float((got.float() - want).abs().max()))
    return {"img_max_err": err}


def train_steps(config: dict, traffic: dict, seed: int, device, dtype, half_batch: bool) -> tuple:
    """The reference's first steps from the seed: losses, first gradients'
    norms and the changes' norms, a leaf each."""
    ras = ref.Raster.from_config(config)
    views = poses.ring(traffic)
    raw = scenes.outdoor_scene(config["n_splats"], seed, device)
    targets = scenes.targets(traffic["poses"], config["width"], config["height"], seed, device)
    order = poses.pass_order(traffic, seed)
    extent = train_driver.scene_extent(views)
    params = {k: v.to(dtype, copy=True) for k, v in raw.items()}
    adam = ref_train.Adam(params, eps=traffic["optimizer"]["eps"])
    loss_fn = ref_train.loss_fn
    if half_batch:
        h = config["height"] // 2
        ref_train.loss_fn = lambda rgba, target, bg, w: loss_fn(rgba[:h], target[:h], bg, w)
    try:
        losses, grads0 = [], {}
        for i in range(traffic["checked_steps"]):
            view = order[i]
            loss, grads = ref_train.frame_gradients(params, views[view], targets[view].to(dtype), ras,
                                                    traffic["background"], traffic["ssim_weight"])
            losses.append(float(loss))
            if i == 0:
                grads0 = train_driver._norms(grads)
            adam.step(params, grads, train_driver.learning_rates(traffic, extent, traffic["start_iteration"] + i))
    finally:
        ref_train.loss_fn = loss_fn
    return losses, grads0, train_driver._norms({k: params[k].double() - raw[k].double() for k in params})


def train_numbers(config: dict, traffic: dict, seed: int, device, fault: str) -> dict:
    want = train_steps(config, traffic, seed, device, torch.float32, False)
    dtype = torch.bfloat16 if fault == "bf16" else torch.float32
    got = train_steps(config, traffic, seed, device, dtype, fault == "half_batch")
    median = statistics.median(want[1].values())
    counted = [k for k in want[1] if want[1][k] >= 1e-3 * median]
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0])),
        "grad_norm_gap": train_driver.gap(got[1], want[1], counted),
        "change_norm_gap": train_driver.gap(got[2], want[2], counted),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default="bf16", choices=("bf16", "half_batch"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("splatbench control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, config, traffic = harness.resolve(harness.load_benchmark(pending=True), args.workload)
    numbers = train_numbers if traffic["driver"] == "train" else view_numbers
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        got = numbers(config, traffic, seed, torch.device("cuda"), args.fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed, "numbers": got,
                          "limits": traffic["limits"], "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
