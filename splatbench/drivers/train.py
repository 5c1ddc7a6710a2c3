"""A trainer fitting a captured scene: one client calls the step of the
program's ``models/trainer.make_multicam_train_step`` with
``official_3dgs_optimizer`` for each training view in turn, round-robin as
``models/training_loop.train`` takes views, and waits for it.

The phase is 3DGS's after densification (iterations 15k to 30k): the cloud
keeps its size, the means' learning rate is its decayed value at the
traffic's ``start_iteration``, with the scene extent of 3DGS (the training
cameras' radius about their centre, times 1.1).  Set-up builds the one
train step object with its cloud and optimizer and drives it through the
first ``checked_steps`` steps of the pass; the window goes on from there
with the same objects.  The check: each of those steps' loss, the first
gradient of each raw field as Adam holds it after one step, and each
field's change after the checked steps, against ``reference.train`` run
from the same seed.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys

import numpy as np
import torch

from .. import counts, poses, scenes
from ..reference import render as ref
from ..reference import train as ref_train
from .viewer import pair_multiplier, program_cameras, raster_config

UNIT = "step"
BETA1 = 0.9


def scene_extent(views) -> float:
    """3DGS's ``getNerfppNorm``: the largest distance of a camera centre
    from their mean, times 1.1."""
    centers = np.stack([-v[:3, :3].T @ v[:3, 3] for v in views]).astype(np.float64)
    return float(np.linalg.norm(centers - centers.mean(0), axis=1).max() * 1.1)


def learning_rates(traffic: dict, extent: float, iteration: int) -> dict:
    """Each raw field's learning rate at ``iteration`` (the traffic's
    ``optimizer``: the means' rate decays exponentially from ``means_lr_init``
    to ``means_lr_final`` over ``total_iterations``, both times the extent)."""
    o = traffic["optimizer"]
    lo, hi = o["means_lr_final"] * extent, o["means_lr_init"] * extent
    means = max(hi * (o["means_lr_final"] / o["means_lr_init"]) ** (iteration / traffic["total_iterations"]), lo)
    return dict(o["lr"], means=means)


@dataclasses.dataclass
class State:
    step: object
    raw: object
    opt: object
    cams: list
    targets: torch.Tensor
    order: list
    losses: list
    grad_norms: dict
    change_norms: dict
    moved: dict
    snapshot: dict | None = None


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def setup(ctx) -> State:
    from unitygaussiansplatting_torch.models.gaussians import RawGaussians
    from unitygaussiansplatting_torch.models.trainer import make_multicam_train_step, official_3dgs_optimizer
    from unitygaussiansplatting_torch.utils.config import RenderSettings

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    raw = RawGaussians(**scenes.outdoor_scene(cfg["n_splats"], ctx.seed, dev))
    targets = scenes.targets(tr["poses"], cfg["width"], cfg["height"], ctx.seed, dev)
    views = poses.ring(tr)
    cams = program_cameras(cfg, views)
    ctx.mark("scene and targets")
    with torch.no_grad():
        mult = pair_multiplier(raw.activate(), cams, cfg, dev)
    ctx.mark("pair budget")
    o = tr["optimizer"]
    optimizer = official_3dgs_optimizer(scene_extent=scene_extent(views), total_steps=tr["total_iterations"],
                                        means_lr_init=o["means_lr_init"], means_lr_final=o["means_lr_final"])
    opt = optimizer.init(raw)
    for group in opt.param_groups:
        group["count"] = tr["start_iteration"]
    step = make_multicam_train_step(optimizer, RenderSettings(sh_order=cfg["sh_degree"]), raster_config(cfg, mult),
                                    backend="cuda", ssim_weight=tr["ssim_weight"],
                                    background=torch.tensor(tr["background"], dtype=torch.float32), device=dev)
    fields = ref_train.RAW_FIELDS
    start = {f: getattr(raw, f).detach().clone() for f in fields}
    order = poses.pass_order(tr, ctx.seed)
    losses, grad_norms = [], {}
    for i in range(tr["checked_steps"]):
        loss, raw, opt = step(raw, opt, cams[order[i]], targets[order[i]])
        losses.append(float(loss))
        if i == 0:  # Adam's first moment after one step is (1 - beta1) times the gradient (none: nought)
            moments = {f: opt.state.get(getattr(raw, f), {}).get("exp_avg") for f in fields}
            grad_norms = _norms({f: (torch.zeros(1) if m is None else m) / (1.0 - BETA1) for f, m in moments.items()})
    change_norms = _norms({f: getattr(raw, f).detach() - start[f] for f in fields})
    moved = {f: int((getattr(raw, f).detach() != start[f]).sum()) for f in fields}
    del start
    ctx.mark("checked steps")
    k = tr["checked_steps"]
    return State(step, raw, opt, cams, targets, order[k:] + order[:k], losses, grad_norms, change_norms, moved)


def pass_units(ctx, st: State) -> list:
    return st.order


def run_unit(ctx, st: State, view) -> None:
    st.step(st.raw, st.opt, st.cams[view], st.targets[view])


def trace_units(ctx, st: State) -> list:
    return list(ctx.traffic["trace_poses"])


def before_trace(ctx, st: State) -> None:
    # The cloud the traced steps start from: the reference counts their work on it.
    st.snapshot = {f: getattr(st.raw, f).detach().clone() for f in ref_train.RAW_FIELDS}


def release(ctx, st: State) -> dict:
    out = dict(losses=st.losses, grad_norms=st.grad_norms, change_norms=st.change_norms, moved=st.moved,
               snapshot=st.snapshot)
    st.step = st.raw = st.opt = st.targets = st.snapshot = None
    return out


def gap(program: dict, want: dict, counted: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = statistics.median(want[k] for k in counted)
    return max(abs(program[k] - want[k]) / max(want[k], median) for k in counted)


def reference(ctx, out: dict, traced):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ras = ref.Raster.from_config(cfg)
    views = poses.ring(tr)
    raw = scenes.outdoor_scene(cfg["n_splats"], ctx.seed, dev)
    targets = scenes.targets(tr["poses"], cfg["width"], cfg["height"], ctx.seed, dev)
    order = poses.pass_order(tr, ctx.seed)
    extent = scene_extent(views)
    params = {k: v.clone() for k, v in raw.items()}
    adam = ref_train.Adam(params, eps=tr["optimizer"]["eps"])
    losses, grad_norms = [], {}
    for i in range(tr["checked_steps"]):
        view = order[i]
        loss, grads = ref_train.frame_gradients(params, views[view], targets[view], ras, tr["background"],
                                                tr["ssim_weight"])
        losses.append(float(loss))
        if i == 0:
            grad_norms = _norms(grads)
        adam.step(params, grads, learning_rates(tr, extent, tr["start_iteration"] + i))
        del grads
    change_norms = _norms({k: params[k] - raw[k] for k in params})
    moved = {k: int((params[k] != raw[k]).sum()) for k in params}
    del params, adam, targets
    print(f"losses: program {out['losses']} reference {losses}", file=sys.stderr)
    for k in grad_norms:
        print(f"leaf {k}: grad {out['grad_norms'][k]!r} ref {grad_norms[k]!r}; change {out['change_norms'][k]!r} "
              f"ref {change_norms[k]!r}; moved {out['moved'][k]} ref {moved[k]}", file=sys.stderr)
    # Leaves whose gradient is nought to rounding (under a thousandth of the
    # median leaf's) move under Adam by round-off alone: not compared.
    median = statistics.median(grad_norms.values())
    counted = [k for k in grad_norms if grad_norms[k] >= 1e-3 * median]
    lim = tr["limits"]
    checks = [
        ("loss_rel_gap", max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses)), lim["loss_rel_gap"]),
        ("grad_norm_gap", gap(out["grad_norms"], grad_norms, counted), lim["grad_norm_gap"]),
        ("change_norm_gap", gap(out["change_norms"], change_norms, counted), lim["change_norm_gap"]),
    ]
    least = None
    if traced is not None:
        g = ref.activate(out["snapshot"])
        least = []
        for view in traced:
            work = ref.Work()
            ref.render(g, views[view], ras, work=work)
            least.append(counts.step_least(cfg["n_splats"], work, ras.width, ras.height, ras.tile_w, ras.tile_h,
                                           ras.sh_order))
    return checks, least
