"""Full 3DGS training loop: multi-view fit, adaptive density control, checkpoints.

The port of ``unitygaussiansplatting_tpu/models/training_loop.py``: the
trainer's Adam steps (``models/trainer.py``) round-robin over the views,
clone/split/prune and opacity resets (``models/densify.py``, Kerbl et al.
§5.2) every few steps with the Adam state carried across each topology
change, the pair budget grown when a frame overflows it, and checkpoints.

The cloud is padded to a capacity that grows in steps (``pad_to_capacity``),
as in the JAX package.  Steps run eagerly, so nothing is recompiled when the
capacity or the budget changes.  Losses, pair counts and the densification
statistics stay on the device; the host reads them at the budget-check
cadence, at a densify boundary and at the end, never every step.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..ops.binning import pair_budget
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.convert import RAW_FIELDS
from ..utils.device import resolve_device
from .camera import Camera
from .densify import densify, pad_to_capacity, prune, reset_opacity
from .gaussians import RawGaussians
from .renderer import render, render_with_stats, suggest_pair_multiplier
from .trainer import GroupAdam, default_optimizer, photometric_loss


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 400
    ssim_weight: float = 0.2
    # Density control (3DGS §5.2 schedule shape).
    densify_every: int = 100
    densify_from: int = 50
    densify_until: int = 10**9
    grad_threshold: float = 2e-4
    scale_threshold: float = 0.01
    prune_opacity: float = 0.005
    opacity_reset_every: int = 0  # 0 = off (3DGS uses 3000)
    capacity_step: int = 1024  # capacity rounds up to this granularity
    capacity_headroom: float = 1.3
    # Checkpointing.
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0  # 0 = only final
    # Pair-budget auto-sizing: the worst view's slot demand / N x this slack
    # becomes config.pair_multiplier at set-up (0 = keep config as it is).
    auto_budget_slack: float = 0.0
    # Held-out evaluation every eval_every steps (and at step 0 and the end):
    # eval_fn(raw, step) is appended to history["evals"].  0 = off.
    eval_every: int = 0
    # Overflow recovery: frames whose slot demand exceeds the pair budget are
    # found every budget_check_every steps and at densify boundaries, and the
    # budget grows to the worst demand x budget_grow_slack ("budget_grow"
    # events in history).  0 disables.
    budget_check_every: int = 25
    budget_grow_slack: float = 1.2


def _capacity_for(n: int, cfg: TrainLoopConfig) -> int:
    want = int(n * cfg.capacity_headroom)
    return max(-(-want // cfg.capacity_step) * cfg.capacity_step, cfg.capacity_step)


@torch.no_grad()
def _remap_opt_state(
    opt_state: torch.optim.Adam,
    src_idx: torch.Tensor,
    is_new: torch.Tensor,
    raw: RawGaussians,
    optimizer: GroupAdam,
) -> torch.optim.Adam:
    """Carry Adam state across a densify/prune/pad topology change.

    Returns ``optimizer``'s Adam over the new cloud ``raw``: each parameter's
    ``exp_avg`` and ``exp_avg_sq`` gathered by ``src_idx`` (the old row each
    new row derives from) and zero where ``is_new`` (clones, split children,
    padding), as the official trainer's ``cat_tensors_to_optimizer`` does.
    Each parameter's ``step`` and each group's update ``count`` are kept:
    resetting the count restarted the means-lr schedule after every densify.
    """
    new = optimizer.init(raw, like=opt_state)
    fresh = is_new.to(src_idx.device)
    for old_group, group in zip(opt_state.param_groups, new.param_groups):
        for old_p, p in zip(old_group["params"], group["params"]):
            state = opt_state.state.get(old_p)
            if not state:
                continue
            carried = {}
            for key, value in state.items():
                if key in ("exp_avg", "exp_avg_sq"):
                    taken = value.index_select(0, src_idx)
                    taken[fresh] = 0
                    carried[key] = taken
                else:  # step
                    carried[key] = value.clone()
            new.state[p] = carried
    return new


def _make_step(optimizer: GroupAdam, settings, config, backend, ssim_weight, width, height, device=None):
    """One Adam step that also accumulates the densification statistic.

    The official statistic is the norm of the loss gradient w.r.t. the
    screen-space splat centers, summed over the views where the splat is
    visible (non-empty tile rect).  A zero (N, 2) probe added to the
    projected centers has exactly that gradient; it is scaled by (W/2, H/2)
    to the NDC units of the published ``grad_threshold=2e-4``.

    Returns ``step(raw, opt_state, gacc, vis_count, camera, target) ->
    (loss, raw, opt_state, gacc, vis_count, num_pairs)``; ``raw`` is
    updated in place, ``gacc`` and ``vis_count`` too, and nothing is read
    back to the host.
    """
    dev = resolve_device(device)
    ndc_scale = torch.tensor([width * 0.5, height * 0.5], dtype=torch.float32, device=dev)

    def step(raw, opt_state, gacc, vis_count, camera, target):
        probe = torch.zeros((raw.num_splats, 2), dtype=torch.float32, device=dev, requires_grad=True)
        rt, stats = render_with_stats(raw.activate(), camera, settings, config, backend, center_probe=probe,
                                      want_visibility=True, device=dev)
        loss = photometric_loss(rt[..., :3], target, ssim_weight)  # black background
        opt_state.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.update(opt_state)
        with torch.no_grad():
            g = probe.grad * ndc_scale
            gacc += torch.sqrt(torch.sum(g * g, dim=-1))
            vis_count += stats.visible.to(torch.int32)
        return loss.detach(), raw, opt_state, gacc, vis_count, stats.num_pairs

    return step


def save_checkpoint(path: str, raw: RawGaussians, step: int) -> None:
    """One ``torch.save`` file: the raw cloud's fields as CPU tensors and the step."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {f: getattr(raw, f).detach().cpu() for f in RAW_FIELDS}
    payload["__step__"] = int(step)
    torch.save(payload, path)


def load_checkpoint(path: str, device=None) -> tuple[RawGaussians, int]:
    """``(raw, step)`` from :func:`save_checkpoint`'s file, the cloud on
    ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    step = int(payload.pop("__step__"))
    return RawGaussians(**{f: payload[f].to(dev) for f in RAW_FIELDS}), step


def train(
    raw: RawGaussians,
    cameras: list[Camera],
    targets: list,
    loop: TrainLoopConfig = TrainLoopConfig(),
    settings: RenderSettings = RenderSettings(sh_order=1),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    optimizer: GroupAdam | None = None,
    eval_fn=None,
    device=None,
) -> tuple[RawGaussians, dict]:
    """Run the full loop on ``device`` (CUDA unless told otherwise); returns
    ``(trained raw, history)``.

    Trains a copy of ``raw``; the caller's cloud is not touched.  The
    returned cloud is padded to its capacity.  ``history``: ``"losses"``
    (floats), ``"counts"`` [(step, live splats)], ``"events"`` [(step,
    kind, detail)] and, with ``loop.eval_every > 0``, ``"evals"`` [(step,
    eval_fn(raw, step))].  Targets are (H, W, 3) linear RGB, one per camera;
    views round-robin.
    """
    dev = resolve_device(device)
    cameras = [c.to(dev) for c in cameras]
    targets = [torch.as_tensor(t, dtype=torch.float32, device=dev) for t in targets]
    raw = RawGaussians(**{f: getattr(raw, f).detach().to(dev).clone() for f in RAW_FIELDS})
    if loop.auto_budget_slack > 0:
        mult, _ = suggest_pair_multiplier(raw.activate(), cameras, settings, config, slack=loop.auto_budget_slack,
                                          device=dev)
        # Never shrink below the caller's configured floor.
        config = dataclasses.replace(config, pair_multiplier=max(mult, config.pair_multiplier))
    opt = optimizer or default_optimizer()

    def make_step(cfg):
        return _make_step(opt, settings, cfg, backend, loop.ssim_weight, cameras[0].width, cameras[0].height, dev)

    step_fn = make_step(config)

    n_live = raw.num_splats
    capacity = _capacity_for(n_live, loop)
    raw = pad_to_capacity(raw, capacity)
    opt_state = opt.init(raw)
    # The screen-space positional-gradient statistic over the densify window
    # (sum of grad norms / per-splat visibility count), on the device.
    gacc = torch.zeros(capacity, dtype=torch.float32, device=dev)
    vis_count = torch.zeros(capacity, dtype=torch.int32, device=dev)

    history = {"losses": [], "counts": [(0, n_live)], "events": []}
    if loop.eval_every > 0 and eval_fn is not None:
        history["evals"] = [(0, eval_fn(raw, 0))]

    # Per-step slot demands, kept on the device until the check cadence.
    pending_pairs: list[tuple[int, torch.Tensor]] = []

    def check_budget(i: int) -> bool:
        """Grow the pair budget if any pending frame overflowed it."""
        nonlocal pending_pairs, step_fn, config
        if not pending_pairs:
            return False
        demands = list(zip((s for s, _ in pending_pairs),
                           torch.stack([p.reshape(()) for _, p in pending_pairs]).tolist()))
        pending_pairs = []
        n = raw.num_splats
        budget = pair_budget(n, config)
        worst_step, worst = max(demands, key=lambda sp: sp[1])
        if worst <= budget:
            return False
        new_mult = max(worst * loop.budget_grow_slack / max(n, 1), config.pair_multiplier * 1.25)
        config = dataclasses.replace(config, pair_multiplier=new_mult)
        step_fn = make_step(config)
        history["events"].append(
            (i + 1, "budget_grow", {
                "worst_step": worst_step, "demand": worst, "old_budget": budget,
                "new_multiplier": round(new_mult, 4),
            })
        )
        return True

    for i in range(loop.steps):
        v = i % len(cameras)
        loss, raw, opt_state, gacc, vis_count, num_pairs = step_fn(
            raw, opt_state, gacc, vis_count, cameras[v], targets[v]
        )
        history["losses"].append(loss)
        if loop.budget_check_every > 0:
            pending_pairs.append((i, num_pairs))
            if len(pending_pairs) >= loop.budget_check_every:
                check_budget(i)

        do_densify = (
            loop.densify_every > 0
            and loop.densify_from <= i < loop.densify_until
            and (i + 1) % loop.densify_every == 0
        )
        if do_densify:
            if loop.budget_check_every > 0:
                check_budget(i)
            opt_state.zero_grad(set_to_none=True)  # the last step's gradients: not needed across the change
            # On the padded cloud: padding rows have zero statistics (never
            # cloned) and ~0 opacity (pruned away).
            mean_grad = gacc.double() / torch.clamp(vis_count, min=1).double()
            new, src_idx, is_new = densify(
                raw, mean_grad, grad_threshold=loop.grad_threshold, scale_threshold=loop.scale_threshold,
                seed=i, return_map=True,
            )
            new, kept = prune(new, min_opacity=loop.prune_opacity, return_map=True)
            src_idx, is_new = src_idx[kept], is_new[kept]
            n_live = new.num_splats
            capacity = _capacity_for(n_live, loop)
            raw = pad_to_capacity(new, capacity)
            # Padding rows are new (zero moments).
            pad = capacity - n_live
            src_idx = torch.cat([src_idx, torch.zeros(pad, dtype=src_idx.dtype, device=dev)])
            is_new = torch.cat([is_new, torch.ones(pad, dtype=torch.bool, device=dev)])
            opt_state = _remap_opt_state(opt_state, src_idx, is_new, raw, opt)
            gacc = torch.zeros(capacity, dtype=torch.float32, device=dev)
            vis_count = torch.zeros(capacity, dtype=torch.int32, device=dev)
            history["counts"].append((i + 1, n_live))
            history["events"].append((i + 1, "densify+prune", n_live))

        if (
            loop.opacity_reset_every
            and (i + 1) % loop.opacity_reset_every == 0
            # Never on the final step: a reset needs steps to re-learn the
            # opacities, and with none left it craters the returned cloud.
            and (i + 1) < loop.steps
        ):
            # In place, so that the optimizer keeps its parameters and state.
            with torch.no_grad():
                raw.opacity_logits.copy_(reset_opacity(raw).opacity_logits)
            history["events"].append((i + 1, "opacity_reset", n_live))

        if (
            loop.eval_every > 0
            and eval_fn is not None
            and ((i + 1) % loop.eval_every == 0 or i + 1 == loop.steps)
        ):
            history["evals"].append((i + 1, eval_fn(raw, i + 1)))

        if loop.checkpoint_dir and loop.checkpoint_every and (i + 1) % loop.checkpoint_every == 0:
            save_checkpoint(os.path.join(loop.checkpoint_dir, f"ckpt_{i + 1:06d}"), raw, i + 1)

    if loop.budget_check_every > 0:
        # Trailing frames: record (and grow, for a caller who goes on with
        # the returned config via history) rather than end truncated.
        check_budget(loop.steps - 1)
    if loop.checkpoint_dir:
        save_checkpoint(os.path.join(loop.checkpoint_dir, "ckpt_final"), raw, loop.steps)
    history["losses"] = torch.stack(history["losses"]).tolist() if history["losses"] else []
    return raw, history


def psnr_of(
    raw: RawGaussians, camera: Camera, target, settings, config, backend: str = "cuda", device=None,
) -> float:
    """PSNR (dB, peak 1) of ``raw``'s render from ``camera`` against
    ``target`` (H, W, 3), on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    with torch.no_grad():
        img = render(raw.to(dev).activate(), camera, settings, config, backend=backend, device=dev)[..., :3]
        mse = float(torch.mean((img - torch.as_tensor(target, dtype=torch.float32, device=dev)) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))
