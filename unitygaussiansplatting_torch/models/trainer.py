"""Training: losses and optimization steps for splat clouds.

The port of ``unitygaussiansplatting_tpu/models/trainer.py``: the 3DGS
photometric loss (L1 + D-SSIM, Kerbl et al. 2023) and Adam steps over the raw
(pre-activation) splat parameters.

Optax's functional optimizers become :class:`GroupAdam`: one
``torch.optim.Adam`` parameter group per label of the ``RawGaussians``
fields, as ``optax.multi_transform`` labels them.  ``opt.init(raw)`` returns
the ``torch.optim.Adam`` that plays the role of the optimizer state; its
parameters are ``raw``'s own tensors, which a step updates in place.  Steps
run eagerly; there is nothing to compile.  The port has no ``"jax"``
backend, so steps render with ``backend="cuda"`` by default: the
hand-written kernels on a CUDA device, their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.convert import RAW_FIELDS
from ..utils.device import resolve_device
from .camera import Camera
from .gaussians import RawGaussians
from .renderer import render


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair (3DGS training metric).

    The window is a depthwise 2-D convolution with zero padding, as JAX's
    ``"SAME"``; TF32 is off on CUDA (``utils.device.resolve_device``)."""
    c1, c2 = 0.01**2, 0.03**2
    win = _gaussian_window(window_size, device=a.device)[None, None]  # (1, 1, k, k)

    def filt(x):
        y = F.conv2d(x.permute(2, 0, 1)[:, None], win, padding=window_size // 2)  # (C, 1, H, W)
        return y[:, 0].permute(1, 2, 0)

    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = filt(a * a) - mu_a2
    sig_b = filt(b * b) - mu_b2
    sig_ab = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / ((mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2))
    return torch.mean(s)


def photometric_loss(img: torch.Tensor, target: torch.Tensor, ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - w) * L1 + w * D-SSIM, the 3DGS training loss."""
    l1 = torch.mean(torch.abs(img - target))
    if ssim_weight == 0.0:
        return l1
    dssim = (1.0 - ssim(img, target)) / 2.0
    return (1.0 - ssim_weight) * l1 + ssim_weight * dssim


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float, end_value: float):
    """``optax.exponential_decay`` (no staircase, no delay) as a function of
    the update count, which starts at 0: ``init * rate**(count / steps)``,
    held at ``end_value`` once it gets there."""
    clip = max if decay_rate < 1.0 else min

    def schedule(count: int) -> float:
        if count <= 0:
            return clip(init_value, end_value)
        return clip(init_value * decay_rate ** (count / transition_steps), end_value)

    return schedule


class GroupAdam:
    """Adam with one parameter group per label: the port of
    ``optax.multi_transform`` over ``optax.adam`` transforms.

    ``labels`` maps each ``RawGaussians`` field to a group name; ``lrs``
    maps each group to a learning rate or to a schedule of the update count
    (the count of the first update is 0, as in optax).  Betas are optax's
    and torch's default (0.9, 0.999).
    """

    def __init__(self, labels: dict[str, str], lrs: dict[str, float | Callable[[int], float]], eps: float = 1e-8):
        missing = set(RAW_FIELDS) - set(labels)
        if missing or set(labels.values()) - set(lrs):
            raise ValueError(f"every RawGaussians field needs a group with an lr: {labels}, {lrs}")
        self.labels, self.lrs, self.eps = dict(labels), dict(lrs), eps

    def init(self, raw: RawGaussians, like: torch.optim.Adam | None = None) -> torch.optim.Adam:
        """The optimizer over ``raw``'s tensors (leaves; set to require grad).

        Each group records its ``fields``.  ``like``, an optimizer this
        ``GroupAdam`` made before, hands each group its update count and lr,
        so that a schedule goes on where it was when the cloud's tensors are
        replaced (``models.training_loop`` carries the moments across)."""
        kept = {g["label"]: (g["count"], g["lr"]) for g in like.param_groups} if like is not None else {}
        groups = []
        for name, lr in self.lrs.items():
            fields = [f for f in RAW_FIELDS if self.labels[f] == name]
            count, lr_now = kept.get(name, (0, lr(0) if callable(lr) else lr))
            groups.append(dict(params=[getattr(raw, f).requires_grad_(True) for f in fields], fields=fields,
                               lr=lr_now, label=name, count=count))
        return torch.optim.Adam(groups, eps=self.eps)

    def update(self, opt: torch.optim.Adam) -> None:
        """One Adam update from the parameters' ``.grad``, each scheduled
        group's lr set from its update count first."""
        for group in opt.param_groups:
            lr = self.lrs[group["label"]]
            if callable(lr):
                group["lr"] = lr(group["count"])
            group["count"] += 1
        opt.step()


def make_train_step(
    camera: Camera,
    optimizer: GroupAdam,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    ssim_weight: float = 0.2,
    background: torch.Tensor | None = None,
    device=None,
):
    """An Adam step fitting a cloud to one target image.

    Returns ``step(raw, opt, target) -> (loss, raw, opt)``; ``opt`` is
    ``optimizer.init(raw)``, ``target`` (H, W, 3) linear RGB.  ``raw`` is
    updated in place and returned, so the call reads like the JAX step.
    ``device`` is where the frame renders (CUDA unless told otherwise).
    """
    step = make_multicam_train_step(optimizer, settings, config, backend, ssim_weight, background, device)
    camera = camera.to(resolve_device(device))
    return lambda raw, opt, target: step(raw, opt, camera, target)


def make_multicam_train_step(
    optimizer: GroupAdam,
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    ssim_weight: float = 0.2,
    background: torch.Tensor | None = None,
    device=None,
):
    """Train step taking the camera as an argument (multi-view training).

    Returns ``step(raw, opt, camera, target) -> (loss, raw, opt)``.
    """
    dev = resolve_device(device)
    bg = torch.zeros(3, device=dev) if background is None else torch.as_tensor(background, device=dev)

    def step(raw: RawGaussians, opt: torch.optim.Adam, camera: Camera, target: torch.Tensor):
        rt = render(raw.activate(), camera.to(dev), settings, config, backend, device=dev)
        img = rt[..., :3] + (1.0 - rt[..., 3:4]) * bg
        loss = photometric_loss(img, target.to(dev), ssim_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.update(opt)
        return loss.detach(), raw, opt

    return step


def default_optimizer(lr_means: float = 1.6e-4, lr_rest: float = 2.5e-3) -> GroupAdam:
    """Per-parameter-group Adam like the official 3DGS schedule shape:
    positions learn slowly relative to appearance parameters."""
    labels = {f: "rest" for f in RAW_FIELDS}
    labels["means"] = "means"
    return GroupAdam(labels, {"means": lr_means, "rest": lr_rest})


def official_3dgs_optimizer(
    scene_extent: float = 1.0,
    total_steps: int = 30_000,
    means_lr_init: float = 1.6e-4,
    means_lr_final: float = 1.6e-6,
) -> GroupAdam:
    """The official 3DGS per-parameter Adam recipe (Kerbl et al. §5 /
    released training defaults), in this parameterization:

    - means: lr scaled by scene extent, exponential decay init -> final
      over ``total_steps``, held at the final lr after them,
    - sh0 (DC color): 2.5e-3; higher-order SH: 2.5e-3 / 20,
    - opacity logits: 0.05, log-scales: 5e-3, rotations: 1e-3,
    - Adam eps 1e-15 (the official code's optimizer epsilon).
    """
    means_lr = exponential_decay(
        means_lr_init * scene_extent, max(total_steps, 1), means_lr_final / means_lr_init,
        means_lr_final * scene_extent,
    )
    labels = dict(
        means="means", rotations_wxyz="rotations", log_scales="scales", opacity_logits="opacity",
        sh0="sh0", sh="sh_rest",
    )
    lrs = dict(means=means_lr, rotations=1e-3, scales=5e-3, opacity=5e-2, sh0=2.5e-3, sh_rest=2.5e-3 / 20.0)
    return GroupAdam(labels, lrs, eps=1e-15)


def fit(
    raw: RawGaussians,
    camera: Camera,
    target: torch.Tensor,
    steps: int = 200,
    optimizer: GroupAdam | None = None,
    **kw,
):
    """Convenience loop: fit a cloud to a single target image.

    Trains a copy of ``raw`` on the step's device; returns ``(fitted raw,
    losses)``."""
    opt = optimizer or default_optimizer()
    dev = resolve_device(kw.get("device"))
    raw = RawGaussians(**{f: getattr(raw, f).detach().to(dev).clone() for f in RAW_FIELDS})
    step = make_train_step(camera, opt, **kw)
    opt_state = opt.init(raw)
    losses = []
    for _ in range(steps):
        loss, raw, opt_state = step(raw, opt_state, target)
        losses.append(float(loss))
    return raw, losses
