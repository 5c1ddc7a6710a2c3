"""Demo: fit a splat cloud to a rendered target image (differentiability demo).

    python -m unitygaussiansplatting_torch.examples.train_splats [out_dir] [--device cpu]

The port of ``examples/train_splats.py``: renders a target from a reference
cloud (``sphere_scene(n=2000, seed=0)``, 256x192, SH1, tiles of 64x8 with
64-pair steps), perturbs the cloud with the JAX script's own draws
(``np.random.default_rng(1)``, so the start cloud is the JAX script's bit
for bit), then fits it back with 300 Adam steps through the differentiable
rasterizer and its hand-written backward, and reports the start and fitted
PSNR.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from ..models.camera import Camera
from ..models.gaussians import RawGaussians
from ..models.renderer import render
from ..models.trainer import default_optimizer, make_train_step
from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device
from ..utils.image import psnr
from ..utils.synthetic import sphere_scene
from ._common import Stopwatch, add_device_arg, save_rgb

CONFIG = RasterizeConfig(tile_h=8, chunk_size=64, max_pairs_per_tile=2048)
SETTINGS = RenderSettings(sh_order=1)


def start_cloud(target_raw: RawGaussians) -> RawGaussians:
    """The perturbed start (``examples/train_splats.py:286-291``): the same
    numpy draws and float32 arithmetic as the JAX script, on the CPU."""
    rng = np.random.default_rng(1)
    means, sh0 = target_raw.means.numpy(), target_raw.sh0.numpy()
    return dataclasses.replace(
        target_raw,
        means=torch.from_numpy(means + 0.03 * rng.normal(size=means.shape).astype(np.float32)),
        sh0=torch.from_numpy(sh0 + 0.5 * rng.normal(size=sh0.shape).astype(np.float32)),
    )


def run(out_dir: str | None = None, n: int = 2000, width: int = 256, height: int = 192, steps: int = 300,
        backend: str = "cuda", device=None) -> dict:
    """Fit; returns the losses (host floats), the start and fitted PSNR and
    the step time.  Writes target/start/fitted PNGs to ``out_dir`` if given."""
    dev = resolve_device(device)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    camera = Camera.look_at(eye=[0, 0.5, -3.0], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=width,
                            height=height)

    def image(raw):
        with torch.no_grad():
            return render(raw.activate(), camera, SETTINGS, CONFIG, backend, device=dev)[..., :3]

    target_raw = sphere_scene(n=n, seed=0)
    start = start_cloud(target_raw)
    target = image(target_raw.to(dev))
    img0 = image(start.to(dev))
    start_psnr = psnr(img0.cpu().numpy(), target.cpu().numpy())
    print(f"start PSNR: {start_psnr:.2f} dB")

    opt = default_optimizer(lr_means=2e-3, lr_rest=5e-3)
    step = make_train_step(camera, opt, SETTINGS, CONFIG, backend, ssim_weight=0.2, device=dev)
    raw = start.to(dev)
    opt_state = opt.init(raw)
    losses = []
    watch = Stopwatch(dev).start()
    for i in range(steps):
        loss, raw, opt_state = step(raw, opt_state, target)
        losses.append(loss)
        if i % 50 == 0:
            print(f"step {i}: loss {float(loss):.5f}")
    step_ms = watch.stop() / max(steps, 1)
    losses = torch.stack(losses).tolist() if losses else []
    print(f"{steps} steps in {step_ms * steps / 1e3:.1f}s ({step_ms:.2f} ms/step)")

    img1 = image(raw)
    fitted_psnr = psnr(img1.cpu().numpy(), target.cpu().numpy())
    print(f"fitted PSNR: {fitted_psnr:.2f} dB")
    if out_dir:
        for name, img in (("target", target), ("start", img0), ("fitted", img1)):
            save_rgb(os.path.join(out_dir, f"{name}.png"), img)
    return dict(losses=losses, start_psnr=start_psnr, fitted_psnr=fitted_psnr, step_ms=step_ms, start=start,
                fitted=raw)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir", nargs="?", default=os.path.join(tempfile.gettempdir(), "train_splats"))
    add_device_arg(p)
    args = p.parse_args(argv)
    return run(args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
