"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises when no device is given and no GPU is present: the plain PyTorch
    versions of the kernels run only where the caller asks for the CPU.  On
    CUDA, TF32 is switched off for matrix products and convolutions: it keeps
    10 mantissa bits, a multi-pixel error on the pixel-scale transforms.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or CPU "
                "tensors to the kernel wrappers) to run the plain PyTorch "
                "versions of the kernels"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def card_name_power() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first card), e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``: a number timed on
    a card is kept beside both."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
