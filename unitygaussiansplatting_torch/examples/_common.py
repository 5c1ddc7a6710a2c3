"""What the example programs share: the ring of training cameras, a device
timer, PNG output, the ``--device`` flag and the kernels' build note."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.camera import Camera
from ..ops import cuda_build
from ..utils.image import save_png


def ring_cameras(k, radius, width, height, height_off=0.6, fov=45.0, target=(0.0, 0.0, 0.0), phase=0.0):
    """``k`` cameras on a horizontal ring around ``target``, camera ``i`` at
    the angle ``2 pi (i + phase) / k`` (``examples/train_full.py:31-41``)."""
    cams = []
    for i in range(k):
        a = 2 * np.pi * (i + phase) / k
        eye = [radius * np.sin(a), height_off, -radius * np.cos(a)]
        cams.append(Camera.look_at(eye, list(target), [0, 1, 0], fov, width, height))
    return cams


class Stopwatch:
    """Elapsed milliseconds of the work queued between :meth:`start` and
    :meth:`stop`: by CUDA events on a CUDA device (the host returns before
    the card finishes, so a host clock there times the enqueue), by the host
    clock on the CPU.  :meth:`stop` waits for the stop event."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> "Stopwatch":
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self._t0) * 1e3
        t1 = torch.cuda.Event(enable_timing=True)
        t1.record()
        t1.synchronize()
        return self._t0.elapsed_time(t1)


def save_rgb(path: str, img: torch.Tensor) -> None:
    """Write an (H, W, >=3) linear image's RGB, clipped to [0, 1], as a PNG."""
    save_png(path, np.clip(img[..., :3].detach().cpu().numpy(), 0, 1))


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda; raises without a GPU unless given 'cpu')")


def missing_libraries() -> set[str]:
    """The kernel sources whose library is not yet in ``build/cuda/``."""
    return {s for s in cuda_build.SOURCES if not cuda_build.library_path(s).exists()}


def build_note(device: torch.device, missing_before: set[str]) -> str:
    """What a first call did about the kernels' libraries, given
    :func:`missing_libraries` from before it."""
    if device.type != "cuda":
        return "plain PyTorch versions of the kernels on the CPU, nothing to build"
    built = sorted(missing_before - missing_libraries())
    if built:
        return f"incl. the nvcc build of {len(built)} kernel libraries ({', '.join(built)})"
    return "the kernel libraries were already built in build/cuda/"
