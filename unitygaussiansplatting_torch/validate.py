"""Golden-image regression validation.

The reference's only automated check, the render validator
(GaussianSplatValidator.cs:27-208): render known scenes with known cameras,
diff against golden images, gate on the count of differing pixels and on
PSNR, dump diff/ref/got images on failure.  The same gates: more than 50
differing pixels or a PSNR under 90 dB fails (GaussianSplatValidator.cs:118).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .models.camera import Camera
from .models.gaussians import Gaussians
from .models.renderer import render_over_background
from .utils.config import RasterizeConfig, RenderSettings
from .utils.image import diff_pixel_count, load_png, psnr, rmse, save_png

# Reference gates (GaussianSplatValidator.cs:118).
MAX_DIFF_PIXELS = 50
MIN_PSNR = 90.0


@dataclasses.dataclass
class ValidationResult:
    name: str
    rmse: float
    psnr: float
    diff_pixels: int
    passed: bool

    def __str__(self):
        status = "OK" if self.passed else "FAIL"
        return (
            f"{status} {self.name}: rmse {self.rmse:.6f} psnr {self.psnr:.2f} dB "
            f"diff pixels {self.diff_pixels}"
        )


def validate_image(
    got: np.ndarray,
    golden: np.ndarray,
    name: str = "scene",
    dump_folder: str | None = None,
    max_diff_pixels: int = MAX_DIFF_PIXELS,
    min_psnr: float = MIN_PSNR,
) -> ValidationResult:
    """Compare a rendered image (numpy) against a golden with the reference's
    gates.

    DiffImagesJob (GaussianSplatValidator.cs:159-208): a pixel differs when
    any channel is off by more than 3/255; the dumped diff image is the
    absolute difference times 4.
    """
    got = np.asarray(got)[..., :3].astype(np.float32)
    golden = np.asarray(golden)[..., :3].astype(np.float32)
    if got.shape != golden.shape:
        raise ValueError(f"size mismatch: got {got.shape} vs golden {golden.shape}")
    result = ValidationResult(
        name=name,
        rmse=rmse(got, golden),
        psnr=psnr(got, golden),
        diff_pixels=diff_pixel_count(got, golden, tol=3.0 / 255.0),
        passed=True,
    )
    result.passed = result.diff_pixels <= max_diff_pixels and result.psnr >= min_psnr
    if not result.passed and dump_folder:
        os.makedirs(dump_folder, exist_ok=True)
        save_png(os.path.join(dump_folder, f"{name}_got.png"), got)
        save_png(os.path.join(dump_folder, f"{name}_ref.png"), golden)
        save_png(os.path.join(dump_folder, f"{name}_diff.png"), np.clip(np.abs(got - golden) * 4.0, 0, 1))
    return result


def validate_render(
    gaussians: Gaussians,
    camera: Camera,
    golden_path: str,
    name: str = "scene",
    settings: RenderSettings = RenderSettings(),
    config: RasterizeConfig = RasterizeConfig(),
    backend: str = "cuda",
    background=(0.0, 0.0, 0.0),
    dump_folder: str | None = None,
    max_diff_pixels: int = MAX_DIFF_PIXELS,
    min_psnr: float = MIN_PSNR,
    device=None,
) -> ValidationResult:
    """Render over ``background`` on ``device`` (CUDA unless told otherwise)
    and compare against a golden PNG on disk."""
    img = render_over_background(gaussians, camera, background, settings, config, backend, device=device)
    return validate_image(
        img.cpu().numpy(),
        load_png(golden_path),
        name=name,
        dump_folder=dump_folder,
        max_diff_pixels=max_diff_pixels,
        min_psnr=min_psnr,
    )
