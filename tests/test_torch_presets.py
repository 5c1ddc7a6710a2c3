"""The port's whole import user story against the committed preset goldens.

tests/test_preset_goldens.py on the port: ``captured_scene(n=20_000,
seed=3)`` written as a PLY, imported by ``create_asset`` at each quality
preset (read, Morton order, k-means for the cluster presets, quantization,
BC7 for VeryLow), decoded, rendered at 256x160 over black, and held against
tests/goldens/preset_{quality}.png through the JAX package's golden gate
(``validate_image``).  The cluster presets take the JAX package's k-means
palette (the port draws from ``torch``, not ``jax.random``), so the blobs
are the JAX package's byte for byte and the goldens hold as they are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_preset_goldens import PRESETS, _golden_path  # noqa: E402
from unitygaussiansplatting_torch.io import asset as tas  # noqa: E402
from unitygaussiansplatting_torch.io import bridge as tbr  # noqa: E402
from unitygaussiansplatting_torch.io import creator as tcr  # noqa: E402
from unitygaussiansplatting_torch.io import device_asset as tda  # noqa: E402
from unitygaussiansplatting_torch.io.ply import write_ply  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render_over_background  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.image import load_png  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import captured_scene  # noqa: E402
from unitygaussiansplatting_tpu.io import creator as jcr  # noqa: E402
from unitygaussiansplatting_tpu.io import kmeans as jkm  # noqa: E402
from unitygaussiansplatting_tpu.validate import validate_image  # noqa: E402

torch.set_num_threads(2)

CPU = dict(device="cpu")
BLOBS = ("chunk_blob", "pos_blob", "other_blob", "color_blob", "sh_blob")
# tests/test_preset_goldens.py:55-71.
CLUSTER_ITERS = 64


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    with torch.no_grad():
        splats = tbr.gaussians_to_input_splats(captured_scene(n=20_000, seed=3).activate())
    path = tmp_path_factory.mktemp("presets") / "scene.ply"
    write_ply(str(path), splats)
    return str(path)


def jax_cluster_sh(sh, k, seed=0, iters=512, batch=8192, device=None):
    table, idx = jkm.cluster_sh(sh, k=k, seed=seed, iters=iters, batch=batch)
    return torch.from_numpy(np.array(table)), torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.mark.parametrize("quality", PRESETS)
def test_preset_frame_matches_committed_golden(scene_ply, quality, tmp_path, monkeypatch):
    monkeypatch.setattr(tcr, "cluster_sh", jax_cluster_sh)
    asset = tcr.create_asset(scene_ply, quality=quality, import_cameras=False, cluster_iters=CLUSTER_ITERS, seed=0,
                             **CPU)
    if quality in ("medium", "high", "very_high"):  # no k-means: the JAX creator is cheap here
        want = jcr.create_asset(scene_ply, quality=quality, import_cameras=False)
        for blob in BLOBS:
            assert getattr(asset, blob) == getattr(want, blob), blob
    cam = Camera.look_at([6.5, 2.2, -8.0], [0, 0.3, 0], [0, 1, 0], 47.0, 256, 160)
    settings, config = RenderSettings(sh_order=3), RasterizeConfig(pair_multiplier=3.0)
    host = tbr.input_splats_to_gaussians(tas.decode_asset(asset), **CPU)
    # The frame of the host decode, and of the asset's words decoded on the
    # device path: both through the gate.
    for name, source in (("host", host), ("device", tda.device_asset_from_asset(asset, **CPU))):
        with torch.no_grad():
            img = render_over_background(source, cam, torch.zeros(3), settings, config, **CPU).numpy()
        got8 = np.floor(np.clip(img, 0, 1) * 255.0 + 0.5) / 255.0  # save_png's quantization
        res = validate_image(got8, load_png(_golden_path(quality)), name=f"preset_{quality}_{name}",
                             dump_folder=str(tmp_path))
        assert res.passed, f"{name}: {res}"
