"""The port's import pipeline (``io/ply.py``, ``io/spz.py``, ``ops/morton.py``,
``io/creator.py``, ``io/unity_asset.py``) and the pieces of its user story
(``deactivate``, ``Camera.from_camera_info``, ``captured_scene``, the PNG
helpers, ``render_over_background``) vs the JAX package.

Files: PLY bytes equal both ways and readable by either package; SPZ
payloads (gunzipped) equal, readable by either.  The Morton order equal to
the JAX creator's (its native extension) and the numpy fallback equal to
JAX's.  ``create_asset`` blobs byte-identical to JAX's for every preset and
both file types; the cluster presets take the JAX package's k-means palette
(monkeypatched in: the port's draws come from ``torch``, JAX's from
``jax.random``).  Camera import exact, ``deactivate`` within 1e-6,
``captured_scene`` exact, Unity YAML both ways, PNG bytes equal.
"""

import gzip
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_unity_asset  # noqa: E402
from test_io import make_splats  # noqa: E402
from unitygaussiansplatting_torch.io import asset as tas  # noqa: E402
from unitygaussiansplatting_torch.io import creator as tcr  # noqa: E402
from unitygaussiansplatting_torch.io import ply as tply  # noqa: E402
from unitygaussiansplatting_torch.io import spz as tspz  # noqa: E402
from unitygaussiansplatting_torch.io import unity_asset as tua  # noqa: E402
from unitygaussiansplatting_torch.models import gaussians as tgs  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render, render_over_background  # noqa: E402
from unitygaussiansplatting_torch.ops import composite as tcomp  # noqa: E402
from unitygaussiansplatting_torch.ops import morton as tm  # noqa: E402
from unitygaussiansplatting_torch.utils import image as timg  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import captured_scene  # noqa: E402
from unitygaussiansplatting_tpu import native as jnative  # noqa: E402
from unitygaussiansplatting_tpu.io import creator as jcr  # noqa: E402
from unitygaussiansplatting_tpu.io import kmeans as jkm  # noqa: E402
from unitygaussiansplatting_tpu.io import ply as jply  # noqa: E402
from unitygaussiansplatting_tpu.io import spz as jspz  # noqa: E402
from unitygaussiansplatting_tpu.io import unity_asset as jua  # noqa: E402
from unitygaussiansplatting_tpu.models import gaussians as jgs  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.ops import composite as jcomp  # noqa: E402
from unitygaussiansplatting_tpu.ops import morton as jm  # noqa: E402
from unitygaussiansplatting_tpu.utils import image as jimg  # noqa: E402
from unitygaussiansplatting_tpu.utils import synthetic as jsyn  # noqa: E402

torch.set_num_threads(2)

CPU = dict(device="cpu")
BLOBS = ("chunk_blob", "pos_blob", "other_blob", "color_blob", "sh_blob")
SPLAT_FIELDS = ("pos", "rot", "scale", "color", "opacity", "sh")
PRESETS = ("very_low", "low", "medium", "high", "very_high")


def assert_splats_equal(a, b):
    for f in SPLAT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_ply_bytes_and_cross_reads(tmp_path):
    splats = make_splats(n=900, seed=2)
    port, jax_file = tmp_path / "port.ply", tmp_path / "jax.ply"
    tply.write_ply(str(port), splats)
    jply.write_ply(str(jax_file), splats)
    assert port.read_bytes() == jax_file.read_bytes()
    assert_splats_equal(tply.read_ply(str(jax_file)), jply.read_ply(str(jax_file)))
    with open(port, "rb") as f:  # a file object, as the JAX reader takes
        assert_splats_equal(jply.read_ply(f), tply.read_ply(str(port)))


def test_spz_payloads_and_cross_reads(tmp_path):
    splats = make_splats(n=700, seed=4)
    port, jax_file = tmp_path / "port.spz", tmp_path / "jax.spz"
    tspz.write_spz(str(port), splats)
    jspz.write_spz(str(jax_file), splats)
    # The gzip headers differ (JAX's stamps the time); the payloads do not.
    assert gzip.decompress(port.read_bytes()) == gzip.decompress(jax_file.read_bytes())
    tspz.write_spz(str(tmp_path / "again.spz"), splats)
    assert (tmp_path / "again.spz").read_bytes() == port.read_bytes()
    assert tspz.read_spz_header(str(jax_file)) == jspz.read_spz_header(str(jax_file))
    assert_splats_equal(tspz.read_spz(str(jax_file)), jspz.read_spz(str(jax_file)))
    assert_splats_equal(jspz.read_spz(str(port)), tspz.read_spz(str(port)))


def morton_positions(kind, n=30_000):
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    if kind == "uniform":
        pos = rng.uniform(-3, 5, (n, 3)).astype(np.float32)
    elif kind == "flat-axis":
        pos[:, 1] = 0.25
    elif kind == "repeated-points":  # equal codes: the order must be stable
        pos = np.repeat(pos[: n // 8], 8, axis=0)[rng.permutation(n)]
    return pos


@pytest.mark.parametrize("kind", ["normal", "uniform", "flat-axis", "repeated-points"])
def test_morton_order_matches_jax(kind):
    pos = morton_positions(kind)
    got = tm.morton_order(pos, **CPU).numpy()
    np.testing.assert_array_equal(got, tm.morton_order_plain(pos))
    np.testing.assert_array_equal(tm.morton_order_np(pos), jm.morton_order_np(pos))
    codes = tm.morton_codes_np(pos)
    assert np.all(codes[got][1:] >= codes[got][:-1])
    if jnative.get_native() is None:
        pytest.skip("the JAX package's native extension does not load here")
    np.testing.assert_array_equal(got, jnative.morton_order(pos))
    splats = make_splats(n=2000, seed=9)
    assert_splats_equal(tcr.reorder_morton(splats, **CPU), jcr.reorder_morton(splats))


def test_morton_2d_helpers_match_jax():
    import jax.numpy as jnp

    idx = np.arange(70_000, dtype=np.int64)
    got = tm.splat_index_to_texel(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.splat_index_to_texel(jnp.asarray(idx, jnp.uint32))))
    xy = np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1).reshape(-1, 2)
    code = tm.encode_morton2d_16x16(torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(code, np.asarray(jm.encode_morton2d_16x16(jnp.asarray(xy))))
    np.testing.assert_array_equal(tm.decode_morton2d_16x16(torch.from_numpy(code)).numpy(), xy)


@pytest.fixture
def jax_palettes(monkeypatch):
    """Both creators' ``cluster_sh`` replaced by one memo of the JAX
    package's (the same palette in both assets, computed once)."""
    memo, jax_cluster_sh = {}, jkm.cluster_sh

    def palette(sh, k, seed=0, iters=512, batch=8192):
        key = (np.asarray(sh).tobytes(), k, seed, iters)
        if key not in memo:
            memo[key] = tuple(np.asarray(a) for a in jax_cluster_sh(sh, k=k, seed=seed, iters=iters, batch=batch))
        return memo[key]

    def port(sh, k, seed=0, iters=512, batch=8192, device=None):
        table, idx = palette(sh, k, seed, iters, batch)
        return torch.from_numpy(table.copy()), torch.from_numpy(idx.astype(np.int64))

    monkeypatch.setattr(tcr, "cluster_sh", port)
    monkeypatch.setattr(jkm, "cluster_sh", palette)
    return memo


@pytest.mark.parametrize("ext", [".ply", ".spz"])
@pytest.mark.parametrize("quality", PRESETS)
def test_create_asset_matches_jax(tmp_path, jax_palettes, quality, ext):
    splats = make_splats(n=1500, seed=len(quality))
    path = str(tmp_path / f"scene{ext}")
    (tply.write_ply if ext == ".ply" else tspz.write_spz)(path, splats)
    kw = dict(quality=quality, import_cameras=False, cluster_iters=3)
    got = tcr.create_asset(path, output_folder=str(tmp_path / "port"), **kw, **CPU)
    want = jcr.create_asset(path, **kw)
    for blob in BLOBS:
        assert getattr(got, blob) == getattr(want, blob), blob
    assert got.data_hash == want.data_hash
    assert tas.load_asset(str(tmp_path / "port" / "scene.asset.json")).data_hash == want.data_hash
    assert_splats_equal(tas.decode_asset(got), tas.decode_asset(want))


def write_cameras(folder):
    rng = np.random.default_rng(3)
    cams = []
    for i in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        cams.append({"id": i, "position": rng.normal(size=3).tolist(), "rotation": q.tolist()})
    (folder / "cameras.json").write_text(json.dumps(cams))


def test_cameras_import_matches_jax(tmp_path):
    write_cameras(tmp_path)
    (tmp_path / "deep" / "er").mkdir(parents=True)
    path = tmp_path / "deep" / "er" / "scene.ply"
    tply.write_ply(str(path), make_splats(n=300, seed=1))
    got, want = tcr.load_json_cameras(str(path)), jcr.load_json_cameras(str(path))
    assert got == want and len(got) == 3
    for info in got:
        for fov in (None, 40.0):
            cam = Camera.from_camera_info(info, 320, 200, fov_y_deg=fov)
            jcam = JaxCamera.from_camera_info(info, 320, 200, fov_y_deg=fov)
            np.testing.assert_array_equal(cam.view.numpy(), np.asarray(jcam.view))
            assert (cam.fov_y, cam.width, cam.height) == (jcam.fov_y, jcam.width, jcam.height)
    assert tcr.create_asset(str(path), **CPU).cameras == want


def test_creator_cli(tmp_path, capsys):
    path = tmp_path / "scene.ply"
    tply.write_ply(str(path), make_splats(n=600, seed=6))
    tcr.main([str(path), "-o", str(tmp_path / "out"), "--no-cameras", "--device", "cpu"])
    assert "600 splats" in capsys.readouterr().out
    want = jcr.create_asset(str(path), import_cameras=False)
    assert tas.load_asset(str(tmp_path / "out" / "scene.asset.json")).pos_blob == want.pos_blob


def test_deactivate_matches_jax():
    raw = captured_scene(n=3000, seed=2)
    jraw = jsyn.captured_scene(n=3000, seed=2)
    with torch.no_grad():
        back = tgs.deactivate(raw.activate())
    jback = jgs.deactivate(jraw.activate())
    for f in ("means", "rotations_wxyz", "log_scales", "opacity_logits", "sh0", "sh"):
        np.testing.assert_allclose(getattr(back, f).numpy(), np.asarray(getattr(jback, f)), rtol=1e-6, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("n", [20_000, 997])
def test_captured_scene_matches_jax(n):
    raw, jraw = captured_scene(n=n, seed=3), jsyn.captured_scene(n=n, seed=3)
    for f in ("means", "rotations_wxyz", "log_scales", "opacity_logits", "sh0", "sh"):
        got = getattr(raw, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jraw, f)), err_msg=f)


@pytest.fixture
def unity_asset():
    cams = [{"pos": [1.0, 2.0, -3.0], "axis_x": [1.0, 0.0, 0.0], "axis_y": [0.0, -1.0, 0.0],
             "axis_z": [0.0, 0.0, -1.0], "fov": 25.0}]
    return tas.encode_asset(make_splats(n=600, seed=4), cameras=cams)


def test_unity_asset_round_trip_matches_jax(tmp_path, unity_asset):
    path = tua.write_unity_asset(unity_asset, str(tmp_path / "port"), "toy")
    jpath = jua.write_unity_asset(unity_asset, str(tmp_path / "jax"), "toy")
    for name in ("toy.asset", "toy_pos.bytes.meta", "toy_shs.bytes.meta"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text(), name
    for back in (tua.load_unity_asset(path), jua.load_unity_asset(path), tua.load_unity_asset(jpath)):
        test_unity_asset._assert_assets_equal(unity_asset, back)
        assert back.cameras == unity_asset.cameras


def test_handwritten_unity_yaml_loads_in_port(tmp_path, unity_asset, monkeypatch):
    # tests/test_unity_asset.py's foreign document (blobs linked only by
    # GUID through .meta files), read by the port's loader.
    monkeypatch.setattr(test_unity_asset, "load_unity_asset", tua.load_unity_asset)
    test_unity_asset.test_handwritten_unity_yaml_loads(tmp_path, unity_asset)
    bad = tmp_path / "bad.asset"
    bad.write_text("MonoBehaviour:\n  m_Name: x\n  m_FormatVersion: 20200101\n")
    with pytest.raises(ValueError, match="format version"):
        tua.load_unity_asset(str(bad))


def test_png_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for ch in (3, 4):
        img = rng.uniform(0, 1, (37, 53, ch)).astype(np.float32)
        timg.save_png(str(tmp_path / "port.png"), img)
        jimg.save_png(str(tmp_path / "jax.png"), img)
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
        np.testing.assert_array_equal(timg.load_png(str(tmp_path / "port.png")), jimg.load_png(str(tmp_path / "jax.png")))
    a, b = rng.uniform(0, 1, (2, 16, 16, 3))
    assert timg.psnr(a, b) == jimg.psnr(a, b) and timg.rmse(a, b) == jimg.rmse(a, b)
    assert timg.diff_pixel_count(a, b) == jimg.diff_pixel_count(a, b)


@pytest.mark.parametrize("convert_gamma", [False, True])
def test_composite_over_matches_jax(convert_gamma):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    alpha = rng.uniform(0, 1, (24, 32, 1)).astype(np.float32)
    rt = np.concatenate([rng.uniform(0, 1, (24, 32, 3)).astype(np.float32) * alpha, alpha], axis=-1)
    for bg in (np.asarray([0.2, 0.3, 0.9], np.float32), rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)):
        got = tcomp.composite_over(torch.from_numpy(rt), torch.from_numpy(bg), convert_gamma=convert_gamma).numpy()
        want = np.asarray(jcomp.composite_over(jnp.asarray(rt), jnp.asarray(bg), convert_gamma=convert_gamma))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    c = rng.uniform(0, 1, 1000).astype(np.float32)
    np.testing.assert_allclose(tcomp.linear_to_gamma(torch.from_numpy(c)).numpy(),
                               np.asarray(jcomp.linear_to_gamma(jnp.asarray(c))), rtol=1e-6, atol=1e-6)


def test_render_over_background_is_render_then_composite():
    raw = captured_scene(n=4000, seed=3)
    cam = Camera.look_at([6.5, 2.2, -8.0], [0, 0.3, 0], [0, 1, 0], 47.0, 96, 64)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        g = raw.activate()
        got = render_over_background(g, cam, bg, **CPU)
        want = tcomp.composite_over(render(g, cam, **CPU), bg)
    assert torch.equal(got, want) and got.shape == (64, 96, 3)
