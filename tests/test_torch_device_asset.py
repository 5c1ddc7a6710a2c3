"""The port's device-resident compressed assets (``io/device_asset.py``) and
the renderer's path through them, vs the JAX package.

``decode_device`` on the same asset bytes as JAX's ``decode_device``, and
against the host decoder, to tests/test_device_asset.py's tolerances;
``encode_device`` word for word against JAX's ``encode_device`` and within
tests/test_encode_device.py's code-boundary allowance of the host encoder;
the top bit of every word kind; the planar SH path bit-identical to the
interleaved one; a frame rendered from a ``DeviceAsset`` bit-identical to the
frame of its decoded cloud, within tests/test_torch_render.py's bars of
the JAX package's frame of its own ``DeviceAsset``, and through the JAX
package's golden gate against tests/goldens/device_asset_medium.png.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
from test_io import make_splats  # noqa: E402
from test_torch_asset import encode_both  # noqa: E402
from test_torch_cuda import DECODE_PRESETS, gaussians_differing, random_device_asset  # noqa: E402
from test_torch_render import E2E_ATOL, E2E_FRACTION, E2E_MAX  # noqa: E402
from unitygaussiansplatting_torch.io import asset as tas  # noqa: E402
from unitygaussiansplatting_torch.io import bridge as tbr  # noqa: E402
from unitygaussiansplatting_torch.io import device_asset as tda  # noqa: E402
from unitygaussiansplatting_torch.io import formats as TF  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render, suggest_pair_multiplier  # noqa: E402
from unitygaussiansplatting_torch.ops import cuda_build  # noqa: E402
from unitygaussiansplatting_torch.ops.sh import shade_sh  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import camera_from_numpy  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.io import asset as jas  # noqa: E402
from unitygaussiansplatting_tpu.io import device_asset as jda  # noqa: E402
from unitygaussiansplatting_tpu.io import formats as JF  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.utils.synthetic import sphere_scene as jax_sphere_scene  # noqa: E402

torch.set_num_threads(2)

CPU = dict(device="cpu")
FIELDS = ("means", "scales", "opacities", "base_color", "sh")
# tests/test_device_asset.py:26-40: decoded fields within 2e-6 (abs and
# rel) of the host decoder's, quaternions equal up to sign.  XLA contracts
# the chunk lerp into a fused multiply-add and torch's CPU sqrt is an ulp
# off on a few values, so the port holds JAX's decode to the same bar.
DECODE_TOL = dict(atol=2e-6, rtol=2e-6)
QUAT_DOT = 1.0 - 1e-6


def code_jitter(size):
    """tests/test_encode_device.py:45-47: the device and host encoders may
    put <= 0.5% of the words one code apart (a 1-ulp difference on a code
    boundary)."""
    return max(2, size // 200)


# tests/test_encode_device.py:22-29.
COMBOS = [
    {},
    dict(pos_format=1, scale_format=3, color_format=1, sh_format=2),
    dict(pos_format=0, scale_format=0, color_format=0, sh_format=0),
    dict(sh_format=1),
]


def jax_kw(kw):
    enum = dict(pos_format=JF.VectorFormat, scale_format=JF.VectorFormat, color_format=JF.ColorFormat,
                sh_format=JF.SHFormat)
    return {k: enum[k](v) for k, v in kw.items()}


def port_kw(kw):
    enum = dict(pos_format=TF.VectorFormat, scale_format=TF.VectorFormat, color_format=TF.ColorFormat,
                sh_format=TF.SHFormat)
    return {k: enum[k](v) for k, v in kw.items()}


def words_as_jax(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    """A port word tensor read as the JAX array's unsigned (or float) type."""
    return t.numpy().view(like.dtype)


def assert_gaussians_close(got: Gaussians, want, tol=DECODE_TOL):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f, **tol)
    qa, qb = got.rotations.numpy(), np.asarray(want.rotations)
    assert np.abs(np.sum(qa * qb, axis=-1)).min() > QUAT_DOT


@pytest.mark.parametrize("quality", ["low", "medium", "high", "very_high"])
def test_decode_device_matches_jax_and_host(quality):
    _, jasset, tasset = encode_both(quality, n=700, seed=2)
    da = tda.device_asset_from_asset(tasset, **CPU)
    jd = jda.device_asset_from_asset(jasset)
    for f in tda._WORD_FIELDS:
        want = getattr(jd, f)
        if want is None:
            assert getattr(da, f) is None, f
            continue
        want = np.asarray(want)
        np.testing.assert_array_equal(words_as_jax(getattr(da, f), want), want, err_msg=f)
    got = tda.decode_device(da, **CPU)
    assert_gaussians_close(got, jda.decode_device(jd))
    assert_gaussians_close(got, tbr.input_splats_to_gaussians(tas.decode_asset(tasset), **CPU))
    # Compression survives onto the device: footprint ~= blob bytes.
    assert da.device_bytes() == jd.device_bytes() <= tasset.total_bytes() * 1.6 + 4096


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("preset", DECODE_PRESETS)
def test_decode_device_on_the_cpu_is_the_plain_version(preset, layout, monkeypatch):
    # CPU words take decode_device_plain: nothing is built or launched.
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path asked cuda_build for a kernel")

    for name in ("build", "load", "library", "launch"):
        monkeypatch.setattr(cuda_build, name, refuse)
    da = random_device_asset(preset, 4097, seed=7)
    planar = layout == "planar"
    before = cuda_build.launched.copy()
    got = tda.decode_device(da, planar_sh=planar, **CPU)
    assert cuda_build.launched == before
    want = tda.decode_device_plain(da, planar_sh=planar, **CPU)
    assert gaussians_differing(got, want) == {}
    assert isinstance(got.sh, tuple) == (planar and preset in ("medium", "high"))  # Norm6 and Norm11 SH


@pytest.mark.parametrize("kw", COMBOS, ids=["medium", "n16-n6-f16-n11", "float32", "sh-f16"])
def test_encode_device_matches_jax(kw):
    jg = jax_sphere_scene(n=1000, seed=5).activate()
    g = Gaussians(**{f: torch.from_numpy(np.array(getattr(jg, f))) for f in ("rotations", *FIELDS)})
    got = tda.encode_device(g, **port_kw(kw), **CPU)
    want = jda.encode_device(jg, **jax_kw(kw))
    host = tda.device_asset_from_asset(tas.encode_asset(tbr.gaussians_to_input_splats(g), **port_kw(kw)), **CPU)
    for f in tda._WORD_FIELDS:
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None and getattr(host, f) is None, f
            continue
        w = np.asarray(w)
        t = getattr(got, f)
        assert t.dtype == getattr(host, f).dtype and t.shape == tuple(w.shape), f
        np.testing.assert_array_equal(words_as_jax(t, w), w, err_msg=f)
        assert int((t != getattr(host, f)).sum()) <= code_jitter(t.numel()), f


def test_encode_device_rejects_host_only_formats():
    g = sphere_scene(n=64, seed=0).activate()
    with pytest.raises(NotImplementedError, match="BC7"):
        tda.encode_device(g, color_format=TF.ColorFormat.BC7, **CPU)
    with pytest.raises(NotImplementedError, match="k-means"):
        tda.encode_device(g, sh_format=TF.SHFormat.Cluster4k, **CPU)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    g = sphere_scene(n=64, seed=0).activate()
    da = tda.encode_device(g, **CPU)
    asset = tas.encode_asset(tbr.gaussians_to_input_splats(g))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    splats = tas.decode_asset(asset)
    for call in (lambda: tda.encode_device(g), lambda: tda.decode_device(da),
                 lambda: tda.device_asset_from_asset(asset), lambda: tbr.input_splats_to_gaussians(splats)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_top_bits_decode():
    # Words whose top bit is set: bit 31 of the i32 words (rotation index 3,
    # Norm11 z, alpha, a negative float16 high half) and bit 15 of the i16
    # words (Norm6 / Norm655 top field, Norm16 65535).
    n = 256
    rng = np.random.default_rng(4)
    u32 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) | np.uint32(1 << 31)
    u16 = rng.integers(0, 2**16, (n, 15), dtype=np.int64).astype(np.uint16) | np.uint16(1 << 15)
    words = lambda a: torch.from_numpy(a.view(np.int32 if a.dtype == np.uint32 else np.int16))  # noqa: E731
    half = np.float16(-0.75).view(np.uint16).astype(np.uint32)
    info = np.zeros((1, 16), np.uint32)
    info[0, :4] = half << 16 | np.float16(-1.0).view(np.uint16)  # color lo -1, hi -0.75
    info[0, 4:10] = np.array([-1, 1, -2, 2, -3, 3], np.float32).view(np.uint32)
    info[0, 10:16] = np.float16(2.0).view(np.uint16).astype(np.uint32) << 16  # lo 0, hi 2
    da = tda.DeviceAsset(
        pos_q=words(u32), rot_q=words(u32), scale_q=words(u32), color_q=words(u32), sh_q=words(u16),
        sh_idx=None, chunk_info=words(info), splat_count=n, pos_format=TF.VectorFormat.Norm11,
        scale_format=TF.VectorFormat.Norm11, color_format=TF.ColorFormat.Norm8x4, sh_format=TF.SHFormat.Norm6,
    )
    got = tda.decode_device(da, **CPU)
    n11 = tas.dec_norm11(u32)
    np.testing.assert_allclose(got.means.numpy(), np.array([-1, -2, -3]) + n11 * np.array([2, 4, 6]), atol=2e-6)
    assert got.means[:, 2].min() > -3.0 + 6.0 * 1024 / 2047 - 1e-6  # bit 31 set: z >= 1024
    np.testing.assert_allclose(got.scales.numpy(), (2.0 * n11) ** 8, rtol=2e-6, atol=1e-7)
    rot = tas.dec_quat_norm10(u32)
    np.testing.assert_array_equal(rot[:, 3], np.where(u32 >> 30 == 3, 1.0, 2 / 3).astype(np.float32))
    want_rot = tas.unpack_smallest3_np(rot)
    assert np.abs(np.sum(got.rotations.numpy() * want_rot, axis=-1)).min() > QUAT_DOT
    rgba = np.stack([(u32 >> s) & 0xFF for s in (0, 8, 16, 24)], -1) / 255.0
    assert rgba[:, 3].min() >= 128 / 255.0
    np.testing.assert_allclose(got.base_color.numpy(), -1.0 + rgba[:, :3] * 0.25, atol=1e-6)
    t = (-1.0 + rgba[:, 3] * 0.25) * 2.0 - 1.0
    np.testing.assert_allclose(got.opacities.numpy(), np.sign(t) * np.sqrt(np.abs(t)) * 0.5 + 0.5, atol=1e-6)
    sh = tas.dec_norm565(u16.reshape(-1)).reshape(n, 15, 3) * 2.0
    np.testing.assert_allclose(got.sh.numpy(), sh, atol=1e-6)
    assert got.sh[..., 2].min() >= 2.0 * 16 / 31 - 1e-6  # bit 15 set: top field >= 16

    # Norm16 and Norm6 (u16) vectors, unchunked.
    n16 = np.stack([u16[:, 0], u16[:, 1], np.full(n, 65535, np.uint16)], -1)
    cols = tda._vector_cols(words(n16), TF.VectorFormat.Norm16)
    np.testing.assert_array_equal(torch.stack(cols, -1).numpy(), tas.dec_norm16x3(n16))
    cols = tda._vector_cols(words(u16[:, 0].copy()), TF.VectorFormat.Norm6)
    np.testing.assert_allclose(torch.stack(cols, -1).numpy(), tas.dec_norm655(u16[:, 0]), atol=1e-7)


def test_shade_sh_planar_matches_array():
    # tests/test_device_asset.py:90-113: bit for bit.
    rng = np.random.default_rng(3)
    n = 2048
    base = torch.from_numpy(rng.normal(0.5, 0.3, size=(n, 3)).astype(np.float32))
    sh = torch.from_numpy(rng.normal(0, 0.2, size=(n, 15, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    cols = tuple(sh[:, :, c].contiguous() for c in range(3))
    for order in (0, 1, 2, 3):
        assert torch.equal(shade_sh(base, sh, d, order), shade_sh(base, cols, d, order)), order
    assert torch.equal(shade_sh(base, sh, d, 3, only_sh=True), shade_sh(base, cols, d, 3, only_sh=True))


@pytest.fixture(scope="module")
def asset_scene():
    """tests/test_device_asset.py:57-81: 900 splats, the default (medium)
    asset, a camera 14 units back at 192x128."""
    splats = make_splats(n=900, seed=5)
    jcam = JaxCamera.look_at([0.0, 1.0, -14.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 45.0, 192, 128)
    tcam = camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, 192, 128)
    return splats, jcam, tcam


def test_render_from_device_asset_is_the_decoded_frame(asset_scene):
    splats, _, cam = asset_scene
    da = tda.device_asset_from_asset(tas.encode_asset(splats), **CPU)
    with torch.no_grad():
        want = render(tda.decode_device(da, **CPU), cam, **CPU)
        assert torch.equal(render(da, cam, **CPU), want)
        assert torch.equal(render(da, cam, config=RasterizeConfig(decode_planar_sh=True), **CPU), want)
    assert float(want[..., 3].max()) > 0.05  # drew something
    planar = tda.decode_device(da, planar_sh=True, **CPU)
    assert isinstance(planar.sh, tuple) and torch.equal(torch.stack(planar.sh, -1), tda.decode_device(da, **CPU).sh)
    mult, demand = suggest_pair_multiplier(da, cam, **CPU)
    assert (mult, demand) == suggest_pair_multiplier(tda.decode_device(da, **CPU), cam, **CPU) and demand > 0


def test_render_from_device_asset_matches_jax(asset_scene):
    splats, jcam, cam = asset_scene
    jasset = jas.encode_asset(splats)
    jimg = np.asarray(jrd.render(jda.device_asset_from_asset(jasset), jcam, backend="pallas"))
    with torch.no_grad():
        img = render(tda.device_asset_from_asset(tas.encode_asset(splats), **CPU), cam, **CPU).numpy()
    d = np.abs(img - jimg)
    assert d.max() <= E2E_MAX, d.max()
    assert tp.within_fraction(img, jimg, E2E_ATOL) >= E2E_FRACTION["default"]
    assert float(jimg[..., 3].max()) > 0.05


def test_render_from_device_asset_matches_committed_golden(tmp_path):
    # tests/test_validate.py:155-182 on the port: the compressed path
    # (encode_asset -> DeviceAsset -> per-frame decode -> render, black
    # background) against the committed image, through the JAX package's
    # own golden gate.
    from pathlib import Path

    from unitygaussiansplatting_tpu.utils.image import load_png
    from unitygaussiansplatting_tpu.validate import validate_image

    da = tda.device_asset_from_asset(tas.encode_asset(make_splats(n=1200, seed=7)), **CPU)
    jcam = JaxCamera.look_at([0.0, 1.0, -14.0], [0, 0, 0], [0, 1, 0], 45.0, 192, 128)
    cam = camera_from_numpy(np.asarray(jcam.view), jcam.fov_y, 192, 128)
    with torch.no_grad():
        img = render(da, cam, **CPU).numpy()
    got8 = np.floor(np.clip(img[..., :3], 0, 1) * 255.0 + 0.5) / 255.0  # save_png's quantization
    golden = load_png(str(Path(__file__).parent / "goldens" / "device_asset_medium.png"))
    res = validate_image(got8, golden, name="device_asset_medium", dump_folder=str(tmp_path))
    assert res.passed, str(res)
