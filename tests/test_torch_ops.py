"""Port per-splat math and binning inputs vs the JAX package, on the CPU,
and the projection's dispatch between its plain version and its kernels.

Float math at rtol 1e-5 / atol 1e-4 px (XLA's CPU code contracts a*b + c
into FMA and its transcendentals differ from PyTorch's by an ulp); the
lattice rounding and every integer binning input exactly.
"""

import contextlib
import ctypes
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.ops import activations as tact  # noqa: E402
from unitygaussiansplatting_torch.ops import cuda_build  # noqa: E402
from unitygaussiansplatting_torch.ops import projection  # noqa: E402
from unitygaussiansplatting_torch.ops import binning as tb  # noqa: E402
from unitygaussiansplatting_torch.ops import covariance as tcov  # noqa: E402
from unitygaussiansplatting_torch.ops import sh as tsh  # noqa: E402
from unitygaussiansplatting_torch.ops import tile_common as ttc  # noqa: E402
from unitygaussiansplatting_torch.ops.projection import project_splats  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RenderSettings  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene, sphere_scene_device  # noqa: E402
from unitygaussiansplatting_tpu.ops import activations as jact  # noqa: E402
from unitygaussiansplatting_tpu.ops import binning as jb  # noqa: E402
from unitygaussiansplatting_tpu.ops import covariance as jcov  # noqa: E402
from unitygaussiansplatting_tpu.ops import sh as jsh  # noqa: E402
from unitygaussiansplatting_tpu.ops import tile_common as jtc  # noqa: E402
from unitygaussiansplatting_tpu.ops.projection import project_splats as jax_project  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    raw = tp.jax_scene()
    return raw, raw.activate(), tp.port_scene(raw).activate()


@pytest.fixture(scope="module")
def projections(scenes):
    _, jg, _ = scenes
    jcam, _ = tp.cameras()
    jproj = jax_project(jg, jcam)
    return jproj, tp.proj_to_torch(jproj)


def test_sphere_scene_bit_identical():
    j = tp.raw_arrays(tp.jax_scene(n=300, seed=3))
    p = sphere_scene(n=300, seed=3)
    for name, arr in j.items():
        np.testing.assert_array_equal(getattr(p, name).numpy(), arr, err_msg=name)


def test_sphere_scene_device_distributions():
    g = sphere_scene_device(4096, seed=1, device="cpu")
    r = torch.linalg.vector_norm(g.means, dim=1)
    assert abs(float(r.mean()) - 1.0) < 0.01 and 0.03 < float(r.std()) < 0.07
    assert g.sh.shape == (4096, 15, 3) and abs(float(g.sh.std()) - 0.2) < 0.01
    assert float(g.opacity_logits.min()) >= -2.0 and float(g.opacity_logits.max()) <= 3.0
    assert float(g.log_scales.min()) >= np.log(0.005) - 1e-6
    assert torch.equal(sphere_scene_device(64, seed=1, device="cpu").sh0,
                       sphere_scene_device(64, seed=1, device="cpu").sh0)


def test_activate_matches(scenes):
    _, jg, pg = scenes
    for name in ("means", "rotations", "scales", "opacities", "base_color", "sh"):
        np.testing.assert_allclose(getattr(pg, name).numpy(), np.asarray(getattr(jg, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # The export-side inverses.
    np.testing.assert_allclose(tact.inv_sigmoid(pg.opacities).numpy(),
                               np.asarray(jact.inv_sigmoid(jg.opacities)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tact.color_to_sh0(pg.base_color).numpy(),
                               np.asarray(jact.color_to_sh0(jg.base_color)), rtol=1e-6, atol=1e-6)


def test_camera_matches():
    jcam, pcam = tp.cameras()
    assert pcam.focal == pytest.approx(jcam.focal, rel=1e-12)
    assert pcam.tan_fovx == pytest.approx(jcam.tan_fovx, rel=1e-12)
    np.testing.assert_allclose(pcam.position.numpy(), np.asarray(jcam.position), rtol=1e-6, atol=1e-6)
    v = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32) + [0, 0, 3]
    np.testing.assert_allclose(pcam.view_to_pixel(t(v)).numpy(),
                               np.asarray(jcam.view_to_pixel(jnp.asarray(v))), **TOL)
    lk = type(pcam).look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 192, 128)
    np.testing.assert_array_equal(lk.view.numpy(), np.asarray(jcam.view))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_shade_sh(scenes, order):
    _, jg, _ = scenes
    d = np.random.default_rng(order).normal(size=(jg.means.shape[0], 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jsh.shade_sh(jg.base_color, jg.sh, jnp.asarray(d), order)
    got = tsh.shade_sh(t(jg.base_color), t(jg.sh), t(d), order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if order == 3:
        np.testing.assert_allclose(tsh.sh_basis(t(d)).numpy(), np.asarray(jsh.sh_basis(jnp.asarray(d))),
                                   rtol=1e-5, atol=1e-6)
        only = tsh.shade_sh(t(jg.base_color), t(jg.sh), t(d), 3, only_sh=True)
        np.testing.assert_allclose(only.numpy(), np.asarray(jsh.shade_sh(jg.base_color, jg.sh, jnp.asarray(d), 3, True)),
                                   rtol=1e-5, atol=1e-6)


def test_project_covariance_planar(scenes):
    _, jg, _ = scenes
    jcam, _ = tp.cameras()
    view = np.asarray(jcam.view)
    vp = np.asarray(jcam.world_to_view(jg.means))
    args = (jcam.focal, jcam.tan_fovx, jcam.tan_fovy)
    (ja1, ja2), jc = jcov.project_covariance_planar(jg.rotations, jg.scales, jnp.float32(1.0), vp, view[:3, :3], *args)
    (pa1, pa2), pc = tcov.project_covariance_planar(t(jg.rotations), t(jg.scales), 1.0, t(vp), t(view[:3, :3]), *args)
    for got, want in ((pa1, ja1), (pa2, ja2), (pc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # decompose_covariance2d, whose constants the fused path uses.
    da1, da2 = tcov.decompose_covariance2d(pc)
    np.testing.assert_allclose(da1.numpy(), pa1.numpy(), rtol=0, atol=0)
    ja, _ = jcov.decompose_covariance2d(jnp.asarray(pc.numpy()))
    np.testing.assert_allclose(da1.numpy(), np.asarray(ja), **TOL)


SETTINGS = {
    "default": {},
    "scaled-f16": dict(splat_scale=1.3, opacity_scale=0.7, fp16_color=True, sh_order=2),
}


def assert_axes_close(got, want):
    """Axis lengths at TOL for every splat; components at TOL but for at most
    0.5% of splats, which must then agree in direction to 2e-3 rad.

    The reference's closed form takes the major axis along (cxy, lam1 - cxx);
    for a nearly axis-aligned splat lam1 - cxx cancels to a few ulps of lam1
    (cxy^2 / (cxx - cyy) is below them), so its direction is rounding noise of
    ~1e-3 rad in either package.
    """
    g1, g2 = got.axis1.numpy(), got.axis2.numpy()
    w1, w2 = np.asarray(want.axis1), np.asarray(want.axis2)
    for g_, w_ in ((g1, w1), (g2, w2)):
        np.testing.assert_allclose(np.linalg.norm(g_, axis=-1), np.linalg.norm(w_, axis=-1), **TOL)
    close = np.isclose(g1, w1, **TOL).all(-1) & np.isclose(g2, w2, **TOL).all(-1)
    assert close.mean() >= 0.995, close.mean()
    cos = np.abs((g1 * w1).sum(-1)) / np.maximum(
        np.linalg.norm(g1, axis=-1) * np.linalg.norm(w1, axis=-1), 1e-30)
    assert np.arccos(np.clip(cos[~close], 0.0, 1.0)).max(initial=0.0) <= 2e-3


@pytest.mark.parametrize("name", list(SETTINGS))
def test_project_splats_per_field(scenes, name):
    raw, jg, pg = scenes
    jcam, pcam = tp.cameras()
    kill = np.zeros(jg.means.shape[0], bool)
    kill[::7] = True
    want = jax_project(jg, jcam, JaxRenderSettings(**SETTINGS[name]), kill_mask=jnp.asarray(kill))
    got = project_splats(pg, pcam, RenderSettings(**SETTINGS[name]), kill_mask=t(kill))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for field in ("depth", "center", "conic", "color", "opacity"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **TOL, err_msg=field)
    assert_axes_close(got, want)


def test_project_splats_with_model(scenes):
    _, jg, pg = scenes
    jcam, pcam = tp.cameras()
    c, s = np.cos(0.3), np.sin(0.3)
    model = np.array([[c, 0, s, 0.1], [0, 1, 0, -0.2], [-s, 0, c, 0.3], [0, 0, 0, 1]], np.float32)
    want = jax_project(jg, jcam, model=jnp.asarray(model))
    got = project_splats(pg, pcam, model=t(model))
    for field in ("depth", "center", "color"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **TOL, err_msg=field)
    assert_axes_close(got, want)


PACKS = {
    "f16-color": {},
    "no-packing": dict(pack_color_f16=False),
    "axes-f16": dict(pack_axes_f16=True),
    "rgba8": dict(pack_color_rgba8=True),
    "axes-u32": dict(pack_axes_u32=True),
    "axes-u32+rgba8": dict(pack_axes_u32=True, pack_color_rgba8=True),
}


@pytest.mark.parametrize("name", list(PACKS))
def test_quantize_view_fp16_exact(projections, name):
    jproj, tproj = projections
    jcfg, cfg = tp.configs(**PACKS[name])
    want = jtc.quantize_view_fp16(jproj, jcfg)
    got = ttc.quantize_view_fp16(tproj, cfg)
    for field in ("color", "opacity"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    if cfg.pack_axes_u32:
        # The lattice codes are exact; the decoded axes go through cos, sin
        # and exp2, whose XLA and PyTorch CPU versions differ by an ulp or two
        # each (measured: at most 3 ulp in the product).
        for g_, w_ in zip(ttc.axes_u32_codes(tproj.axis1, tproj.axis2),
                          jtc.axes_u32_codes(jproj.axis1, jproj.axis2)):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        for field in ("axis1", "axis2"):
            np.testing.assert_array_max_ulp(getattr(got, field).numpy(),
                                            np.asarray(getattr(want, field)), maxulp=4)
    else:
        for field in ("axis1", "axis2"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), err_msg=field)


BINNING = {
    "default": {},
    "small-tiles": dict(tile_h=8, chunk_size=64),
    "no-discard": dict(alpha_discard=0.0),
    "no-clip": dict(quad_clip=False),
    "headline": tp.HEADLINE,
}


@pytest.mark.parametrize("name", list(BINNING))
def test_binning_inputs_exact(projections, name):
    jproj, tproj = projections
    jcfg, cfg = tp.configs(**BINNING[name])
    jq = jtc.quantize_view_fp16(jproj, jcfg)
    pq = ttc.quantize_view_fp16(tproj, cfg)
    want = jb.tile_rects(jq, tp.WIDTH, tp.HEIGHT, jcfg)
    got = tb.tile_rects(pq, tp.WIDTH, tp.HEIGHT, cfg)
    valid = np.asarray(want[5])
    np.testing.assert_array_equal(got[5].numpy(), valid)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))  # counts
    for g_, w_ in zip(got[:4], want[:4]):  # x0, y0, nx, ny where they matter
        np.testing.assert_array_equal(g_.numpy()[valid], np.asarray(w_)[valid])
    assert int(tb.slot_demand(pq, tp.WIDTH, tp.HEIGHT, cfg)) == int(jb.slot_demand(jq, tp.WIDTH, tp.HEIGHT, jcfg))
    num_tiles = int(np.prod(jb.tile_grid(tp.WIDTH, tp.HEIGHT, jcfg)))
    assert tb.tile_grid(tp.WIDTH, tp.HEIGHT, cfg) == jb.tile_grid(tp.WIDTH, tp.HEIGHT, jcfg)
    db = jb.depth_key_bits(num_tiles)
    np.testing.assert_array_equal(tb.quantize_depth(pq.depth, db).numpy(),
                                  np.asarray(jb.quantize_depth(jq.depth, db)).astype(np.int32))
    assert tb.pair_budget(1500, cfg) == jb.pair_budget(1500, jcfg)


def test_depth_key_bits_and_budget_exact():
    jcfg, cfg = tp.configs()
    for num_tiles in (1, 12, 475, 1000, 4094, 4095, 70_000, 500_000):
        assert tb.depth_key_bits(num_tiles) == jb.depth_key_bits(num_tiles), num_tiles
    assert tb.depth_key_bits(475) == 23  # 1200x797 at 64x32: keys reach 2^31
    with pytest.raises(ValueError):
        tb.depth_key_bits(1 << 20)
    for n in (0, 1, 1500, 6_100_000):
        assert tb.pair_budget(n, cfg) == jb.pair_budget(n, jcfg)
    d = np.array([1e-9, 0.5, 1.0, 3.0, 1e4, -1.0, 0.0], np.float32)
    np.testing.assert_array_equal(tb.quantize_depth(t(d), 23).numpy(),
                                  np.asarray(jb.quantize_depth(jnp.asarray(d), 23)).astype(np.int32))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough for the dispatch."""

    @property
    def device(self):
        return torch.device("cuda")


# The projection's dispatch (ops/projection.py): csrc/project.cu's kernels for
# CUDA tensors that need no autograd graph, the plain version otherwise.
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("need_grad", [False, True])
def test_projection_dispatch_rule(monkeypatch, device, need_grad):
    g = sphere_scene(n=64, seed=1).activate()
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 96, 64)
    means = g.means.detach()
    if device == "cuda":
        means = means.as_subclass(_OnCard)
    g = dataclasses.replace(g, means=means.requires_grad_(need_grad))
    taken = []
    monkeypatch.setattr(projection, "project_splats_cuda", lambda *args: taken.append("kernels"))
    monkeypatch.setattr(projection, "project_splats_plain", lambda *args: taken.append("plain"))
    project_splats(g, cam)
    assert taken == ["kernels" if device == "cuda" and not need_grad else "plain"]


def test_projection_needs_graph(monkeypatch):
    # One grad rule for the projection and rasterize: a leaf that requires
    # grad anywhere among the projection's inputs (a planar SH channel, the
    # view, the model) sends a card's cloud to the plain version, unless grad
    # mode is off.
    g = sphere_scene(n=64, seed=1).activate()
    g = dataclasses.replace(g, means=g.means.as_subclass(_OnCard))
    cam = Camera.look_at([0, 0.5, -3.0], [0, 0, 0], [0, 1, 0], 45.0, 96, 64)
    taken = []
    monkeypatch.setattr(projection, "project_splats_cuda", lambda *args: taken.append("kernels"))
    monkeypatch.setattr(projection, "project_splats_plain", lambda *args: taken.append("plain"))

    def route(gg, camera=cam, model=None):
        taken.clear()
        project_splats(gg, camera, model=model)
        return taken[0]

    assert not projection.needs_graph(None, g.means) and route(g) == "kernels"
    planar = dataclasses.replace(g, sh=tuple(g.sh[..., c] for c in range(3)))
    leaves = {
        "means": dataclasses.replace(g, means=g.means.clone().requires_grad_(True)),
        "opacities": dataclasses.replace(g, opacities=g.opacities.clone().requires_grad_(True)),
        "planar sh": dataclasses.replace(planar, sh=(*planar.sh[:2], planar.sh[2].clone().requires_grad_(True))),
    }
    for name, gg in leaves.items():
        assert route(gg) == "plain", name
        with torch.no_grad():
            assert route(gg) == "kernels", name
    view = cam.view.clone().requires_grad_(True)
    assert projection.needs_graph(view) and route(g, camera=dataclasses.replace(cam, view=view)) == "plain"
    assert route(g, model=torch.eye(4).requires_grad_(True)) == "plain"
    with torch.no_grad():
        assert not projection.needs_graph(view)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_project_splats_on_cpu_takes_the_plain_version(scenes, name, grad):
    _, _, pg = scenes
    _, pcam = tp.cameras()
    if grad:
        pg = dataclasses.replace(pg, means=pg.means.clone().requires_grad_(True))
    settings = RenderSettings(**SETTINGS[name])
    before = cuda_build.launched.copy()
    got = project_splats(pg, pcam, settings)
    want = projection.project_splats_plain(pg, pcam, settings)
    assert cuda_build.launched == before
    assert got.center.requires_grad == grad
    for field in got._fields:
        torch.testing.assert_close(getattr(got, field), getattr(want, field), rtol=0, atol=0, equal_nan=True)


def test_projection_sh_layouts_for_the_kernel():
    # _sh_channels: per channel (pointer, splat stride, coefficient stride);
    # only a contiguous, 16-byte aligned (N, 15, 3) tensor is staged.
    sh = torch.zeros(256, 15, 3)
    cols, staged = projection._sh_channels(sh, 256, 15, sh.device)
    assert staged == (sh.data_ptr() % 16 == 0)
    assert cols == [v for c in range(3) for v in (sh.data_ptr() + 4 * c, 45, 3)]
    cols, staged = projection._sh_channels(sh[1:], 255, 15, sh.device)
    assert not staged and cols[0] == sh.data_ptr() + 180
    strided = sh.transpose(1, 2).contiguous().transpose(1, 2)
    cols, staged = projection._sh_channels(strided, 256, 15, sh.device)
    assert not staged and cols == [v for c in range(3) for v in (strided.data_ptr() + 4 * 15 * c, 45, 1)]
    planar = tuple(sh[..., c] for c in range(3))
    cols, staged = projection._sh_channels(planar, 256, 8, sh.device)
    assert not staged and cols == [v for c in range(3) for v in (sh.data_ptr() + 4 * c, 45, 3)]
    assert not projection._sh_channels(sh[:, :8], 256, 8, sh.device)[1]
    with pytest.raises(ValueError):
        projection._sh_channels(sh[:, :3], 256, 8, sh.device)
    with pytest.raises(ValueError):
        projection._sh_channels(sh.double(), 256, 15, sh.device)


# The entry points the wrappers call besides their launches, by source.
KERNEL_QUERIES = {
    "pair_expand.cu": ("expand_pairs_blocks_per_sm",),
    "composite_fwd.cu": ("composite_fwd_cluster_size", "composite_fwd_pixels_per_thread",
                         "composite_fwd_max_active_clusters"),
    "composite_bwd.cu": ("composite_bwd_pixels_per_thread",),
    "pair_sort.cu": ("pair_sort_tile_keys",),
}


def _wrapper_launches() -> set:
    """``(library, entry point)`` of every ``cuda_build.launch`` call in the port."""
    package = cuda_build.CSRC.parent
    calls = set()
    for path in package.rglob("*.py"):
        calls |= set(re.findall(r'cuda_build\.launch\(\s*"(\w+)",\s*"(\w+)"', path.read_text()))
    return calls


@pytest.mark.parametrize("source", cuda_build.SOURCES)
def test_cuda_build_reads_every_entry_point(source):
    # The functions of the source's extern "C" block, typed from their
    # declarations: each launch returns its status and takes the stream
    # last; the error string maps a status to the runtime's message.
    sigs = cuda_build.c_signatures(source)
    text = (cuda_build.CSRC / source).read_text()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    defined = set(re.findall(r"^[A-Za-z][^(;/]*?\b(\w+)\(", block, flags=re.M))
    assert set(sigs) == defined and defined
    name = source[:-3]
    launches = {entry for lib, entry in _wrapper_launches() if lib == name}
    assert launches and launches == {fn for fn in sigs if fn.endswith("_launch")}
    for fn in launches:
        restype, argtypes = sigs[fn]
        assert restype is ctypes.c_int and argtypes[-1] is ctypes.c_void_p, fn
    for fn in KERNEL_QUERIES.get(source, ()):
        assert sigs[fn][0] is ctypes.c_int and all(a is ctypes.c_int for a in sigs[fn][1]), fn
    assert sigs[f"{name}_error_string"] == (ctypes.c_char_p, [ctypes.c_int])
    assert set(sigs) == {*launches, *KERNEL_QUERIES.get(source, ()), f"{name}_error_string"}


# Every C spelling a parameter of the port's sources has, and its ctypes type.
C_SPELLINGS = {
    "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
    "int*": ctypes.c_void_p, "const long long*": ctypes.c_void_p, "long long*": ctypes.c_void_p,
    "const unsigned*": ctypes.c_void_p, "const unsigned char*": ctypes.c_void_p,
    "unsigned char*": ctypes.c_void_p, "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
    "int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
}


def test_cuda_build_types_each_c_spelling(tmp_path, monkeypatch):
    params = ",\n    ".join(f"{spelling} p{i}" for i, spelling in enumerate(C_SPELLINGS))
    (tmp_path / "k.cu").write_text(f'extern "C" {{\n// a comment (int)\nconst char* k_error_string(int status) '
                                   f'{{ return ""; }}\nint k_launch({params}) {{ {{ }} return 0; }}\n}}\n')
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert cuda_build.c_signatures("k.cu") == {
        "k_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        "k_launch": (ctypes.c_int, list(C_SPELLINGS.values())),
    }


@pytest.mark.parametrize("decl, named", [
    ("int k_launch(double eps, void* stream)", "parameter eps is 'double'"),
    ("int k_launch(size_t n, void* stream)", "parameter n is 'size_t'"),
    ("int k_launch(const float* x, unsigned long n, void* stream)", "parameter n is 'unsigned long'"),
    ("int k_launch(Params p, void* stream)", "parameter p is 'Params'"),
    ("double k_launch(void* stream)", "the return type is 'double'"),
])
def test_cuda_build_refuses_an_unknown_c_type(tmp_path, monkeypatch, decl, named):
    (tmp_path / "k.cu").write_text(f'struct Params {{ int a; }};\nextern "C" {{\n{decl} {{ return 0; }}\n}}\n')
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    with pytest.raises(ValueError, match=re.escape(f"k.cu: k_launch: {named}")):
        cuda_build.c_signatures("k.cu")


class _FakeLibrary:
    """Stands for a loaded library: its launch returns ``status``."""

    def __init__(self, status):
        self.status, self.calls = status, []

    def k_launch(self, *args):
        self.calls.append(args)
        return self.status

    def k_error_string(self, status):
        return b"invalid argument"


@pytest.mark.parametrize("status", [0, 1])
def test_cuda_build_launch_appends_the_stream_checks_and_counts(monkeypatch, status):
    lib = _FakeLibrary(status)
    monkeypatch.setitem(cuda_build._loaded, "k", lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("Stream", (), {"cuda_stream": 77})())
    monkeypatch.setattr(cuda_build, "launched", cuda_build.collections.Counter())
    if status:
        with pytest.raises(RuntimeError, match=r"k_launch: CUDA error 1 \(invalid argument\)"):
            cuda_build.launch("k", "k_launch", "cuda:0", 3, None)
    else:
        cuda_build.launch("k", "k_launch", "cuda:0", 3, None)
    assert lib.calls == [(3, None, 77)]
    assert cuda_build.launched == ({} if status else {"k_launch": 1})


class _FakeClusterLibrary:
    """Stands for K1's library: its occupancy query returns ``found``."""

    def __init__(self, found):
        self.found = found

    def composite_fwd_max_active_clusters(self, npix, chunk):
        return self.found

    def composite_fwd_cluster_size(self, npix):
        return 2

    def composite_fwd_error_string(self, status):
        return b"out of memory"


@pytest.mark.parametrize("found, error", [
    (-2, r"composite_tiles \(cluster occupancy\): CUDA error 2 \(out of memory\)"),
    (0, r"cannot place a cluster of 2 CTAs for a tile of 256 pixels"),
    (3, None),
])
def test_k1_cluster_check_raises_through_cuda_build(monkeypatch, found, error):
    # K1's occupancy query reports a CUDA error as a negative status, read
    # by the same rule as a launch's; no cluster that fits is an error too.
    from unitygaussiansplatting_torch.ops import rasterize_cuda

    monkeypatch.setitem(cuda_build._loaded, "composite_fwd", _FakeClusterLibrary(found))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    check = rasterize_cuda._check_clusters.__wrapped__
    if error is None:
        check(0, 256, 64)
    else:
        with pytest.raises(RuntimeError, match=error):
            check(0, 256, 64)
