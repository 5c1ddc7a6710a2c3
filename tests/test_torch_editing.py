"""The port's editing layer against the JAX package's, on the CPU.

The same numpy inputs (the JAX package's seeded ``sphere_scene``, seeded
numpy arrays) go through ``unitygaussiansplatting_tpu`` (quaternion ops,
``ops/sh.py:rotate_sh``, ``editing/``) and ``unitygaussiansplatting_torch``
on ``device="cpu"``.  Tolerances, each stated where it is used: quaternion
ops, cutout masks and edit masks exact; edited positions within 1 ulp
(torch's CPU ``sqrt`` is an ulp off the correctly rounded one on a few
values, and the rotation is normalized through it); ``rotate_sh`` and the
export bake within 1e-6; a frame with a cutout kill mask within the bar of
``tests/test_torch_render.py`` against JAX's ``backend="pallas"`` frame.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from test_torch_render import E2E_FRACTION, assert_e2e_close  # noqa: E402
from unitygaussiansplatting_torch import editing as ted  # noqa: E402
from unitygaussiansplatting_torch.editing import export as tex  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.ops import quaternion as tq  # noqa: E402
from unitygaussiansplatting_torch.ops import sh as tsh  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RenderSettings  # noqa: E402
from unitygaussiansplatting_tpu import editing as jed  # noqa: E402
from unitygaussiansplatting_tpu.editing import export as jex  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.ops import quaternion as jq  # noqa: E402
from unitygaussiansplatting_tpu.ops import sh as jsh  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RenderSettings as JaxRenderSettings  # noqa: E402

torch.set_num_threads(2)

N = 500
ROT_TOL = 1e-6  # rotate_sh and the bake against JAX


@pytest.fixture(scope="module")
def scenes():
    """(JAX Gaussians, port Gaussians) with the same values: the JAX
    package's activated seeded scene."""
    jg = tp.jax_scene(n=N, seed=1).activate()
    return jg, tp.port_cloud(jg)


@pytest.fixture(scope="module")
def cams():
    return tp.cameras(160, 120)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_ulps(got, want, ulps=1):
    """Each entry within ``ulps`` float32 ulps of ``want``'s."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    space = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulps * space), np.max(np.abs(got - want) / space)


def assert_same_cloud(tg, jg, tol=0.0):
    for f in dataclasses.fields(tg):
        np.testing.assert_allclose(getattr(tg, f.name).numpy(), np.asarray(getattr(jg, f.name)), rtol=0, atol=tol,
                                   err_msg=f.name)


@pytest.mark.parametrize("op", ["quat_mul", "quat_inverse", "quat_rotate_vector"])
def test_quaternion_ops_exact(op):
    rng = np.random.default_rng(11)
    a, b = rng.normal(size=(2, 777, 4)).astype(np.float32)
    v = rng.normal(size=(777, 3)).astype(np.float32)
    args = {"quat_mul": (a, b), "quat_inverse": (a,), "quat_rotate_vector": (v, a)}[op]
    want = np.asarray(getattr(jq, op)(*map(jnp.asarray, args)))
    got = getattr(tq, op)(*map(t, args)).numpy()
    np.testing.assert_array_equal(got, want)


CUTOUTS = {
    "ellipsoid": [dict(scale=1.0, type=0, invert=False)],
    "inverted-box": [dict(scale=1.0, type=1, invert=True)],
    # The first cutout containing a splat decides (compute:164-187).
    "nested": [dict(scale=0.7, type=1, invert=True), dict(scale=1.0, type=0, invert=False),
               dict(scale=1.05, type=0, invert=True, shift=(0.3, 0.0, 0.0))],
    "all-inverted": [dict(scale=1.0, type=0, invert=True, shift=(0.0, 0.5, 0.0))],
}


def cutout_pair(spec):
    m = np.eye(4, dtype=np.float32) / np.float32(spec["scale"])
    m[3, 3] = 1.0
    m[:3, 3] = -np.asarray(spec.get("shift", (0.0, 0.0, 0.0)), np.float32) / np.float32(spec["scale"])
    j = jed.Cutout(mat=jnp.asarray(m), type=jed.CutoutType(spec["type"]), invert=spec["invert"])
    return j, ted.Cutout(mat=t(m), type=ted.CutoutType(spec["type"]), invert=spec["invert"])


@pytest.mark.parametrize("name", list(CUTOUTS))
def test_cutout_kill_mask_exact(scenes, name):
    jg, tg = scenes
    pairs = [cutout_pair(s) for s in CUTOUTS[name]]
    want = np.asarray(jed.cutout_kill_mask([p[0] for p in pairs], jg.means))
    got = ted.cutout_kill_mask([p[1] for p in pairs], tg.means).numpy()
    assert 0 < got.sum() < N
    np.testing.assert_array_equal(got, want)
    assert not ted.cutout_kill_mask([], tg.means).any()


def edit_states(n, rng):
    sel, dele = rng.random(n) < 0.4, rng.random(n) < 0.2
    return (jed.EditState(jnp.asarray(sel), jnp.asarray(dele)),
            ted.EditState(torch.from_numpy(sel), torch.from_numpy(dele)))


def assert_same_state(ts, js):
    np.testing.assert_array_equal(ts.selected.numpy(), np.asarray(js.selected))
    np.testing.assert_array_equal(ts.deleted.numpy(), np.asarray(js.deleted))


@pytest.mark.parametrize("subtract", [False, True])
def test_select_rect_exact(scenes, cams, subtract):
    jg, tg = scenes
    jcam, tcam = cams
    js, ts = edit_states(N, np.random.default_rng(2))
    kill = np.random.default_rng(3).random(N) < 0.1
    want = jed.select_rect(js, jg, jcam, (20, 10), (90, 100), subtract=subtract, kill_mask=jnp.asarray(kill))
    got = ted.select_rect(ts, tg, tcam, (20, 10), (90, 100), subtract=subtract, kill_mask=torch.from_numpy(kill))
    assert_same_state(got, want)
    assert not torch.equal(got.selected, ts.selected)


@pytest.mark.parametrize("op", ["select_all", "invert_selection", "clear_selection", "delete_selected"])
def test_selection_ops_exact(op):
    js, ts = edit_states(N, np.random.default_rng(4))
    assert_same_state(getattr(ted.edits, op)(ts), getattr(jed.edits, op)(js))


def test_empty_state_on_device():
    st = ted.EditState.empty(7, device="cpu")
    assert st.selected.shape == (7,) and st.selected.dtype == torch.bool and not st.deleted.any()


TRANSFORMS = {
    "translate": lambda m, g, s: m.translate_selection(g, s, [0.25, -1.0, 3.0]),
    "rotate": lambda m, g, s: m.rotate_selection(g, s, [0.2, -0.7, 0.1, 0.6], center=[0.1, 0.2, -0.3]),
    "scale": lambda m, g, s: m.scale_selection(g, s, [2.0, 0.5, 1.5], center=[0.1, 0.2, -0.3]),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_within_an_ulp(scenes, name):
    jg, tg = scenes
    js, ts = edit_states(N, np.random.default_rng(5))
    want = TRANSFORMS[name](jed.edits, jg, js)
    got = TRANSFORMS[name](ted.edits, tg, ts)
    assert_ulps(got.means.numpy(), want.means)
    assert_ulps(got.rotations.numpy(), want.rotations)
    unselected = ~ts.selected.numpy()
    np.testing.assert_array_equal(got.means.numpy()[unselected], tg.means.numpy()[unselected])


@pytest.mark.parametrize("with_kill", [False, True])
def test_edit_summary(scenes, with_kill):
    jg, tg = scenes
    js, ts = edit_states(N, np.random.default_rng(6))
    kill = np.random.default_rng(7).random(N) < 0.3
    want = jed.edit_summary(jg, js, jnp.asarray(kill) if with_kill else None)
    got = ted.edit_summary(tg, ts, torch.from_numpy(kill) if with_kill else None)
    for name, value in got._asdict().items():
        assert isinstance(value, torch.Tensor), name  # no host read inside
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(want, name)), err_msg=name)


def random_rotation(rng):
    q = rng.normal(size=4)
    return np.asarray(jq.quat_to_rotation_matrix(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))


def test_rotate_sh_matches_jax():
    rng = np.random.default_rng(3)
    sh = rng.normal(size=(64, 15, 3)).astype(np.float32)
    r = random_rotation(rng)
    want = np.asarray(jsh.rotate_sh(jnp.asarray(sh), jnp.asarray(r)))
    np.testing.assert_allclose(tsh.rotate_sh(t(sh), t(r)).numpy(), want, rtol=0, atol=ROT_TOL)


def test_rotate_sh_consistency_and_identity():
    # tests/test_editing.py's checks, on the port: shading rotated
    # coefficients at d equals shading the originals at R^-1 d = d @ R.
    rng = np.random.default_rng(3)
    sh = t(rng.normal(size=(8, 15, 3)))
    base = torch.full((8, 3), 0.7)
    r = t(random_rotation(rng))
    d = rng.normal(size=(8, 3))
    d = t(d / np.linalg.norm(d, axis=1, keepdims=True))
    lhs = tsh.shade_sh(base, tsh.rotate_sh(sh, r), d, 3)
    rhs = tsh.shade_sh(base, sh, d @ r, 3)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=2e-4)
    np.testing.assert_allclose(tsh.rotate_sh(sh, torch.eye(3)).numpy(), sh.numpy(), atol=1e-4)


def bake_matrix():
    """A 0.4 rad yaw, an axis scale and a translation."""
    c, s = np.cos(0.4), np.sin(0.4)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * np.array([1.0, 1.5, 0.8])
    m[:3, 3] = [0.3, -0.2, 0.5]
    return m


def test_bake_transform_matches_jax(scenes):
    jg, tg = scenes
    m = bake_matrix()
    assert_same_cloud(tex.bake_transform(tg, torch.from_numpy(m)), jex.bake_transform(jg, m), ROT_TOL)


@pytest.mark.parametrize("bake", [False, True])
def test_export_and_merge_match_jax(scenes, bake):
    jg, tg = scenes
    rng = np.random.default_rng(8)
    deleted, kill = rng.random(N) < 0.2, rng.random(N) < 0.3
    m = bake_matrix() if bake else None
    want = jed.export_gaussians(jg, deleted=jnp.asarray(deleted), kill_mask=jnp.asarray(kill), bake_matrix=m)
    got = ted.export_gaussians(tg, deleted=torch.from_numpy(deleted), kill_mask=torch.from_numpy(kill), bake_matrix=m)
    assert got.num_splats == int((~deleted & ~kill).sum()) == want.num_splats
    assert_same_cloud(got, want, ROT_TOL)
    merged = ted.merge_gaussians([tg, got], matrices=[m, None])
    assert_same_cloud(merged, jed.merge_gaussians([jg, want], matrices=[m, None]), ROT_TOL)


def test_frame_with_cutout_matches_jax_pallas():
    # tests/test_torch_render.py's scene, camera and default-config bar.
    jcam, tcam = tp.cameras()
    raw = tp.jax_scene()
    jg, tg = raw.activate(), tp.port_scene(raw).activate()
    jc, tc = cutout_pair(dict(scale=0.95, type=0, invert=False, shift=(0.2, 0.0, 0.0)))
    jmask = jed.cutout_kill_mask([jc], jg.means)
    tmask = ted.cutout_kill_mask([tc], tg.means)
    want = np.asarray(jrd.render(jg, jcam, JaxRenderSettings(sh_order=3), backend="pallas", kill_mask=jmask))
    got = trd.render(tg, tcam, RenderSettings(sh_order=3), kill_mask=tmask, device="cpu")
    full = trd.render(tg, tcam, RenderSettings(sh_order=3), device="cpu")
    assert float(got[..., 3].sum()) < float(full[..., 3].sum())
    assert_e2e_close(got.numpy(), want, E2E_FRACTION["default"])
