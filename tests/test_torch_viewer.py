"""The port's viewer, multi-object frames, renderer wrapper and the three
repairs of this layer (``suggest_pair_multiplier(model=)``,
``Camera.world_to_view``/``rotation``, the package exports) against the JAX
package, on the CPU.

The same numpy scenes go through both packages: the JAX side renders with
``backend="pallas"`` (interpret mode), the port with ``device="cpu"`` (the
kernels' plain versions).  Frames are held to the bar of
``tests/test_torch_render.py`` (default config); counts and exports exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
import unitygaussiansplatting_torch as tpkg  # noqa: E402
import unitygaussiansplatting_tpu as jpkg  # noqa: E402
from test_torch_render import E2E_FRACTION, assert_e2e_close  # noqa: E402
from unitygaussiansplatting_torch import models as tmodels  # noqa: E402
from unitygaussiansplatting_torch.editing import merge_gaussians  # noqa: E402
from unitygaussiansplatting_torch.models import renderer as trd  # noqa: E402
from unitygaussiansplatting_torch.models.viewer import ViewerSession  # noqa: E402
from unitygaussiansplatting_tpu import models as jmodels  # noqa: E402
from unitygaussiansplatting_tpu.models import renderer as jrd  # noqa: E402
from unitygaussiansplatting_tpu.models.viewer import ViewerSession as JaxViewerSession  # noqa: E402

torch.set_num_threads(2)

BAR = E2E_FRACTION["default"]


def separated(raw_list):
    """(JAX clouds, port clouds) shrunk and moved apart along the view axis,
    as tests/test_render_pipeline.py:152-165 does: per-object sorting is
    then a correct global order."""
    jax_clouds, port_clouds = [], []
    for raw, dz in zip(raw_list, (-1.2, 1.2)):
        jg = raw.activate()
        jg = dataclasses.replace(jg, means=jg.means * 0.4 + jnp.asarray([0.0, 0.0, dz]))
        jax_clouds.append(jg)
        port_clouds.append(tp.port_cloud(jg))
    return jax_clouds, port_clouds


@pytest.fixture(scope="module")
def objects():
    return separated([tp.jax_scene(n=300, seed=10), tp.jax_scene(n=300, seed=11)])


def translation(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def test_render_multi_matches_merged(objects):
    # tests/test_render_pipeline.py:152-165's bar.
    _, (a, b) = objects
    _, tcam = tp.cameras()
    multi = trd.render_multi([a, b], tcam, device="cpu")
    merged = trd.render(merge_gaussians([a, b]), tcam, device="cpu")
    np.testing.assert_allclose(multi.numpy(), merged.numpy(), atol=5e-4)


MULTI_CASES = {
    "by-depth": {},
    # The far object in front by explicit order, the near one moved by a model.
    "order+models": dict(render_order=[0.0, 1.0], models=[translation(0.2, 0.1, 0.0), None]),
}


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_render_multi_matches_jax_pallas(objects, case):
    (ja, jb), (ta, tb) = objects
    jcam, tcam = tp.cameras()
    kw = MULTI_CASES[case]
    want = np.asarray(jrd.render_multi([ja, jb], jcam, backend="pallas", **kw))
    tkw = dict(kw, models=[None if m is None else torch.from_numpy(m) for m in kw["models"]]) if "models" in kw else kw
    got = trd.render_multi([ta, tb], tcam, device="cpu", **tkw)
    assert_e2e_close(got.numpy(), want, BAR)


def test_render_order_changes_the_frame(objects):
    _, (a, b) = objects
    _, tcam = tp.cameras()
    ab = trd.render_multi([a, b], tcam, render_order=[1.0, 0.0], device="cpu")
    ba = trd.render_multi([a, b], tcam, render_order=[0.0, 1.0], device="cpu")
    assert float((ab - ba).abs().max()) > 1e-2


def test_gaussian_splat_renderer_matches_jax(objects):
    (ja, _), (ta, _) = objects
    jcam, tcam = tp.cameras()
    want = np.asarray(jrd.GaussianSplatRenderer(ja, backend="pallas").render_frame(jcam))
    got = trd.GaussianSplatRenderer(ta, device="cpu").render_frame(tcam)
    assert_e2e_close(got.numpy(), want, BAR)


def test_viewer_memo_matches_jax(objects):
    # tests/test_render.py:3-40's sequence through both sessions.
    (ja, _), (ta, _) = objects
    jcam, tcam = tp.cameras()
    jcam2 = jrd.Camera.look_at(eye=[0.3, 0.5, -3.0], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0,
                               width=tp.WIDTH, height=tp.HEIGHT)
    view2 = np.array(jcam2.view)
    jsess = JaxViewerSession(ja, jcam, backend="pallas")
    sess = ViewerSession(ta, tcam, device="cpu")
    a = sess.frame()
    assert sess.frame() is a  # identical pose: cache hit, the same object
    c = sess.frame(view=torch.from_numpy(view2))  # moved: a fresh frame
    assert c is not a and float((c - a).abs().max()) > 1e-4
    d = sess.frame(view=torch.from_numpy(view2), opacity_scale=2.0)  # settings delta
    assert d is not c
    assert (sess.stats.frames, sess.stats.rendered, sess.stats.reused) == (4, 3, 1)
    assert jsess.frame() is jsess.frame()
    for want, got in ((jsess.frame(), a), (jsess.frame(view=jnp.asarray(view2)), c),
                      (jsess.frame(view=jnp.asarray(view2), opacity_scale=2.0), d)):
        assert_e2e_close(got.numpy(), np.asarray(want), BAR)
    assert dataclasses.asdict(jsess.stats) == dict(frames=5, rendered=3, reused=2)
    # The moved frame is the entry point's frame at that view, bit for bit.
    cam2 = dataclasses.replace(tcam, view=torch.from_numpy(view2))
    assert torch.equal(c, trd.render_with_stats(ta, cam2, device="cpu")[0])
    sess.update_gaussians(ta)
    e = sess.frame(view=torch.from_numpy(view2), opacity_scale=2.0)
    assert e is not d and torch.equal(e, d)  # the scene swap invalidated the cache
    sess.invalidate()
    assert sess.frame(view=torch.from_numpy(view2), opacity_scale=2.0) is not e


def test_suggest_pair_multiplier_takes_the_model():
    jcam, tcam = tp.cameras()
    raw = tp.jax_scene(n=400, seed=5)
    m = translation(0.0, 0.0, 1.5)  # farther: fewer tiles per splat
    m[:3, :3] = np.diag([1.3, 1.3, 1.3])
    want = jrd.suggest_pair_multiplier(raw.activate(), [jcam], model=jnp.asarray(m))
    got = trd.suggest_pair_multiplier(tp.port_scene(raw).activate(), [tcam], model=torch.from_numpy(m), device="cpu")
    assert got[1] == want[1] and got[0] == pytest.approx(want[0])
    assert got[1] != trd.suggest_pair_multiplier(tp.port_scene(raw).activate(), [tcam], device="cpu")[1]


def test_camera_world_to_view_and_rotation():
    jcam, tcam = tp.cameras()
    p = np.random.default_rng(1).normal(size=(257, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcam.rotation.numpy(), np.asarray(jcam.rotation))
    got = tcam.world_to_view(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcam.world_to_view(jnp.asarray(p))), rtol=0, atol=1e-6)
    assert got.shape == (257, 3)


def test_exports_match_jax():
    assert sorted(tpkg.__all__) == sorted(jpkg.__all__)
    assert sorted(tmodels.__all__) == sorted(jmodels.__all__)
    for mod in (tpkg, tmodels):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
