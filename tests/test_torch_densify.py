"""The port's density control (``models/densify.py``) and quaternion helpers
vs the JAX package.

The seven cases of tests/test_densify.py on the port, then the same numpy
scene and statistics through both packages' ``prune``, ``densify``,
``reset_opacity`` and ``pad_to_capacity``: maps, counts and every field
exact, except the split children's means.  Those are the parent's mean plus
``rot @ (eps * scale)``: the offsets ``eps`` are drawn from the same numpy
generator and the rotation matrices agree exactly, but JAX multiplies with
a numpy ``einsum`` and the port with torch ops, which may round the sum
differently: the children's means may differ by a few ulps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from unitygaussiansplatting_torch.models import densify as tdn  # noqa: E402
from unitygaussiansplatting_torch.models.camera import Camera  # noqa: E402
from unitygaussiansplatting_torch.models.renderer import render  # noqa: E402
from unitygaussiansplatting_torch.ops import quaternion as tq  # noqa: E402
from unitygaussiansplatting_torch.utils.config import RasterizeConfig  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import sphere_scene  # noqa: E402
from unitygaussiansplatting_tpu.models import densify as jdn  # noqa: E402
from unitygaussiansplatting_tpu.ops import quaternion as jq  # noqa: E402

torch.set_num_threads(2)

# Split children's means against JAX's: |mean| <= ~1.2 here, so 4 ulps of
# float32 at 1.0 (measured over five scenes: max 1.2e-7, one ulp, on ~2% of
# the entries).
CHILD_MEAN_ATOL = 4 * 2.0**-23
# unpack_smallest3 against JAX's: XLA may contract ``pq * sqrt2 - c`` into a
# fused multiply-add (measured max 6e-8 over 5000 quaternions).
UNPACK_ATOL = 1.2e-7


@pytest.fixture()
def raw():
    return sphere_scene(n=300, seed=4)


def _replace(raw, **fields):
    return dataclasses.replace(raw, **{k: v.clone() for k, v in fields.items()})


# --- tests/test_densify.py on the port


def test_prunes_transparent(raw):
    raw2 = _replace(raw, opacity_logits=raw.opacity_logits)
    raw2.opacity_logits[:50] = -15.0  # ~0 opacity
    assert tdn.prune(raw2).num_splats == 250


def test_prunes_huge(raw):
    raw2 = _replace(raw, log_scales=raw.log_scales)
    raw2.log_scales[:10] = 3.0
    assert tdn.prune(raw2, max_world_scale=1.0).num_splats == 290


def test_clone_small(raw):
    grads = torch.zeros((raw.num_splats, 3))
    grads[:20] = 1.0  # hot
    raw.log_scales[:20] = float(np.log(0.001))  # small -> cloned
    out = tdn.densify(raw, grads, grad_threshold=0.5, scale_threshold=0.01)
    assert out.num_splats == raw.num_splats + 20


def test_split_large(raw):
    grads = np.zeros((raw.num_splats, 3), np.float32)
    grads[:15] = 1.0
    raw.log_scales[:15] = float(np.log(0.5))  # big -> 2 children, parent removed
    out = tdn.densify(raw, grads, grad_threshold=0.5, scale_threshold=0.01)
    assert out.num_splats == raw.num_splats + 15
    assert float(torch.exp(out.log_scales).max()) < 0.5  # children are smaller


def test_cold_unchanged(raw):
    out = tdn.densify(raw, torch.zeros((raw.num_splats, 3)))
    assert out.num_splats == raw.num_splats
    for f in RAW_FIELDS:
        assert torch.equal(getattr(out, f), getattr(raw, f)), f


def test_reset_opacity(raw):
    out = tdn.reset_opacity(raw, ceiling=0.01)
    assert float(torch.sigmoid(out.opacity_logits).max()) <= 0.011


def test_pad_to_capacity_renders_same(raw):
    cam = Camera.look_at([0, 0, -2.6], [0, 0, 0], [0, 1, 0], 45.0, 96, 64)
    cfg = RasterizeConfig(tile_h=8, chunk_size=32)
    with torch.no_grad():
        img_a = render(raw.activate(), cam, config=cfg, device="cpu")
        padded = tdn.pad_to_capacity(raw, 512)
        assert padded.num_splats == 512
        img_b = render(padded.activate(), cam, config=cfg, device="cpu")
    np.testing.assert_allclose(img_a.numpy(), img_b.numpy(), atol=1e-5)


# --- parity with the JAX package


def _both(n=400, seed=4):
    """The same numpy scene as a JAX RawGaussians and a port one, with
    opacities kept clear of the prune threshold."""
    jraw = tp.jax_scene(n=n, seed=seed)
    arrays = tp.raw_arrays(jraw)
    return jdn._from_np(arrays), tp.port_scene(jraw), arrays


def _assert_fields_equal(tout, jout, skip=()):
    for f in RAW_FIELDS:
        if f not in skip:
            np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)), err_msg=f)


@pytest.mark.parametrize("position_grads", ["norm3", "mean"])
def test_densify_matches_jax(position_grads):
    jraw, traw, arrays = _both()
    n = arrays["means"].shape[0]
    rng = np.random.default_rng(11)
    small = rng.random(n) < 0.3
    arrays["log_scales"][small] = np.log(rng.uniform(0.001, 0.009, (small.sum(), 3))).astype(np.float32)
    jraw, traw = jdn._from_np(arrays), tp.port_scene(jdn._from_np(arrays))
    if position_grads == "norm3":  # (N, 3) rows, float32
        grads = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(1e-3)
    else:  # the loop's (N,) float64 mean statistic
        grads = np.abs(rng.normal(size=n)) * 1e-3
    jout, jsrc, jnew = jdn.densify(jraw, grads, grad_threshold=1e-3, seed=7, return_map=True)
    tout, tsrc, tnew = tdn.densify(traw, torch.from_numpy(grads), grad_threshold=1e-3, seed=7, return_map=True)

    np.testing.assert_array_equal(tsrc.numpy(), jsrc)
    np.testing.assert_array_equal(tnew.numpy(), jnew)
    assert tout.num_splats == jout.num_splats
    hot = np.linalg.norm(grads.reshape(n, -1), axis=1) > 1e-3
    scale = np.exp(arrays["log_scales"]).max(1)
    n_split, n_clone = int((hot & (scale > 0.01)).sum()), int((hot & (scale <= 0.01)).sum())
    assert n_split > 10 and n_clone > 10, (n_split, n_clone)
    assert tout.num_splats == n + n_clone + n_split
    children = slice(n - n_split + n_clone, None)
    _assert_fields_equal(tout, jout, skip=("means",))
    got, want = tout.means.numpy(), np.asarray(jout.means)
    np.testing.assert_array_equal(got[: children.start], want[: children.start])
    np.testing.assert_allclose(got[children], want[children], rtol=0, atol=CHILD_MEAN_ATOL)
    assert not np.array_equal(got[children], np.asarray(jraw.means)[jsrc[children]])  # children moved


def test_prune_reset_and_pad_match_jax():
    jraw, traw, arrays = _both()
    arrays["opacity_logits"][::7] = -12.0
    arrays["log_scales"][::11] = 1.5
    jraw, traw = jdn._from_np(arrays), tp.port_scene(jdn._from_np(arrays))
    jout, jkept = jdn.prune(jraw, max_world_scale=2.0, return_map=True)
    tout, tkept = tdn.prune(traw, max_world_scale=2.0, return_map=True)
    np.testing.assert_array_equal(tkept.numpy(), jkept)
    _assert_fields_equal(tout, jout)
    assert tout.num_splats < traw.num_splats

    _assert_fields_equal(tdn.reset_opacity(traw, ceiling=0.02), jdn.reset_opacity(jraw, ceiling=0.02))
    _assert_fields_equal(tdn.pad_to_capacity(traw, 700), jdn.pad_to_capacity(jraw, 700))
    # The JAX quirk, kept: no padding needed -> the input object itself.
    assert tdn.pad_to_capacity(traw, traw.num_splats) is traw
    with pytest.raises(ValueError, match="exceed capacity"):
        tdn.pad_to_capacity(traw, 10)


def test_densify_leaves_input_alone():
    _, traw, arrays = _both(n=100)
    before = {f: getattr(traw, f).clone() for f in RAW_FIELDS}
    grads = torch.ones(100, dtype=torch.float64)
    out = tdn.densify(traw, grads, grad_threshold=0.5)
    assert out.num_splats > 100
    for f in RAW_FIELDS:
        assert torch.equal(getattr(traw, f), before[f]), f


# --- quaternion helpers


def test_quat_to_rotation_matrix_matches_jax():
    q = np.random.default_rng(1).normal(size=(500, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = tq.quat_to_rotation_matrix(torch.from_numpy(q)).numpy()
    want = np.asarray(jq.quat_to_rotation_matrix(jnp.asarray(q)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


def test_smallest3_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(500, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    h = np.float32(0.5)
    ties = np.array([[h, h, h, h], [-h, h, -h, h], [0, 0.6, -0.6, 0.5], [0, 0, 0, -1], [1, 0, 0, 0]], np.float32)
    ties /= np.linalg.norm(ties, axis=1, keepdims=True)
    q = np.concatenate([q, ties])
    packed = tq.pack_smallest3(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jq.pack_smallest3(jnp.asarray(q))))
    np.testing.assert_array_equal(packed[-5:, 3] * 3, [0, 0, 1, 3, 0])  # the first index wins a tie

    # Stored triples of unit norm and beyond it: the largest component
    # decodes to ~0 and to the sqrt's 1e-24 floor.
    unit = np.array([[1.0, 1.0, 0.5, 0.0], [1.0, 1.0, 1.0, 0.0]], np.float32)
    pq = np.concatenate([packed, unit])
    got = tq.unpack_smallest3(torch.from_numpy(pq)).numpy()
    want = np.asarray(jq.unpack_smallest3(jnp.asarray(pq)))
    np.testing.assert_allclose(got, want, rtol=0, atol=UNPACK_ATOL)
    np.testing.assert_array_equal(got[-2:], want[-2:])
    assert 0 < got[-2, 0] < 3e-4 and got[-1, 0] == np.float32(1e-12)
    np.testing.assert_allclose(np.abs(np.sum(got[:-2] * q, axis=1)), 1.0, atol=1e-6)  # a round trip
