"""The port's codecs (``ops/packing.py``), composable covariance functions
(``ops/covariance.py``) and ``outdoor_scene`` against the JAX package's.

Codecs bit for bit on the same numpy inputs: the JAX package's uint32 words
read as int32 equal the port's int32 words, and each side decodes the
other's words to the same floats.  The covariance composables term for term
within float32 rounding; ``outdoor_scene`` bit-identical (both are numpy).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from unitygaussiansplatting_torch.ops import covariance as tcov  # noqa: E402
from unitygaussiansplatting_torch.ops import packing as tpk  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import outdoor_scene  # noqa: E402
from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS  # noqa: E402
from unitygaussiansplatting_tpu.ops import covariance as jcov  # noqa: E402
from unitygaussiansplatting_tpu.ops import packing as jpk  # noqa: E402
from unitygaussiansplatting_tpu.utils import synthetic as jsyn  # noqa: E402

# (codec, components): [0, 1] inputs incl. the ends and values past them.
CODECS = {
    "11_10_11": 3,
    "6_5_5": 3,
    "5_6_5": 3,
    "16_16_16": 3,
    "10_10_10_2": 4,
}
# The covariance composables: the same products and sums in the same order;
# XLA may contract a product and a sum into one fused multiply-add where the
# port rounds twice, an ulp or two of the largest term.
COV_RTOL = 1e-5


def unit_inputs(k, seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.05, 1.05, (n, k)).astype(np.float32)
    v[:4] = [[0.0] * k, [1.0] * k, [0.5] * k, [1.0 - 1e-7] * k]
    return v


def as_i32(words) -> np.ndarray:
    return np.asarray(words).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_bit_for_bit(codec):
    v = unit_inputs(CODECS[codec], seed=len(codec))
    want = as_i32(getattr(jpk, f"encode_{codec}")(jnp.asarray(v)))
    got = getattr(tpk, f"encode_{codec}")(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if codec in ("11_10_11", "10_10_10_2"):
        assert (want < 0).any()  # the top bit is set in some words
    dec_j = np.asarray(getattr(jpk, f"decode_{codec}")(jnp.asarray(want.view(np.uint32))))
    dec_t = getattr(tpk, f"decode_{codec}")(got).numpy()
    np.testing.assert_array_equal(dec_t.view(np.int32), dec_j.view(np.int32))


def test_f16_bits_and_sortable_keys_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.normal(0, 100, 4096), [0.0, -0.0, 1e-8, -1e-8, 65504.0, 7e4, -7e4, np.inf, -np.inf, 6.1e-5],
    ]).astype(np.float32)
    bits = as_i32(jpk.f32_to_f16_bits(jnp.asarray(x)))
    got = tpk.f32_to_f16_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), bits)
    back_j = np.asarray(jpk.f16_bits_to_f32(jnp.asarray(bits.view(np.uint32))))
    back_t = tpk.f16_bits_to_f32(got).numpy()
    np.testing.assert_array_equal(back_t.view(np.int32), back_j.view(np.int32))

    keys = as_i32(jpk.float_to_sortable_uint(jnp.asarray(x)))
    got = tpk.float_to_sortable_uint(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), keys)
    # As u32 the keys sort as the floats do.
    order = np.argsort(got.numpy().view(np.uint32), kind="stable")
    assert (np.diff(x[order][np.isfinite(x[order])]) >= 0).all()
    back = tpk.sortable_uint_to_float(got).numpy()
    np.testing.assert_array_equal(back.view(np.int32), np.asarray(jpk.sortable_uint_to_float(
        jnp.asarray(keys.view(np.uint32)))).view(np.int32))
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))


@pytest.fixture(scope="module")
def covariance_inputs():
    rng = np.random.default_rng(2)
    n = 2048
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    scale = np.exp(rng.uniform(-5, 0, (n, 3))).astype(np.float32)
    view_pos = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(0.5, 8, n)], -1).astype(np.float32)
    a = rng.normal(size=(3, 3))
    view_rot = np.linalg.qr(a)[0].astype(np.float32)
    d = rng.normal(0, 3, (n, 2)).astype(np.float32)
    return rot, scale, view_pos, view_rot, d


def test_covariance_composables_match_jax(covariance_inputs):
    rot, scale, view_pos, view_rot, d = covariance_inputs
    focal, tx, ty = np.float32(600.0), np.float32(0.45), np.float32(0.3)
    j6 = jcov.covariance3d(jnp.asarray(rot), jnp.asarray(scale))
    t6 = tcov.covariance3d(torch.from_numpy(rot), torch.from_numpy(scale))
    np.testing.assert_allclose(t6.numpy(), np.asarray(j6), rtol=COV_RTOL, atol=1e-12)
    np.testing.assert_array_equal(tcov.cov3d_to_matrix(t6).numpy(), np.asarray(jcov.cov3d_to_matrix(jnp.asarray(
        t6.numpy()))))
    m = tcov.cov3d_to_matrix(t6).numpy()
    assert np.allclose(m, np.swapaxes(m, -1, -2)) and (np.linalg.eigvalsh(m.astype(np.float64)) > -1e-9).all()

    j2 = jcov.ewa_project(jnp.asarray(view_pos), jnp.asarray(t6.numpy()), jnp.asarray(view_rot), focal, tx, ty)
    t2 = tcov.ewa_project(torch.from_numpy(view_pos), t6, torch.from_numpy(view_rot), float(focal), float(tx),
                          float(ty))
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=COV_RTOL, atol=1e-6)

    jc = jcov.conic(jnp.asarray(t2.numpy()))
    tc = tcov.conic(t2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=COV_RTOL, atol=1e-9)
    jp = jcov.gaussian_power(jnp.asarray(tc.numpy()), jnp.asarray(d))
    tpw = tcov.gaussian_power(tc, torch.from_numpy(d))
    np.testing.assert_allclose(tpw.numpy(), np.asarray(jp), rtol=COV_RTOL, atol=1e-6)

    # The fused projection repeats the composables term for term.
    axes, cov2d = tcov.project_covariance_planar(
        torch.from_numpy(rot), torch.from_numpy(scale), torch.tensor(1.0), torch.from_numpy(view_pos),
        torch.from_numpy(view_rot), float(focal), float(tx), float(ty))
    np.testing.assert_allclose(cov2d.numpy(), t2.numpy(), rtol=COV_RTOL, atol=1e-6)
    ref = tcov.decompose_covariance2d(t2)
    np.testing.assert_allclose(axes.axis1.numpy(), ref.axis1.numpy(), rtol=1e-4, atol=1e-4)


def test_outdoor_scene_bit_identical():
    want = jsyn.outdoor_scene(n=5000, seed=3)
    got = outdoor_scene(n=5000, seed=3)
    for f in RAW_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, f
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=f)
