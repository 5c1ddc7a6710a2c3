"""The port's asset core (``io/formats.py``, ``io/asset.py``, ``io/bridge.py``)
vs the JAX package.

The same numpy splats through both packages' ``encode_asset``: every blob
byte-identical, for the medium, high and very_high presets and for low with
the JAX package's own k-means SH clustering passed in (the port's k-means
draws from ``torch``: tests/test_torch_kmeans.py).  ``decode_asset``, the
bridge to ``Gaussians`` and ``morton_texel_index`` exact; a save/load round trip readable by both
packages; BC7 color byte-identical, each package decoding the other's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_io import make_splats  # noqa: E402
from unitygaussiansplatting_torch.io import asset as tas  # noqa: E402
from unitygaussiansplatting_torch.io import bridge as tbr  # noqa: E402
from unitygaussiansplatting_torch.io import formats as TF  # noqa: E402
from unitygaussiansplatting_torch.models.gaussians import Gaussians  # noqa: E402
from unitygaussiansplatting_tpu.io import asset as jas  # noqa: E402
from unitygaussiansplatting_tpu.io import bridge as jbr  # noqa: E402
from unitygaussiansplatting_tpu.io import formats as JF  # noqa: E402
from unitygaussiansplatting_tpu.io.kmeans import cluster_sh  # noqa: E402

BLOBS = ("chunk_blob", "pos_blob", "other_blob", "color_blob", "sh_blob")
SPLAT_FIELDS = ("pos", "rot", "scale", "color", "opacity", "sh")
GAUSSIAN_FIELDS = ("means", "rotations", "scales", "opacities", "base_color", "sh")


def port_formats(preset: JF.QualityPreset):
    """The port's enums for a JAX preset (the same integer values)."""
    return dict(pos_format=TF.VectorFormat(int(preset.pos)), scale_format=TF.VectorFormat(int(preset.scale)),
                color_format=TF.ColorFormat(int(preset.color)), sh_format=TF.SHFormat(int(preset.sh)))


def encode_both(quality, n=1500, seed=0):
    splats = make_splats(n=n, seed=seed)
    preset = JF.QUALITY_PRESETS[quality]
    if preset.color == JF.ColorFormat.BC7:
        preset = JF.QualityPreset(preset.pos, preset.scale, JF.ColorFormat.Norm8x4, preset.sh)
    kw = {}
    if JF.is_cluster_format(preset.sh):
        table, idx = cluster_sh(splats.sh, k=64, iters=4)
        kw = dict(sh_indices=idx, sh_table=table)
    jasset = jas.encode_asset(splats, preset.pos, preset.scale, preset.color, preset.sh, **kw)
    tasset = tas.encode_asset(splats, **port_formats(preset), **kw)
    return splats, jasset, tasset


def test_formats_match_jax():
    assert {k: (int(p.pos), int(p.scale), int(p.color), int(p.sh)) for k, p in TF.QUALITY_PRESETS.items()} == {
        k: (int(p.pos), int(p.scale), int(p.color), int(p.sh)) for k, p in JF.QUALITY_PRESETS.items()}
    for n in (1, 2048, 70_000):
        assert TF.texture_size(n) == JF.texture_size(n)
    for fmt in JF.VectorFormat:
        for idx in (False, True):
            assert TF.other_stride(TF.VectorFormat(int(fmt)), idx) == JF.other_stride(fmt, idx)
    assert not TF.uses_chunks(TF.VectorFormat.Float32, TF.VectorFormat.Float32, TF.ColorFormat.Float32x4,
                              TF.SHFormat.Float32)


@pytest.mark.parametrize("quality", ["low", "medium", "high", "very_high"])
def test_encode_decode_match_jax(quality):
    _, jasset, tasset = encode_both(quality, seed=len(quality))
    for blob in BLOBS:
        assert getattr(tasset, blob) == getattr(jasset, blob), blob
    assert tasset.data_hash == jasset.data_hash
    np.testing.assert_array_equal(tasset.bounds_min, jasset.bounds_min)
    np.testing.assert_array_equal(tasset.bounds_max, jasset.bounds_max)
    assert tasset.total_bytes() == jasset.total_bytes() and tasset.has_chunks == jasset.has_chunks

    tdec, jdec = tas.decode_asset(tasset), jas.decode_asset(jasset)
    for f in SPLAT_FIELDS:
        np.testing.assert_array_equal(getattr(tdec, f), getattr(jdec, f), err_msg=f)

    # The bridge to the renderer's Gaussians, both ways.
    g = tbr.input_splats_to_gaussians(tdec, device="cpu")
    jg = jbr.input_splats_to_gaussians(jdec)
    for f in GAUSSIAN_FIELDS:
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)
    back, jback = tbr.gaussians_to_input_splats(g), jbr.gaussians_to_input_splats(jg)
    for f in SPLAT_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(jback, f), err_msg=f)


def test_save_load_roundtrip(tmp_path):
    _, jasset, tasset = encode_both("medium", n=700, seed=3)
    meta = tas.save_asset(tasset, str(tmp_path), "scene")
    for loaded in (tas.load_asset(meta), jas.load_asset(meta)):
        for blob in BLOBS:
            assert getattr(loaded, blob) == getattr(tasset, blob), blob
        assert loaded.splat_count == 700 and loaded.data_hash == tasset.data_hash
        assert int(loaded.sh_format) == int(TF.SHFormat.Norm6)
    # The JAX package's files load in the port.
    jmeta = jas.save_asset(jasset, str(tmp_path / "jax"), "scene")
    assert tas.load_asset(jmeta).pos_blob == tasset.pos_blob


@pytest.mark.parametrize("n", [1, 255, 256, 5000, 70_000])
def test_morton_texel_index_matches_jax(n):
    got = tas.morton_texel_index(n)
    np.testing.assert_array_equal(got, jas.morton_texel_index(n))
    assert len(np.unique(got)) == n


def test_square_centered01_matches_jax():
    # The asset codec's numpy twins equal the JAX package's activations bit
    # for bit (what byte-identical blobs need); the port's torch ones too,
    # except that torch's CPU sqrt is an ulp off the correctly rounded one
    # on a few values (measured 35 of 10,000 for the inverse warp).
    import jax.numpy as jnp

    from unitygaussiansplatting_torch.ops import activations as tac
    from unitygaussiansplatting_tpu.ops import activations as jac

    x = np.random.default_rng(0).uniform(0, 1, 10_000).astype(np.float32)
    want, want_inv = np.asarray(jac.square_centered01(jnp.asarray(x))), np.asarray(
        jac.inv_square_centered01(jnp.asarray(x)))
    np.testing.assert_array_equal(tas.square_centered01(x), want)
    np.testing.assert_array_equal(tas.inv_square_centered01(x), want_inv)
    np.testing.assert_array_equal(tac.square_centered01(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_allclose(tac.inv_square_centered01(torch.from_numpy(x)).numpy(), want_inv, rtol=0,
                               atol=2.0**-24)


def test_bc7_raises():
    # BC7 color encodes and decodes as in the JAX package (both ways); only
    # a cluster SH format without its palette raises.
    splats = make_splats(n=64, seed=1)
    for mode7 in (False, True):
        tasset = tas.encode_asset(splats, color_format=TF.ColorFormat.BC7, bc7_mode7=mode7)
        jasset = jas.encode_asset(splats, color_format=JF.ColorFormat.BC7, bc7_mode7=mode7)
        assert tasset.color_blob == jasset.color_blob and tasset.data_hash == jasset.data_hash
        for f in SPLAT_FIELDS:
            np.testing.assert_array_equal(getattr(tas.decode_asset(jasset), f), getattr(jas.decode_asset(tasset), f))
    with pytest.raises(ValueError, match="cluster"):
        tas.encode_asset(splats, sh_format=TF.SHFormat.Cluster4k)
    assert isinstance(tbr.input_splats_to_gaussians(tas.decode_asset(tas.encode_asset(splats)), device="cpu"),
                      Gaussians)
