"""The port's BC7 codec (``io/bc7.py``) vs Pillow's decoder and the JAX
package's encoder.

The port carries its partition and anchor tables as literals and decodes
without an image library; the JAX package decodes with Pillow and derives
its two-subset tables by probing Pillow.  Here: the two-subset tables equal
JAX's derivation, the three-subset tables equal what Pillow's decoder shows,
every mode (and a reserved one) decodes random blocks to Pillow's bytes
exactly, the encoder's bytes equal JAX's with and without the mode-7 search,
and a VeryLow asset decodes in both packages to the same colors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from test_io import make_splats  # noqa: E402
from unitygaussiansplatting_torch.io import asset as tas  # noqa: E402
from unitygaussiansplatting_torch.io import bc7 as tbc7  # noqa: E402
from unitygaussiansplatting_torch.io import device_asset as tda  # noqa: E402
from unitygaussiansplatting_torch.io import formats as TF  # noqa: E402
from unitygaussiansplatting_tpu.io import asset as jas  # noqa: E402
from unitygaussiansplatting_tpu.io import bc7 as jbc7  # noqa: E402
from unitygaussiansplatting_tpu.io import device_asset as jda  # noqa: E402
from unitygaussiansplatting_tpu.io import formats as JF  # noqa: E402

BLOCKS_PER_MODE = 2000


def pillow_decode(data: bytes, width: int, height: int) -> np.ndarray:
    img = Image.frombytes("RGBA", (width, height), data, "bcn", (7, ""))
    return np.asarray(img, np.uint8).reshape(height, width, 4)


def pack(bits: np.ndarray) -> bytes:
    return np.packbits(bits, axis=-1, bitorder="little").tobytes()


def test_two_subset_tables_match_jax_derivation():
    jbc7._derive_mode7_tables()
    np.testing.assert_array_equal(tbc7.PARTITIONS2, jbc7.MODE7_PARTITIONS)
    np.testing.assert_array_equal(tbc7.ANCHORS2, jbc7.MODE7_ANCHOR2)


def test_three_subset_tables_match_pillow():
    """Mode-2 probes per partition: subset 0's endpoints black, subset 1's
    red, subset 2's green, all indices 0, show each pixel's subset; endpoints
    black to white in every subset with every index bit set decode the
    anchors (a one-bit index 1, weight 21) apart from the rest (index 3)."""

    def mode2_block(part, ends, all_on):
        bits = np.zeros(128, np.uint8)
        bits[2] = 1
        bits[3:9] = (part >> np.arange(6)) & 1
        pos = 9
        for c in range(3):
            for e in ends:
                bits[pos : pos + 5] = (e[c] >> np.arange(5)) & 1
                pos += 5
        bits[pos:] = all_on
        return bits

    k, r, g, w = (0, 0, 0), (31, 0, 0), (0, 31, 0), (31, 31, 31)
    members = pillow_decode(pack(np.stack([mode2_block(p, [k, k, r, r, g, g], 0) for p in range(64)])), 256, 4)
    anchors = pillow_decode(pack(np.stack([mode2_block(p, [k, w, k, w, k, w], 1) for p in range(64)])), 256, 4)
    for p in range(64):
        m = members[:, 4 * p : 4 * p + 4].reshape(16, 4)
        np.testing.assert_array_equal(tbc7.PARTITIONS3[p], np.where(m[:, 0] > 127, 1, np.where(m[:, 1] > 127, 2, 0)))
        a = anchors[:, 4 * p : 4 * p + 4, 0].reshape(16)
        np.testing.assert_array_equal(np.nonzero(np.abs(a.astype(int) - 84) < 3)[0],
                                      np.sort([0, *tbc7.ANCHORS3[p]]), err_msg=str(p))
        assert list(tbc7.PARTITIONS3[p, [0, *tbc7.ANCHORS3[p]]]) == [0, 1, 2]


@pytest.mark.parametrize("mode", list(range(8)) + ["reserved"])
def test_decode_matches_pillow(mode):
    rng = np.random.default_rng(mode if mode != "reserved" else 8)
    bits = np.unpackbits(rng.integers(0, 256, (BLOCKS_PER_MODE, 16), dtype=np.uint8), axis=1, bitorder="little")
    bits[:, :8] = 0
    if mode != "reserved":
        bits[:, mode] = 1
    data, width = pack(bits), 4 * BLOCKS_PER_MODE
    np.testing.assert_array_equal(tbc7.decode_bc7(data, width, 4), pillow_decode(data, width, 4))
    # A texture of several block rows, modes mixed.
    mixed = rng.permutation(bits.reshape(-1, 16 * 8)).reshape(-1)
    np.testing.assert_array_equal(tbc7.decode_bc7(pack(mixed), 80, 400), pillow_decode(pack(mixed), 80, 400))


def test_decode_rejects_bad_sizes():
    with pytest.raises(ValueError, match="multiples of 4"):
        tbc7.decode_bc7(bytes(64), 6, 4)
    with pytest.raises(ValueError, match="too short"):
        tbc7.decode_bc7(bytes(16), 8, 4)


def capture_texture(seed=0, width=256, height=136):
    """A smooth color/opacity texture with noise, as the JAX tests use; 2176
    blocks by default, two slabs of the encoder's thread pool."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    img = np.stack([x, y, x * y, 0.7 + 0.2 * np.sin(6 * x)], axis=-1)
    return np.clip(img * 255 + rng.normal(0, 9, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode7", [True, False])
def test_encode_matches_jax(mode7):
    img = capture_texture(seed=int(mode7))
    blob = tbc7.encode_bc7(img, mode7=mode7)
    assert blob == jbc7.encode_bc7(img, mode7=mode7)
    assert len(blob) == img.shape[0] * img.shape[1]  # 1 byte a texel
    out = tbc7.decode_bc7(blob, img.shape[1], img.shape[0])
    np.testing.assert_array_equal(out, jbc7.decode_bc7(blob, img.shape[1], img.shape[0]))
    mse = np.mean((out.astype(np.float64) - img) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 28.0


def test_very_low_asset_matches_jax():
    splats = make_splats(n=3000, seed=11)
    smooth = 0.5 + 0.45 * np.sin(splats.pos * np.asarray([0.95, 1.2, 1.45], np.float32))
    splats.color = smooth.astype(np.float32)
    p = JF.QUALITY_PRESETS["very_low"]
    fmt = dict(pos_format=p.pos, scale_format=p.scale, color_format=p.color, sh_format=JF.SHFormat.Norm6)
    jasset = jas.encode_asset(splats, **fmt)
    tasset = tas.encode_asset(splats, **{k: getattr(TF, type(v).__name__)(int(v)) for k, v in fmt.items()})
    assert tasset.color_blob == jasset.color_blob
    tdec, jdec = tas.decode_asset(tasset), jas.decode_asset(jasset)
    np.testing.assert_array_equal(tdec.color, jdec.color)
    np.testing.assert_array_equal(tdec.opacity, jdec.opacity)
    words = tda.device_asset_from_asset(tasset, device="cpu").color_q.numpy()
    np.testing.assert_array_equal(words, np.asarray(jda.device_asset_from_asset(jasset).color_q).view(np.int32))
    g = tda.decode_device(tda.device_asset_from_asset(tasset, device="cpu"), device="cpu")
    np.testing.assert_allclose(g.base_color.numpy(), tdec.color, atol=2e-6, rtol=2e-6)
