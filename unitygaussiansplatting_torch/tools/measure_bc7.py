"""Measure BC7 encode quality on a realistic color texture.

The port of ``tools/measure_bc7.py``, host numpy as there, through the
port's ``io/bc7`` (the JAX encoder byte for byte, on a thread pool) and
``ops/morton.morton_order_np``.  Builds the color texture the asset creator
produces for a captured-statistics scene (chunk-normalized color+opacity,
Morton-swizzled; GaussianSplatAssetCreator.cs:873-932), encodes it, and
reports its PSNR against the float texture before quantization beside the
Norm8x4 number on the same data (the 8-bit ceiling: the gap between the two
is the encoder's cost), continuous-endpoint oracle bounds of the BC7 mode
families, and a smooth-texture control.  Touches no GPU.

    python -m unitygaussiansplatting_torch.tools.measure_bc7 [n]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..io import bc7
from ..io import formats as F
from ..io.asset import morton_texel_index
from ..ops.morton import morton_order_np
from ..utils.synthetic import captured_scene


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def chunk_normalized_color_tex(n: int, seed: int = 0) -> np.ndarray:
    """(H, W, 4) float in [0, 1]: the creator's color texture before the
    8-bit quantization step (``io/asset.py`` ``encode_asset``'s color path)."""
    raw = captured_scene(n=n, seed=seed)
    means, sh0, logits = (t.numpy() for t in (raw.means, raw.sh0, raw.opacity_logits))
    # Morton reorder as the creator does (chunk locality is what the BC7
    # blocks see).
    order = morton_order_np(means)
    # The creator's linearized inputs: SH0 -> color, sigmoid opacity
    # (GaussianFileReader.cs:210-240), then per-chunk min/max normalize.
    c0 = 0.2820948
    color = sh0[order] * c0 + 0.5
    opacity = 1.0 / (1.0 + np.exp(-logits[order]))
    # SquareCentered01 warp (GaussianUtils.cs:25-38) as in CreateChunkData.
    x = opacity - 0.5
    opacity = 0.5 + np.sign(x) * np.sqrt(np.abs(x)) * np.sqrt(0.5)
    rgba = np.concatenate([color, opacity[:, None]], axis=-1).astype(np.float32)

    nchunks = (n + F.CHUNK_SIZE - 1) // F.CHUNK_SIZE
    pad = nchunks * F.CHUNK_SIZE - n
    padded = np.concatenate([rgba, np.repeat(rgba[-1:], pad, axis=0)])
    by_chunk = padded.reshape(nchunks, F.CHUNK_SIZE, 4)
    cmin = by_chunk.min(axis=1)
    cmax = by_chunk.max(axis=1)
    span = np.maximum(cmax - cmin, 1e-6)
    norm = ((by_chunk - cmin[:, None]) / span[:, None]).reshape(-1, 4)[:n]

    width, height = F.texture_size(n)
    tex = np.zeros((width * height, 4), np.float32)
    tex[morton_texel_index(n)] = norm
    return np.clip(tex, 0.0, 1.0).reshape(height, width, 4)


def texture_psnrs(tex: np.ndarray) -> dict:
    """Norm8x4 and BC7 PSNRs of ``tex`` (dB against the float texture), the
    BC7 against the 8-bit texture, and the encode's time and bytes."""
    h, w, _ = tex.shape
    u8 = np.clip(tex * 255.5, 0, 255).astype(np.uint8)
    norm8 = u8.astype(np.float32) / 255.0
    t0 = time.perf_counter()
    blob = bc7.encode_bc7(u8)
    encode_s = time.perf_counter() - t0
    dec = bc7.decode_bc7(blob, w, h).reshape(h, w, 4).astype(np.float32) / 255.0
    return dict(
        norm8=psnr(tex, norm8), bc7=psnr(tex, dec), bc7_rgb=psnr(tex[..., :3], dec[..., :3]),
        bc7_alpha=psnr(tex[..., 3], dec[..., 3]), bc7_vs_u8=psnr(norm8, dec), encode_s=encode_s,
        bytes=len(blob),
    )


def oracle_bounds(tex: np.ndarray) -> dict:
    """Continuous-endpoint oracles (dB): the best single-segment fit per 4x4
    block of each BC7 mode family with unquantized endpoints and the mode's
    index lattice, an upper bound on any encoder of that family.  A small
    gap between BC7 and the best family says the gap to the 8-bit ceiling
    is the content's (the chunk-normalized Morton texture is near noise at
    block scale), not the encoder's."""
    h, w, _ = tex.shape
    bw, bh = w // 4, h // 4
    blocks = tex.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4) * 255.0

    def recon(vals, e0, e1, weights):
        idx = bc7._fit_indices(vals, e0, e1, weights)
        wt = weights[idx].astype(np.float32)[..., None] / 64.0
        return (1.0 - wt) * e0[:, None] + wt * e1[:, None]

    def mse_of(rec):
        return np.mean((blocks - rec) ** 2, axis=(1, 2))

    # mode-6 family: one shared RGBA segment, 4-bit indices.
    e0, e1 = bc7._refine_endpoints(blocks, blocks.min(axis=1), blocks.max(axis=1), bc7.WEIGHTS4, iters=20)
    m6 = mse_of(recon(blocks, e0, e1, bc7.WEIGHTS4))

    # mode-5 family: independent RGB and A segments, 2-bit indices each.
    rgb, a = blocks[..., :3], blocks[..., 3:]
    r0, r1 = bc7._refine_endpoints(rgb, rgb.min(axis=1), rgb.max(axis=1), bc7.WEIGHTS2, iters=8)
    a0, a1 = bc7._refine_endpoints(a, a.min(axis=1), a.max(axis=1), bc7.WEIGHTS2, iters=8)
    m5 = mse_of(np.concatenate([recon(rgb, r0, r1, bc7.WEIGHTS2), recon(a, a0, a1, bc7.WEIGHTS2)], axis=-1))

    # mode-7 family: 2 subsets (all 64 partitions), RGBA 2-bit indices.
    m7 = np.full(blocks.shape[0], np.inf, np.float32)
    for part in range(64):
        mask1 = np.broadcast_to(bc7.PARTITIONS2[part].astype(bool), (blocks.shape[0], 16))
        rec7 = np.zeros_like(blocks)
        for mask in (~mask1, mask1):
            s0, s1 = bc7._refine_endpoints_masked(blocks, mask, bc7.WEIGHTS2, iters=4)
            rec7 = np.where(mask[..., None], recon(blocks, s0, s1, bc7.WEIGHTS2), rec7)
        m7 = np.minimum(m7, mse_of(rec7))

    def to_db(m):
        return 10.0 * np.log10(1.0 / max(float(np.mean(m)) / 255.0**2, 1e-12))

    return dict(mode5=to_db(m5), mode6=to_db(m6), mode7=to_db(m7), best=to_db(np.minimum(np.minimum(m5, m6), m7)))


def smooth_control(size: int = 256) -> dict:
    """BC7 and its 8-bit ceiling on a smooth texture: the encoder's quality
    where the content allows it."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    smooth = np.stack([
        0.5 + 0.45 * np.sin(3 * xx + 1.7 * yy),
        0.5 + 0.45 * np.cos(2.1 * xx - 2.9 * yy),
        0.5 + 0.45 * np.sin(5.3 * xx * yy),
        0.5 + 0.45 * np.cos(1.3 * xx + 4.1 * yy),
    ], axis=-1).astype(np.float32)
    su8 = np.clip(smooth * 255.5, 0, 255).astype(np.uint8)
    sdec = bc7.decode_bc7(bc7.encode_bc7(su8), size, size).reshape(size, size, 4)
    return dict(bc7=psnr(smooth, sdec / 255.0), ceiling=psnr(smooth, su8 / 255.0))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=1_000_000)
    args = p.parse_args(argv)
    tex = chunk_normalized_color_tex(args.n)
    h, w, _ = tex.shape
    print(f"scene n={args.n}, texture {w}x{h}")
    t = texture_psnrs(tex)
    print(f"Norm8x4 PSNR (8-bit ceiling): {t['norm8']:.2f} dB")
    print(f"BC7 PSNR: {t['bc7']:.2f} dB total (rgb {t['bc7_rgb']:.2f} / alpha {t['bc7_alpha']:.2f}); "
          f"vs-u8 {t['bc7_vs_u8']:.2f} dB; encode {t['encode_s']:.1f}s ({t['bytes'] / 1e6:.1f} MB, 1 B/px)")
    o = oracle_bounds(tex)
    print(f"continuous-endpoint oracles: mode5 {o['mode5']:.2f} / mode6 {o['mode6']:.2f} / "
          f"mode7 {o['mode7']:.2f} / per-block best {o['best']:.2f} dB")
    print(f"-> encoder slack <= {o['best'] - t['bc7']:.2f} dB of the {t['norm8'] - t['bc7']:.2f} dB gap to the "
          "8-bit ceiling (rest is content-intrinsic at 4 bpp)")
    s = smooth_control()
    print(f"smooth-texture control: BC7 {s['bc7']:.2f} dB (8-bit ceiling {s['ceiling']:.2f} dB)")
    return dict(texture=t, oracles=o, smooth=s)


if __name__ == "__main__":
    main()
