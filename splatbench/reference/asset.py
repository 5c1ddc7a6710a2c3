"""The Medium asset codec in plain PyTorch: encode an activated cloud into
the reference importer's Medium words and decode them as the viewer does
every frame.

Medium (``GaussianSplatAssetCreator.cs:195-223``): position Norm11, scale
Norm11 (of scale^(1/8)), color Norm8x4 (rgb and the square-warped
opacity), SH Norm6, each renormalized to [0, 1] within chunks of 256
consecutive splats.  The chunk table keeps position bounds as float32 and
the others as float16 (``GaussianSplatAsset.cs:231-237``), and the decode
lerps with what the table keeps (``GaussianSplatting.hlsl:428-608``).  An
activated cloud is a dict of ``means``, ``rotations`` (xyzw), ``scales``,
``opacities``, ``base_color`` and ``sh``.
"""

from __future__ import annotations

import math

import torch

CHUNK = 256
SQRT2 = 1.4142135623730951
SMALLEST3 = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
# Bits a splat: position 32, rotation 32, scale 32, color 32, SH 15 x 16;
# and 16 words a chunk.
BYTES_PER_SPLAT = 4 + 4 + 4 + 4 + 15 * 2
BYTES_PER_CHUNK = 16 * 4


def asset_bytes(n: int) -> int:
    """Bytes of a Medium asset of ``n`` splats on the device."""
    return n * BYTES_PER_SPLAT + math.ceil(n / CHUNK) * BYTES_PER_CHUNK


def _code(x: torch.Tensor, maxv: int) -> torch.Tensor:
    return torch.clamp(x * (maxv + 0.5), 0.0, float(maxv)).to(torch.int64)


def _chunks(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) -> (chunks, 256, ...), the tail padded with its chunk's first row."""
    n = x.shape[0]
    nc = -(-n // CHUNK)
    pad = nc * CHUNK - n
    if pad:
        x = torch.cat([x, x[(nc - 1) * CHUNK].expand((pad,) + tuple(x.shape[1:]))])
    return x.reshape(nc, CHUNK, *x.shape[1:])


def _per_splat(bound: torch.Tensor, n: int) -> torch.Tensor:
    """A chunk's (chunks, ...) bound repeated for its splats: (N, ...)."""
    return torch.repeat_interleave(bound, CHUNK, dim=0)[:n]


def _f16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32)


@torch.no_grad()
def encode(g: dict) -> dict:
    """The Medium words of an activated float32 cloud: integer codes (int64)
    and the chunk bounds as the table keeps them."""
    n = g["means"].shape[0]
    q = g["rotations"]
    idx = torch.argmax(torch.abs(q), dim=-1)
    three = torch.gather(q, -1, torch.tensor(SMALLEST3, device=q.device)[idx])
    three = three * torch.where(torch.gather(q, -1, idx[:, None]) >= 0, 1.0, -1.0)
    rot01 = torch.clamp(torch.cat([three * SQRT2 * 0.5 + 0.5, idx[:, None].to(q.dtype) / 3.0], -1), 0.0, 1.0)
    rot = [_code(rot01[:, 0], 1023), _code(rot01[:, 1], 1023), _code(rot01[:, 2], 1023), _code(rot01[:, 3], 3)]

    scale = torch.pow(torch.clamp(g["scales"], min=0.0).to(torch.float64), 0.125).to(torch.float32)
    o = g["opacities"] - 0.5
    col4 = torch.cat([g["base_color"], (o * o * torch.sign(o) * 2.0 + 0.5)[:, None]], -1)
    out = dict(n=n, rot=rot)
    for name, x in (("pos", g["means"]), ("scale", scale), ("col", col4)):
        c = _chunks(x)
        lo, hi = c.amin(1), c.amax(1)
        hi = torch.maximum(hi, lo + 1.0e-5)
        out[name] = torch.clamp((x - _per_splat(lo, n)) / (_per_splat(hi, n) - _per_splat(lo, n)), 0.0, 1.0)
        out[name + "_lo"], out[name + "_hi"] = (lo, hi) if name == "pos" else (_f16(lo), _f16(hi))
    c = _chunks(g["sh"])
    lo, hi = c.amin(dim=(1, 2)), c.amax(dim=(1, 2))
    hi = torch.maximum(hi, lo + 1.0e-5)
    sh01 = (g["sh"] - _per_splat(lo, n)[:, None, :]) / (_per_splat(hi, n) - _per_splat(lo, n))[:, None, :]
    out["sh"], out["sh_lo"], out["sh_hi"] = torch.clamp(sh01, 0.0, 1.0), _f16(lo), _f16(hi)

    out["pos_q"] = [_code(out["pos"][:, 0], 2047), _code(out["pos"][:, 1], 1023), _code(out["pos"][:, 2], 2047)]
    out["scale_q"] = [_code(out["scale"][:, 0], 2047), _code(out["scale"][:, 1], 1023),
                      _code(out["scale"][:, 2], 2047)]
    out["col_q"] = torch.clamp(out.pop("col") * 255.5, 0, 255).to(torch.int64)
    s = out.pop("sh")
    out["sh_q"] = [_code(s[..., 0], 31), _code(s[..., 1], 63), _code(s[..., 2], 31)]
    del out["pos"], out["scale"]
    return out


def _unit(code: torch.Tensor, maxv: int) -> torch.Tensor:
    return code.to(torch.float32) / torch.full((), float(maxv), device=code.device)


def _lerp(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    return _per_splat(lo, n) + x * (_per_splat(hi, n) - _per_splat(lo, n))


@torch.no_grad()
def decode(a: dict) -> dict:
    """The activated float32 cloud the viewer decodes from the words."""
    n = a["n"]
    r = [_unit(a["rot"][i], 1023) for i in range(3)]
    idx = torch.round(_unit(a["rot"][3], 3) * 3.0).to(torch.int32)
    three = torch.stack(r, -1) * SQRT2 - (1.0 / SQRT2)
    largest = torch.sqrt(torch.clamp(1.0 - torch.sum(three * three, dim=-1), min=1e-24))
    ta, tb, tc = three.unbind(-1)
    rot = torch.stack([
        torch.where(idx == 0, largest, ta),
        torch.where(idx == 1, largest, torch.where(idx == 0, ta, tb)),
        torch.where(idx == 2, largest, torch.where(idx <= 1, tb, tc)),
        torch.where(idx == 3, largest, tc),
    ], -1)
    masks = (2047, 1023, 2047)
    pos = torch.stack([_lerp(_unit(a["pos_q"][j], masks[j]), a["pos_lo"][:, j], a["pos_hi"][:, j], n)
                       for j in range(3)], -1)
    scale = []
    for j in range(3):
        s = _lerp(_unit(a["scale_q"][j], masks[j]), a["scale_lo"][:, j], a["scale_hi"][:, j], n)
        s = s * s
        s = s * s
        scale.append(s * s)
    col = [_lerp(_unit(a["col_q"][:, j], 255), a["col_lo"][:, j], a["col_hi"][:, j], n) for j in range(4)]
    t = col[3] * 2.0 - 1.0
    opacity = torch.sign(t) * torch.sqrt(torch.abs(t)) * 0.5 + 0.5
    sh_masks = (31, 63, 31)
    sh = torch.stack([_per_splat(a["sh_lo"][:, c], n)[:, None]
                      + _unit(a["sh_q"][c], sh_masks[c])
                      * (_per_splat(a["sh_hi"][:, c], n) - _per_splat(a["sh_lo"][:, c], n))[:, None]
                      for c in range(3)], -1)
    return dict(means=pos, rotations=rot, scales=torch.stack(scale, -1), opacities=opacity,
                base_color=torch.stack(col[:3], -1), sh=sh)
