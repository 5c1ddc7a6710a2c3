"""Synthetic test scenes.

Procedurally generated clouds with known statistics stand in for captured
scenes (bicycle/truck/garden), which are not distributable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.gaussians import RawGaussians
from .device import resolve_device


def sphere_scene(
    n: int = 10_000,
    radius: float = 1.0,
    seed: int = 0,
    sh_bands: bool = True,
) -> RawGaussians:
    """Random splats on a sphere shell with varied scale/orientation/color.

    Host numpy generation, bit-identical to the JAX package's
    ``utils.synthetic.sphere_scene`` for the same arguments; returns CPU
    tensors.
    """
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = radius * (1.0 + 0.05 * rng.normal(size=(n, 1)))
    means = (dirs * radii).astype(np.float32)

    rot = rng.normal(size=(n, 4)).astype(np.float32)  # unnormalized wxyz
    log_scales = rng.uniform(np.log(0.005), np.log(0.05), size=(n, 3)).astype(np.float32)
    opacity_logits = rng.uniform(-2.0, 3.0, size=(n,)).astype(np.float32)
    sh0 = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    if sh_bands:
        sh = (0.2 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    else:
        sh = np.zeros((n, 15, 3), dtype=np.float32)
    return RawGaussians(
        means=torch.from_numpy(means),
        rotations_wxyz=torch.from_numpy(rot),
        log_scales=torch.from_numpy(log_scales),
        opacity_logits=torch.from_numpy(opacity_logits),
        sh0=torch.from_numpy(sh0),
        sh=torch.from_numpy(sh),
    )


def sphere_scene_device(
    n: int = 10_000,
    radius: float = 1.0,
    seed: int = 0,
    sh_bands: bool = True,
    device=None,
) -> RawGaussians:
    """:func:`sphere_scene`'s distributions drawn on ``device`` (CUDA unless
    told otherwise) from a seeded ``torch.Generator``.

    Statistically the same scene, not the same bits: a full-size scene is
    generated in milliseconds on the card instead of minutes of host numpy.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def uniform(lo, hi, *shape):
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return u * (hi - lo) + lo

    dirs = normal(n, 3)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    radii = radius * (1.0 + 0.05 * normal(n, 1))
    log_scales = uniform(math.log(0.005), math.log(0.05), n, 3)
    rot = normal(n, 4)
    opacity_logits = uniform(-2.0, 3.0, n)
    sh0 = uniform(-1.5, 1.5, n, 3)
    if sh_bands:
        sh = 0.2 * normal(n, 15, 3)
    else:
        sh = torch.zeros((n, 15, 3), device=dev, dtype=torch.float32)
    return RawGaussians(
        means=dirs * radii,
        rotations_wxyz=rot,
        log_scales=log_scales,
        opacity_logits=opacity_logits,
        sh0=sh0,
        sh=sh,
    )


def _value_noise(pos: np.ndarray, seed: int, octaves: int = 3, base_freq: float = 0.8) -> np.ndarray:
    """Multi-octave 3D value noise in [-1, 1], vectorized over (N, 3) points.

    Gives procedural scenes the spatial color/SH coherence of real captures
    (neighboring surface splats share appearance) — load-bearing for
    Morton-chunk compression and BC7 behavior, which degenerate on
    iid-random colors.
    """
    total = np.zeros(pos.shape[0], np.float32)
    amp = 1.0
    norm = 0.0
    for octave in range(octaves):
        freq = base_freq * (2.0**octave)
        p = pos * freq
        i = np.floor(p).astype(np.int64)
        f = (p - i).astype(np.float32)
        f = f * f * (3.0 - 2.0 * f)  # smoothstep fade
        acc = np.zeros(pos.shape[0], np.float32)
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            h = (
                (i[:, 0] + dx) * 73856093
                ^ (i[:, 1] + dy) * 19349663
                ^ (i[:, 2] + dz) * 83492791
                ^ np.int64(seed * 2654435761 + octave * 97531)
            ) & 0x7FFFFFFF
            h = (h * 2246822519) & 0x7FFFFFFF
            val = (h.astype(np.float32) / np.float32(0x7FFFFFFF)) * 2.0 - 1.0
            wx = f[:, 0] if dx else 1.0 - f[:, 0]
            wy = f[:, 1] if dy else 1.0 - f[:, 1]
            wz = f[:, 2] if dz else 1.0 - f[:, 2]
            acc += val * wx * wy * wz
        total += amp * acc
        norm += amp
        amp *= 0.5
    return total / norm


def _quat_from_normal(normal: np.ndarray, rng) -> np.ndarray:
    """wxyz quaternions rotating +z to each normal, with a random twist
    about the normal (surface splats are tangent-flattened but have
    arbitrary in-plane orientation, as trained scenes do)."""
    n = normal.shape[0]
    nz = normal[:, 2]
    # Half-way quaternion between +z and the normal: w = 1 + n.z, v = z x n.
    q = np.stack(
        [1.0 + nz, -normal[:, 1], normal[:, 0], np.zeros(n, np.float32)], axis=1
    )
    # Degenerate antiparallel case: 180-degree flip about x.
    flip = nz < -0.9999
    q[flip] = np.asarray([0.0, 1.0, 0.0, 0.0], np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # Twist about z applied first (q * twist): twist = [cos t, 0, 0, sin t].
    t = rng.uniform(0.0, np.pi, size=n).astype(np.float32)
    ct, st = np.cos(t), np.sin(t)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    out = np.stack(
        [w * ct - z * st, x * ct - y * st, y * ct + x * st, z * ct + w * st],
        axis=1,
    )
    return out.astype(np.float32)


def captured_scene(n: int = 2_000_000, seed: int = 0) -> RawGaussians:
    """Procedurally authored capture-like scene (the bench's import fixture).

    Unlike ``outdoor_scene`` (distribution statistics only, iid colors),
    this scene is built the way trained 3DGS captures actually look:

    - splats LIE ON surfaces (rolling ground, a central bumpy object blob,
      a torus arch, box structures) with surface-aligned flattening — the
      normal axis is 4-15x thinner than the tangent axes;
    - colors and SH are spatially-correlated textures (multi-octave value
      noise over position) on per-region palettes, so Morton-adjacent
      splats are appearance-correlated exactly as in real captures — the
      property the chunked min/max compression and BC7 encoding exploit
      (iid-random colors degenerate both);
    - a translucent floater population and a distance-scaled background
      shell reproduce the opacity bimodality and far-field of outdoor
      scenes (bicycle-class, readme.md:79-81).

    Written through io/ply.write_ply -> io/creator.create_asset, it is the
    bench's "imported scene" (nothing about it shortcuts the import path).
    Host numpy, bit-identical to the JAX package's ``captured_scene`` for the
    same arguments; returns CPU tensors.
    """
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.30)
    n_blob = int(n * 0.28)
    n_torus = int(n * 0.12)
    n_boxes = int(n * 0.10)
    n_bg = int(n * 0.12)
    n_float = n - n_ground - n_blob - n_torus - n_boxes - n_bg

    parts_pos, parts_normal = [], []

    # Rolling ground: y = -0.8 + low-frequency height field.
    gx = rng.uniform(-14.0, 14.0, size=n_ground).astype(np.float32)
    gz = rng.uniform(-14.0, 14.0, size=n_ground).astype(np.float32)
    g0 = np.stack([gx, np.zeros_like(gx), gz], axis=1)
    gy = -0.8 + 0.35 * _value_noise(g0 * 0.25, seed + 1)
    # Normal from the height-field gradient (finite differences).
    eps = 0.05
    hx = 0.35 * _value_noise((g0 + [eps, 0, 0]) * 0.25, seed + 1)
    hz = 0.35 * _value_noise((g0 + [0, 0, eps]) * 0.25, seed + 1)
    gn = np.stack([-(hx - gy) / eps, np.ones_like(gx), -(hz - gy) / eps], axis=1)
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    parts_pos.append(np.stack([gx, gy, gz], axis=1))
    parts_normal.append(gn)

    # Central object: bumpy radial blob (bush / clutter mass).
    d = rng.normal(size=(n_blob, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.1 * (1.0 + 0.35 * _value_noise(d * 2.5, seed + 2))
    blob = d * r[:, None] * np.asarray([1.3, 0.9, 1.3], np.float32)
    blob[:, 1] += 0.45
    parts_pos.append(blob)
    parts_normal.append(d)

    # Torus arch (major 2.6, minor 0.35), standing in the xz plane.
    u = rng.uniform(0, 2 * np.pi, size=n_torus).astype(np.float32)
    v = rng.uniform(0, 2 * np.pi, size=n_torus).astype(np.float32)
    cu, su, cv, sv = np.cos(u), np.sin(u), np.cos(v), np.sin(v)
    tor = np.stack(
        [(2.6 + 0.35 * cv) * cu - 4.5, (2.6 + 0.35 * cv) * su + 1.4, 0.35 * sv + 2.0],
        axis=1,
    )
    torn = np.stack([cv * cu, cv * su, sv], axis=1)
    parts_pos.append(tor)
    parts_normal.append(torn)

    # Box structures: axis-aligned faces of two boxes.
    bx = np.empty((n_boxes, 3), np.float32)
    bn = np.zeros((n_boxes, 3), np.float32)
    centers = np.asarray([[4.0, 0.2, -3.0], [-3.5, -0.1, -5.0]], np.float32)
    halfs = np.asarray([[1.2, 1.0, 0.9], [0.8, 0.7, 1.5]], np.float32)
    which = rng.integers(0, 2, size=n_boxes)
    face = rng.integers(0, 6, size=n_boxes)
    uv = rng.uniform(-1, 1, size=(n_boxes, 2)).astype(np.float32)
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32)
    for a in range(3):
        m = axis == a
        o1, o2 = (a + 1) % 3, (a + 2) % 3
        bx[m, a] = sign[m] * halfs[which[m], a]
        bx[m, o1] = uv[m, 0] * halfs[which[m], o1]
        bx[m, o2] = uv[m, 1] * halfs[which[m], o2]
        bn[m, a] = sign[m]
    bx += centers[which]
    parts_pos.append(bx)
    parts_normal.append(bn)

    # Background shell: distance-proportional splats (constant angular size).
    d = rng.normal(size=(n_bg, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 1] = np.abs(d[:, 1]) * 0.6  # mostly above the horizon
    r_bg = rng.uniform(16.0, 45.0, size=(n_bg, 1)).astype(np.float32)
    parts_pos.append(d * r_bg)
    parts_normal.append(-d)

    # Floaters: translucent haze around the action.
    fl = rng.normal(size=(n_float, 3)).astype(np.float32) * [4.0, 1.5, 4.0]
    fl[:, 1] += 0.5
    fln = rng.normal(size=(n_float, 3)).astype(np.float32)
    fln /= np.linalg.norm(fln, axis=1, keepdims=True)
    parts_pos.append(fl)
    parts_normal.append(fln)

    pos = np.concatenate(parts_pos).astype(np.float32)
    normal = np.concatenate(parts_normal).astype(np.float32)
    sizes = [n_ground, n_blob, n_torus, n_boxes, n_bg, n_float]
    region = np.repeat(np.arange(6), sizes)

    # Scales: tangent sizes log-normal per region; normal axis flattened for
    # surface splats (regions 0-3), round-ish for background/floaters.
    med = np.asarray([0.035, 0.02, 0.025, 0.03, 0.05, 0.05], np.float32)[region]
    log_tan = np.log(med) + rng.normal(0.0, 0.6, size=n)
    if n_bg:
        bg_slice = slice(n_ground + n_blob + n_torus + n_boxes, n - n_float)
        log_tan[bg_slice] = np.log(r_bg[:, 0] * 0.02) + rng.normal(0.0, 0.5, size=n_bg)
    aniso = rng.uniform(0.3, 0.8, size=n)
    flat = np.where(region <= 3, rng.uniform(1.4, 2.7, size=n), rng.uniform(0.1, 0.6, size=n))
    log_scales = np.stack(
        [log_tan + aniso * rng.normal(0, 0.3, size=n), log_tan - aniso, log_tan - flat],
        axis=1,
    ).astype(np.float32)

    rot = _quat_from_normal(normal, rng)

    # Opacity: surfaces solid-ish with spatially-correlated variation
    # (trained opacity fields are smooth over surfaces, not iid),
    # floaters/background translucent.
    surf = region <= 3
    op_noise = _value_noise(pos, seed + 30, octaves=2, base_freq=0.9)
    opacity_logits = np.where(
        surf & (rng.random(n) < 0.85),
        3.5 + 2.2 * op_noise + 0.4 * rng.normal(size=n),
        -1.5 + 2.0 * op_noise + 0.5 * rng.normal(size=n),
    ).astype(np.float32)

    # Spatially-correlated color: per-region palette modulated by a
    # luminance-dominant texture (one shared value-noise field) plus small
    # per-channel chroma noise — natural-image statistics have ~0.9
    # inter-channel correlation, which is what makes the block colors lie
    # near a line in RGB space (the property BC7 endpoint interpolation
    # exploits; fully independent channels would be adversarial).
    palette = np.asarray(
        [
            [0.35, 0.30, 0.22],  # ground: earth
            [0.18, 0.34, 0.16],  # blob: foliage
            [0.45, 0.42, 0.40],  # torus: stone
            [0.50, 0.35, 0.25],  # boxes: brick
            [0.55, 0.62, 0.75],  # background: sky/haze
            [0.50, 0.50, 0.50],  # floaters
        ],
        np.float32,
    )[region]
    lum = _value_noise(pos, seed + 10, octaves=4, base_freq=1.1)[:, None]
    chroma = np.stack(
        [_value_noise(pos, seed + 11 + c, octaves=2, base_freq=1.6) for c in range(3)],
        axis=1,
    )
    shade = _value_noise(pos, seed + 20, octaves=2, base_freq=0.5)[:, None]
    color = np.clip(
        palette * (1.0 + 0.55 * lum) * (1.0 + 0.3 * shade) + 0.08 * chroma, 0.0, 1.0
    )
    c0 = 0.2820948
    sh0 = ((color - 0.5) / c0).astype(np.float32)

    # SH 1..3: small, spatially correlated, decaying by band.
    sh = np.empty((n, 15, 3), np.float32)
    band_amp = np.repeat([0.12, 0.05, 0.02], [3, 5, 7]).astype(np.float32)
    for j in range(15):
        for c in range(3):
            sh[:, j, c] = _value_noise(
                pos, seed + 100 + j * 3 + c, octaves=2, base_freq=1.7
            )
    sh *= band_amp[None, :, None]

    return RawGaussians(
        means=torch.from_numpy(pos),
        rotations_wxyz=torch.from_numpy(rot),
        log_scales=torch.from_numpy(log_scales),
        opacity_logits=torch.from_numpy(opacity_logits),
        sh0=torch.from_numpy(sh0),
        sh=torch.from_numpy(sh),
    )
