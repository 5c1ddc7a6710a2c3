"""Configuration dataclasses for the renderer.

The same fields and defaults as ``unitygaussiansplatting_tpu.utils.config``,
as plain frozen dataclasses.  A few fields only steer the TPU package's own
schedule and are kept so that one config describes a frame in both packages;
the port ignores them (noted per field).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Per-renderer display options (GaussianSplatRenderer.cs:225-251)."""

    splat_scale: float = 1.0  # range 0.1..2.0 in the reference UI
    opacity_scale: float = 1.0  # range 0.05..20.0
    sh_order: int = 3
    sh_only: bool = False
    # Round projected color/opacity through fp16 like the reference's packed
    # SplatViewData (SplatUtilities.compute:247-248).
    fp16_color: bool = False


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Tiling, budget and view-data rounding of the tile rasterizer."""

    # Tile size in pixels; tile_h * tile_w pixels are composited by one
    # thread block of the composite kernel.
    tile_h: int = 32
    tile_w: int = 64
    # Static (splat, tile) pair capacity as a multiple of N.  Pairs are
    # generated splat-major, so an overflow truncates arbitrary splats: size
    # it with suggest_pair_multiplier, and read RenderStats.overflowed.
    pair_multiplier: float = 4.0
    # Pairs per composite step.  The early exit is checked once per step at
    # global multiples of chunk_size, so this is part of the function.
    chunk_size: int = 128
    # TPU expansion-kernel schedule knobs; the port's expansion kernel has
    # its own fixed windows and ignores both.
    expand_chunk: int = 512
    expand_windows: int = 1
    # Work cap of the TPU package's XLA tile path (not ported yet).
    max_pairs_per_tile: int = 8192
    # Decode a DeviceAsset's SH as three planar (N, 15) channels.
    decode_planar_sh: bool = False
    # Stop compositing a tile once its max transmittance drops below this.
    transmittance_eps: float = 1e-4
    # Alpha handling identical to the reference fragment shader
    # (RenderGaussianSplats.shader:79-108).
    alpha_discard: float = 1.0 / 255.0
    alpha_max: float = 0.9999
    # Clip splats to their |q| <= 2 eigen-axis quad
    # (RenderGaussianSplats.shader:54-55).
    quad_clip: bool = True
    # TPU package only: False swaps its hand-written backward for XLA
    # autodiff of its tile path.  The port's backward is always K3 + K4; it
    # has no counterpart until the port has the XLA-style tile path.
    pallas_backward: bool = True
    # Round pair color+opacity through fp16 (SplatUtilities.compute:247-248).
    pack_color_f16: bool = True
    # Round screen axes through fp16.
    pack_axes_f16: bool = False
    # Put the axis pair on the (theta 12 | log2|a1| 10 | log2|a2| 10) lattice;
    # supersedes pack_axes_f16.
    pack_axes_u32: bool = False
    # Round each pair's backward gradients to bf16 (nearest even) before the
    # per-splat sums, which stay float32.
    pack_grads_bf16: bool = False
    # Quantize each pair's center in its own eigen-frame relative to its tile
    # center (12-bit major / 17-bit minor offset); lossy, needs the ellipse
    # cull (alpha_discard > 0 or quad_clip), ignored otherwise.
    pack_center_u32: bool = False
    # Quantize color to RGBA8 (rgb over [0, 2], opacity over [0, 1]);
    # supersedes pack_color_f16.  Hard-saturates shaded rgb at 2.0.
    pack_color_rgba8: bool = False
