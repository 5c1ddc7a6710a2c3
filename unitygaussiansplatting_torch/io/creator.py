"""Asset creation pipeline: file import -> Morton reorder -> cluster -> encode.

The port of ``unitygaussiansplatting_tpu/io/creator.py``: the file reads and
the encode are host numpy, as there; the Morton order
(``ops/morton.morton_order``) and the SH k-means (``io/kmeans.cluster_sh``)
run on the device.  The equivalent of the reference's asset creator
(package/Editor/GaussianSplatAssetCreator.cs:247-340 ``CreateAsset``): read
PLY/SPZ, compute bounds, reorder splats along a 3D Morton curve for chunk
locality, optionally k-means-cluster SH, chunk-quantize and write blobs.  The
editor-window plumbing becomes a plain function + CLI.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops.morton import morton_order
from ..utils.device import resolve_device
from . import formats as F
from .asset import GaussianSplatAssetData, InputSplats, encode_asset, save_asset
from .kmeans import cluster_sh
from .ply import read_ply
from .spz import read_spz

CAMERAS_JSON = "cameras.json"


def read_input_file(path: str) -> InputSplats:
    """Dispatch by extension (GaussianFileReader.cs:28-66)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".spz":
        return read_spz(path)
    raise ValueError(f"unsupported splat file type: {path}")


def reorder_morton(splats: InputSplats, device=None) -> InputSplats:
    """Sort splats along the 3D Morton curve (AssetCreator.cs:384-429).

    The order is computed on ``device`` (CUDA unless told otherwise) by the
    JAX package's native formula and a stable sort, so the permutation is
    the one its creator takes from its native extension; the fields are
    gathered on the host.
    """
    order = morton_order(splats.pos, device=device).cpu().numpy()
    return InputSplats(
        pos=splats.pos[order],
        rot=splats.rot[order],
        scale=splats.scale[order],
        color=splats.color[order],
        opacity=splats.opacity[order],
        sh=splats.sh[order],
    )


def load_json_cameras(input_path: str) -> list | None:
    """Walk parent dirs for cameras.json (AssetCreator.cs:1068-1118).

    Returns reference-convention camera dicts: position + world axes with the
    y/z axes negated (the json holds a view matrix in 3DGS convention).
    """
    cur = os.path.abspath(input_path)
    while True:
        parent = os.path.dirname(cur)
        if parent == cur or not os.path.isdir(parent):
            return None
        candidate = os.path.join(parent, CAMERAS_JSON)
        if os.path.exists(candidate):
            break
        cur = parent
    with open(candidate) as f:
        cams = json.load(f)
    if not cams:
        return None
    out = []
    for cam in cams:
        rot = np.asarray(cam["rotation"], np.float32)
        axis_x = rot[:, 0]
        axis_y = -rot[:, 1]
        axis_z = -rot[:, 2]
        out.append(
            {
                "pos": [float(x) for x in cam["position"]],
                "axis_x": [float(x) for x in axis_x],
                "axis_y": [float(x) for x in axis_y],
                "axis_z": [float(x) for x in axis_z],
                "fov": 25.0,  # mirrors the reference's placeholder (cs:1112)
            }
        )
    return out


def create_asset(
    input_path: str,
    output_folder: str | None = None,
    quality: str = "medium",
    pos_format: F.VectorFormat | None = None,
    scale_format: F.VectorFormat | None = None,
    color_format: F.ColorFormat | None = None,
    sh_format: F.SHFormat | None = None,
    import_cameras: bool = True,
    cluster_iters: int = 512,
    seed: int = 0,
    bc7_mode7: bool = True,
    device=None,
) -> GaussianSplatAssetData:
    """Import a PLY/SPZ file into a quantized asset.

    ``quality`` picks a reference preset ("very_low".."very_high",
    AssetCreator.cs:189-228); explicit format args override individual fields
    (the "Custom" mode).  When ``output_folder`` is given the blobs are saved
    there as ``{name}_{chk,pos,oth,col,shs}.bytes`` + a json sidecar.
    ``bc7_mode7=False`` trades ~0.7 dB of BC7 color quality for ~12x faster
    color encode on BC7 presets (very_low) — see io.asset.encode_asset.
    The Morton order and the k-means run on ``device`` (CUDA unless told
    otherwise).  The k-means draws from a ``torch.Generator`` seeded with
    ``seed``, not from ``jax.random``: a cluster preset's palette is not the
    JAX package's for the same seed.
    """
    dev = resolve_device(device)
    preset = F.QUALITY_PRESETS[quality]
    pos_format = preset.pos if pos_format is None else pos_format
    scale_format = preset.scale if scale_format is None else scale_format
    color_format = preset.color if color_format is None else color_format
    sh_format = preset.sh if sh_format is None else sh_format

    cameras = load_json_cameras(input_path) if import_cameras else None
    splats = read_input_file(input_path)
    splats = reorder_morton(splats, device=dev)

    sh_indices = sh_table = None
    if F.is_cluster_format(sh_format):
        k = F.SH_CLUSTER_COUNT[sh_format]
        table, idx = cluster_sh(splats.sh, k=k, seed=seed, iters=cluster_iters, device=dev)
        sh_table = table.cpu().numpy()
        sh_indices = idx.cpu().numpy()

    asset = encode_asset(
        splats,
        pos_format=pos_format,
        scale_format=scale_format,
        color_format=color_format,
        sh_format=sh_format,
        sh_indices=sh_indices,
        sh_table=sh_table,
        cameras=cameras,
        bc7_mode7=bc7_mode7,
    )

    if output_folder is not None:
        name = os.path.splitext(os.path.basename(input_path))[0]
        save_asset(asset, output_folder, name)
    return asset


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Create a quantized splat asset from PLY/SPZ")
    p.add_argument("input", help="input .ply or .spz file")
    p.add_argument("-o", "--output", required=True, help="output folder")
    p.add_argument(
        "-q",
        "--quality",
        default="medium",
        choices=sorted(F.QUALITY_PRESETS.keys()),
    )
    p.add_argument("--no-cameras", action="store_true")
    p.add_argument("--device", default=None, help="device of the Morton order and the k-means (default: cuda)")
    p.add_argument(
        "--fast-bc7",
        action="store_true",
        help="skip the BC7 mode-7 partition search (~12x faster color "
        "encode on BC7 presets, ~-0.7 dB)",
    )
    args = p.parse_args(argv)
    asset = create_asset(
        args.input,
        output_folder=args.output,
        quality=args.quality,
        import_cameras=not args.no_cameras,
        bc7_mode7=not args.fast_bc7,
        device=args.device,
    )
    ratio = (asset.splat_count * 248) / max(asset.total_bytes(), 1)
    print(
        f"{asset.splat_count} splats -> {asset.total_bytes() / 1e6:.1f} MB "
        f"({ratio:.2f}x smaller than raw), hash {asset.data_hash[:16]}"
    )


if __name__ == "__main__":
    main()
