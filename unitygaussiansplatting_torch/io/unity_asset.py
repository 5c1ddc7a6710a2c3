"""Unity ``.asset`` (serialized ScriptableObject YAML) interop.

The port of ``unitygaussiansplatting_tpu/io/unity_asset.py`` (the same
documents, blobs and ``.meta`` files).  A Unity-created ``GaussianSplatAsset`` stores its metadata — formats, splat
count, bounds, hash, cameras — in a serialized MonoBehaviour YAML document
(GaussianSplatAsset.cs:11-31, 205-217), with the five data blobs referenced
as TextAssets by GUID; the blob bytes themselves are the ``{name}_{chk,pos,
oth,col,shs}.bytes`` files the creator writes next to it
(GaussianSplatAssetCreator.cs:300-315).  The blob encodings are already
byte-compatible (io/asset.py); this module closes the metadata gap so a real
Unity asset folder loads directly:

- :func:`load_unity_asset` parses the YAML (a tiny line-based parser — Unity
  YAML uses custom tags that break generic loaders, and the field shape is
  fixed), resolves blob GUIDs through the sibling ``*.bytes.meta`` files
  (falling back to the ``{name}_{suffix}.bytes`` convention), and returns a
  :class:`~.asset.GaussianSplatAssetData`.
- :func:`write_unity_asset` emits the same YAML shape from one of our
  assets, so scenes created here drop into a Unity project using the
  reference package (the MonoBehaviour script GUID is the reference
  package's, GaussianSplatAsset.cs.meta).
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import formats as F
from .asset import GaussianSplatAssetData

# The reference package's GaussianSplatAsset script GUID
# (package/Runtime/GaussianSplatAsset.cs.meta) — required for Unity to bind
# the serialized object to the right class.
GAUSSIAN_SPLAT_ASSET_SCRIPT_GUID = "33b71fae31e6c7d438e8566dc713e666"

_VEC_RE = re.compile(r"\{\s*x:\s*([^,}]+),\s*y:\s*([^,}]+),\s*z:\s*([^,}]+)\s*\}")
_GUID_RE = re.compile(r"guid:\s*([0-9a-fA-F]{32})")


def _parse_vec3(text: str) -> np.ndarray:
    m = _VEC_RE.search(text)
    if not m:
        raise ValueError(f"not a Vector3: {text!r}")
    return np.asarray([float(g) for g in m.groups()], np.float32)


def _parse_unity_yaml(text: str) -> dict:
    """Extract the GaussianSplatAsset fields from Unity's custom-tag YAML."""
    fields: dict = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        stripped = line.strip()
        key, _, value = stripped.partition(":")
        value = value.strip()
        if key in ("m_Name",):
            fields["name"] = value
        elif key in ("m_FormatVersion", "m_SplatCount", "m_PosFormat",
                     "m_ScaleFormat", "m_ColorFormat", "m_SHFormat"):
            fields[key] = int(value)
        elif key in ("m_BoundsMin", "m_BoundsMax"):
            fields[key] = _parse_vec3(value)
        elif key == "m_DataHash":
            # serializedVersion/Hash on the following indented lines.
            j = i + 1
            while j < len(lines) and lines[j].startswith("    "):
                hk, _, hv = lines[j].strip().partition(":")
                if hk == "Hash":
                    fields["data_hash"] = hv.strip().strip('"')
                j += 1
            i = j - 1
        elif key in ("m_PosData", "m_ColorData", "m_OtherData", "m_SHData",
                     "m_ChunkData"):
            m = _GUID_RE.search(value)
            fields[key] = m.group(1) if m else None
        elif key == "m_Cameras":
            cams, j = [], i + 1
            cur: dict | None = None
            while j < len(lines):
                ln = lines[j]
                if not ln.startswith("  "):
                    break
                s = ln.strip()
                if s.startswith("- pos:"):
                    cur = {"pos": [float(x) for x in _parse_vec3(s)]}
                    cams.append(cur)
                elif cur is not None and s.startswith(("axisX:", "axisY:", "axisZ:")):
                    axis = {"axisX": "axis_x", "axisY": "axis_y", "axisZ": "axis_z"}[
                        s.split(":")[0]
                    ]
                    cur[axis] = [float(x) for x in _parse_vec3(s)]
                elif cur is not None and s.startswith("fov:"):
                    cur["fov"] = float(s.split(":", 1)[1])
                elif not s.startswith(("x:", "y:", "z:")) and ":" in s and not s.startswith("-"):
                    break  # next top-level field
                j += 1
            fields["cameras"] = cams or None
            i = j - 1
        i += 1
    return fields


def _resolve_blob(folder: str, guid: str | None, name: str, suffix: str) -> bytes:
    """Find a blob by its TextAsset GUID (via *.meta files), else by name."""
    if guid:
        for entry in sorted(os.listdir(folder)):
            if not entry.endswith(".meta"):
                continue
            try:
                with open(os.path.join(folder, entry)) as f:
                    head = f.read(4096)
            except OSError:
                continue
            m = _GUID_RE.search(head)
            if m and m.group(1).lower() == guid.lower():
                blob_path = os.path.join(folder, entry[: -len(".meta")])
                if os.path.exists(blob_path):
                    with open(blob_path, "rb") as f:
                        return f.read()
    conventional = os.path.join(folder, f"{name}_{suffix}.bytes")
    if os.path.exists(conventional):
        with open(conventional, "rb") as f:
            return f.read()
    return b""


def load_unity_asset(asset_path: str) -> GaussianSplatAssetData:
    """Load a Unity-serialized GaussianSplatAsset folder.

    ``asset_path`` is the ``.asset`` YAML file; the blobs resolve through
    their TextAsset GUIDs (sibling ``.bytes.meta`` files) or the
    ``{name}_{suffix}.bytes`` naming convention in the same folder.
    """
    with open(asset_path) as f:
        fields = _parse_unity_yaml(f.read())
    version = fields.get("m_FormatVersion")
    if version != F.FORMAT_VERSION:
        raise ValueError(
            f"unsupported GaussianSplatAsset format version {version} "
            f"(expected {F.FORMAT_VERSION}, GaussianSplatAsset.cs:13)"
        )
    folder = os.path.dirname(os.path.abspath(asset_path))
    name = fields.get("name") or os.path.splitext(os.path.basename(asset_path))[0]

    def blob(field_key: str, suffix: str) -> bytes:
        return _resolve_blob(folder, fields.get(field_key), name, suffix)

    return GaussianSplatAssetData(
        splat_count=fields["m_SplatCount"],
        pos_format=F.VectorFormat(fields["m_PosFormat"]),
        scale_format=F.VectorFormat(fields["m_ScaleFormat"]),
        color_format=F.ColorFormat(fields["m_ColorFormat"]),
        sh_format=F.SHFormat(fields["m_SHFormat"]),
        bounds_min=fields["m_BoundsMin"],
        bounds_max=fields["m_BoundsMax"],
        chunk_blob=blob("m_ChunkData", "chk"),
        pos_blob=blob("m_PosData", "pos"),
        other_blob=blob("m_OtherData", "oth"),
        color_blob=blob("m_ColorData", "col"),
        sh_blob=blob("m_SHData", "shs"),
        cameras=fields.get("cameras"),
        data_hash=fields.get("data_hash", ""),
    )


def _fmt_vec3(v) -> str:
    x, y, z = (float(t) for t in v)
    return f"{{x: {x:.9g}, y: {y:.9g}, z: {z:.9g}}}"


def write_unity_asset(
    asset: GaussianSplatAssetData, folder: str, name: str
) -> str:
    """Write ``{name}.asset`` Unity YAML + blobs + minimal .meta files.

    The blobs and metadata match what GaussianSplatAssetCreator.CreateAsset
    persists (:300-337); GUIDs for the TextAssets are deterministic hashes
    of the blob file names so the document is self-consistent.  Returns the
    .asset path.
    """
    import hashlib

    from .asset import save_asset

    save_asset(asset, folder, name)  # writes the .bytes blobs (+ json sidecar)

    def file_guid(fname: str) -> str:
        return hashlib.md5(f"tpu-splat:{fname}".encode()).hexdigest()

    suffixes = {"m_ChunkData": "chk", "m_PosData": "pos", "m_OtherData": "oth",
                "m_ColorData": "col", "m_SHData": "shs"}
    refs = {}
    for field_key, suffix in suffixes.items():
        fname = f"{name}_{suffix}.bytes"
        path = os.path.join(folder, fname)
        if not os.path.exists(path):
            refs[field_key] = "{fileID: 0}"
            continue
        guid = file_guid(fname)
        refs[field_key] = f"{{fileID: 4900000, guid: {guid}, type: 3}}"
        with open(path + ".meta", "w") as f:
            f.write(
                "fileFormatVersion: 2\n"
                f"guid: {guid}\n"
                "TextScriptImporter:\n"
                "  externalObjects: {}\n"
                "  userData: \n"
                "  assetBundleName: \n"
                "  assetBundleVariant: \n"
            )

    cam_lines = []
    if asset.cameras:
        cam_lines.append("  m_Cameras:")
        for cam in asset.cameras:
            cam_lines.append(f"  - pos: {_fmt_vec3(cam['pos'])}")
            cam_lines.append(f"    axisX: {_fmt_vec3(cam['axis_x'])}")
            cam_lines.append(f"    axisY: {_fmt_vec3(cam['axis_y'])}")
            cam_lines.append(f"    axisZ: {_fmt_vec3(cam['axis_z'])}")
            cam_lines.append(f"    fov: {float(cam.get('fov', 25.0)):.9g}")
    else:
        cam_lines.append("  m_Cameras: []")

    doc = "\n".join(
        [
            "%YAML 1.1",
            "%TAG !u! tag:unity3d.com,2011:",
            "--- !u!114 &11400000",
            "MonoBehaviour:",
            "  m_ObjectHideFlags: 0",
            "  m_CorrespondingSourceObject: {fileID: 0}",
            "  m_PrefabInstance: {fileID: 0}",
            "  m_PrefabAsset: {fileID: 0}",
            "  m_GameObject: {fileID: 0}",
            "  m_Enabled: 1",
            "  m_EditorHideFlags: 0",
            "  m_Script: {fileID: 11500000, guid: "
            f"{GAUSSIAN_SPLAT_ASSET_SCRIPT_GUID}, type: 3}}",
            f"  m_Name: {name}",
            "  m_EditorClassIdentifier: ",
            f"  m_FormatVersion: {F.FORMAT_VERSION}",
            f"  m_SplatCount: {asset.splat_count}",
            f"  m_BoundsMin: {_fmt_vec3(asset.bounds_min)}",
            f"  m_BoundsMax: {_fmt_vec3(asset.bounds_max)}",
            "  m_DataHash:",
            "    serializedVersion: 2",
            f"    Hash: {asset.data_hash or '0' * 32}",
            f"  m_PosFormat: {int(asset.pos_format)}",
            f"  m_ScaleFormat: {int(asset.scale_format)}",
            f"  m_SHFormat: {int(asset.sh_format)}",
            f"  m_ColorFormat: {int(asset.color_format)}",
            f"  m_PosData: {refs['m_PosData']}",
            f"  m_ColorData: {refs['m_ColorData']}",
            f"  m_OtherData: {refs['m_OtherData']}",
            f"  m_SHData: {refs['m_SHData']}",
            f"  m_ChunkData: {refs['m_ChunkData']}",
        ]
        + cam_lines
    ) + "\n"
    asset_path = os.path.join(folder, f"{name}.asset")
    with open(asset_path, "w") as f:
        f.write(doc)
    return asset_path
