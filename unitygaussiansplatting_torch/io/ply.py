"""PLY import/export for 3D Gaussian splat files.

The port of ``unitygaussiansplatting_tpu/io/ply.py`` (numpy, as there; files
byte-identical to its).  Equivalent of the reference's PLY path: header parse + raw blob read
(package/Editor/Utils/PLYFileReader.cs:25-114), property remap and planar ->
interleaved SH reorder (package/Editor/Utils/GaussianFileReader.cs:80-208),
activation/linearization (GaussianFileReader.cs:210-240), and the 62-property
export writer (package/Editor/GaussianSplatRendererEditor.cs:394-445).

numpy structured arrays replace the reference's Burst reorder jobs — the
import path is IO-bound, one-shot, and stays off-device.
"""

from __future__ import annotations

import numpy as np

from .asset import InputSplats, pack_smallest3_np, unpack_smallest3_np

_PLY_TYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}

SH_COEFFS = 15


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def read_ply_header(f) -> tuple[int, np.dtype, int]:
    """Parse a binary little-endian PLY header; returns (count, dtype, offset)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = f.readline().strip()
    if b"binary_little_endian" not in fmt:
        raise ValueError(f"only binary little-endian PLY supported, got {fmt!r}")
    count = 0
    fields = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.strip().decode().split()
        if not parts:
            continue
        if parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            fields.append((parts[2], "<" + _PLY_TYPES[parts[1]]))
        elif parts[0] == "end_header":
            break
    return count, np.dtype(fields), f.tell()


def read_ply(path_or_file) -> InputSplats:
    """Read a 3DGS PLY and linearize to canonical splats.

    Accepts the standard 62-float layout (x/y/z, normals, f_dc_*, f_rest_*,
    opacity, scale_*, rot_*); extra properties are ignored.  SH f_rest is
    planar (15R,15G,15B) and is interleaved to (15, 3)
    (GaussianFileReader.cs:185-208).
    """
    if isinstance(path_or_file, (str, bytes)):
        f = open(path_or_file, "rb")
        close = True
    else:
        f = path_or_file
        close = False
    try:
        count, dtype, _ = read_ply_header(f)
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
    finally:
        if close:
            f.close()

    names = set(data.dtype.names)
    required = {"x", "y", "z", "opacity", "scale_0", "rot_0"}
    missing = required - names
    if missing:
        raise ValueError(f"PLY missing required splat properties: {sorted(missing)}")

    g = lambda k: data[k].astype(np.float32)
    pos = np.stack([g("x"), g("y"), g("z")], axis=-1)
    log_scale = np.stack([g("scale_0"), g("scale_1"), g("scale_2")], axis=-1)
    rot_wxyz = np.stack([g("rot_0"), g("rot_1"), g("rot_2"), g("rot_3")], axis=-1)
    dc0 = np.stack([g("f_dc_0"), g("f_dc_1"), g("f_dc_2")], axis=-1)
    opacity_raw = g("opacity")

    sh = np.zeros((count, SH_COEFFS, 3), np.float32)
    if "f_rest_0" in names:
        n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
        per_ch = n_rest // 3
        rest = np.stack([g(f"f_rest_{i}") for i in range(n_rest)], axis=-1)
        # planar (ch-major) -> interleaved [coeff][rgb]
        planar = rest.reshape(count, 3, per_ch)
        sh[:, :per_ch, :] = planar.transpose(0, 2, 1)[:, :SH_COEFFS]

    # Linearization (GaussianFileReader.cs:210-240).
    norm = np.linalg.norm(rot_wxyz, axis=-1, keepdims=True)
    q = rot_wxyz / np.maximum(norm, 1e-12)
    q_xyzw = np.concatenate([q[:, 1:4], q[:, 0:1]], axis=-1)
    rot_packed = pack_smallest3_np(q_xyzw)
    scale = np.abs(np.exp(log_scale))
    color = dc0 * 0.2820948 + 0.5
    opacity = _sigmoid(opacity_raw)

    return InputSplats(
        pos=pos,
        rot=rot_packed.astype(np.float32),
        scale=scale.astype(np.float32),
        color=color.astype(np.float32),
        opacity=opacity.astype(np.float32),
        sh=sh,
    )


def write_ply(path_or_file, splats: InputSplats) -> None:
    """Export canonical splats as a standard 62-property 3DGS PLY.

    Applies the inverse activations the reference's export kernel does
    (SplatUtilities.compute:616-673 + GaussianSplatRendererEditor.cs:394-445):
    InvSigmoid opacity, log scale, color -> DC coefficient, smallest-three ->
    wxyz quaternion, SH interleaved -> planar.
    """
    n = splats.count
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(45)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    dtype = np.dtype([(nm, "<f4") for nm in names])
    out = np.zeros(n, dtype=dtype)
    out["x"], out["y"], out["z"] = splats.pos.T

    dc0 = (splats.color - 0.5) / 0.2820948
    for i in range(3):
        out[f"f_dc_{i}"] = dc0[:, i]
    planar = splats.sh.transpose(0, 2, 1).reshape(n, 45)  # interleaved -> planar
    for i in range(45):
        out[f"f_rest_{i}"] = planar[:, i]
    op = np.clip(splats.opacity, 1e-7, 1 - 1e-7)
    out["opacity"] = np.log(op / (1 - op))
    log_scale = np.log(np.maximum(splats.scale, 1e-37))
    for i in range(3):
        out[f"scale_{i}"] = log_scale[:, i]
    q_xyzw = unpack_smallest3_np(splats.rot)
    wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=-1)
    for i in range(4):
        out[f"rot_{i}"] = wxyz[:, i]

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {nm}\n" for nm in names)
        + "end_header\n"
    ).encode()

    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "wb") as f:
            f.write(header)
            f.write(out.tobytes())
    else:
        path_or_file.write(header)
        path_or_file.write(out.tobytes())
