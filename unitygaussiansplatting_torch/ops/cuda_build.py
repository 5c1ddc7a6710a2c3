"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library, loaded with ``ctypes``.  Libraries go into
``build/cuda/`` beside the package (listed in ``.gitignore``), named by a
hash of the source and the flags, so an edited source is rebuilt at its next
use and an unchanged one is not.  Nothing is compiled at import: the first
wrapper call on a CUDA tensor (or :func:`build`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = (
    "pair_table.cu", "pair_expand.cu", "expand_probe.cu", "composite_fwd.cu", "composite_bwd.cu",
    "run_reduce.cu",
)

# --fmad=false: no multiply-add contraction, so every kernel rounds once per
# operation like its plain PyTorch version.  No --use_fast_math: it would
# swap expf/logf for the approximate intrinsics and flush denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point, by library.  Pointers and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int.
SIGNATURES = {
    "pair_table": {
        "pair_table_launch": (
            _I, [_P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _P, _L, _P, _L,
                 _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P],
        ),
        "pair_table_error_string": (ctypes.c_char_p, [_I]),
    },
    "pair_expand": {
        "expand_pairs_launch": (_I, [_P, _P, _I, _L, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P]),
        "expand_pairs_blocks_per_sm": (_I, []),
        "pair_expand_error_string": (ctypes.c_char_p, [_I]),
    },
    "expand_probe": {
        "expand_probe_launch": (_I, [_L, _I, _P, _P, _P]),
        "expand_probe_error_string": (ctypes.c_char_p, [_I]),
    },
    "composite_fwd": {
        "composite_fwd_launch": (
            _I, [_P, _L, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P, _I, _P, _P],
        ),
        "composite_fwd_cluster_size": (_I, [_I]),
        "composite_fwd_pixels_per_thread": (_I, [_I]),
        "composite_fwd_max_active_clusters": (_I, [_I, _I]),
        "composite_fwd_error_string": (ctypes.c_char_p, [_I]),
    },
    "composite_bwd": {
        "composite_bwd_launch": (
            _I, [_P, _L, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P, _I, _P, _P,
                 _P, _P, _P, _I, _I, _P, _P, _P],
        ),
        "composite_bwd_pixels_per_thread": (_I, [_I]),
        "composite_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
    "run_reduce": {
        "run_reduce_launch": (_I, [_P, _L, _I, _P, _I, _P, _P]),
        "run_reduce_error_string": (ctypes.c_char_p, [_I]),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns ``{source: (seconds, nvcc output)}`` for the
    ones built; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not library_path(s).exists()]
    nvcc = nvcc_path() if todo else None
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[src] = (proc, tmp, out)
    results, failures = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {src} failed (rc {proc.returncode}):\n{log}")
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        results[src] = (time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        source = f"{name}.cu"
        build((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if status != 0:
        msg = getattr(lib, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
