"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library, loaded with ``ctypes``; every function of its
``extern "C"`` block is typed from its declaration there
(:func:`c_signatures`), so a kernel's parameters are written once, in its
source.  Libraries go into
``build/cuda/`` beside the package (listed in ``.gitignore``), named by a
hash of the source, the headers of ``csrc/`` and the flags, so an edited
source or header is rebuilt at its next use and an unchanged one is not.
Nothing is compiled at import: the first wrapper call on a CUDA tensor (or
:func:`build`) does it.  Wrappers launch through :func:`launch`, which
counts each launch in :data:`launched`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = tuple(sorted(path.name for path in CSRC.glob("*.cu")))

# --fmad=false: no multiply-add contraction, so every kernel rounds once per
# operation like its plain PyTorch version.  No --use_fast_math: it would
# swap expf/logf for the approximate intrinsics and flush denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
    "-Xptxas", "-v",
)

# ctypes type of each C value type a parameter or return value may have.
# Any pointer parameter (the stream included) is c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int.
C_VALUE_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}

# Launches of every C entry point in this process, by name
# ("project_geom_launch", ...): counted by :func:`launch`.
launched: collections.Counter = collections.Counter()

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
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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


def _c_type(spelling: str, where: str, returned: bool = False):
    """The ctypes type of a C type: a pointer parameter is ``c_void_p``, a
    returned ``const char*`` is ``c_char_p``; anything else not in
    :data:`C_VALUE_TYPES` raises."""
    words = spelling.replace("*", " * ").split()
    if returned and words == ["const", "char", "*"]:
        return ctypes.c_char_p
    if not returned and "*" in words:
        return ctypes.c_void_p
    kind = C_VALUE_TYPES.get(" ".join(words))
    if kind is None:
        raise ValueError(f"{where} is {' '.join(words)!r}, which has no ctypes binding here")
    return kind


def _declarations(text: str, source: str) -> list[str]:
    """The head (return type, name, parameters) of every function defined
    at the top level of ``text``'s ``extern "C"`` block, comments removed."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", " ", text, flags=re.S)
    start = text.find('extern "C" {')
    if start < 0:
        raise ValueError(f'{source}: no extern "C" block')
    block = text[start + len('extern "C" {'):]
    heads, depth, head = [], 1, 0
    for i, ch in enumerate(block):
        if ch == "{":
            if depth == 1:
                heads.append(block[head:i])
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return heads
            head = i + 1
        elif ch == ";" and depth == 1:
            head = i + 1
    raise ValueError(f'{source}: the extern "C" block does not close')


def c_signatures(source: str) -> dict[str, tuple]:
    """``{function: (restype, argtypes)}`` of every function defined in the
    ``extern "C"`` block of ``csrc/<source>``, read from its declaration.

    Any pointer parameter is ``c_void_p``; ``int``, ``long long`` and
    ``float`` are their ctypes types, and ``const char*`` is a return type.
    Any other type raises, naming the file, the function and the
    parameter."""
    signatures = {}
    for head in _declarations((CSRC / source).read_text(), source):
        m = re.fullmatch(r"\s*(.*?)\b(\w+)\s*\(([^()]*)\)\s*", head, flags=re.S)
        if m is None:
            raise ValueError(f"{source}: cannot read the declaration {' '.join(head.split())!r}")
        ret, fn, params = m.groups()
        argtypes = []
        for param in filter(str.strip, params.split(",")):
            pm = re.fullmatch(r"\s*(.*?)\b(\w+)\s*", param, flags=re.S)
            if pm is None or not pm[1].strip():
                raise ValueError(f"{source}: {fn}: cannot read the parameter {' '.join(param.split())!r}")
            argtypes.append(_c_type(pm[1], f"{source}: {fn}: parameter {pm[2]}"))
        signatures[fn] = (_c_type(ret, f"{source}: {fn}: the return type", returned=True), argtypes)
    return signatures


def load(name: str, path: Path | None = None) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu`` from ``path`` (by default its
    build here, made first if needed), type its entry points from the
    source, and make it the one :func:`library` and :func:`launch` use.

    A ``path`` built with other ``-D`` flags serves as long as they leave
    the ``extern "C"`` signatures alone."""
    source = f"{name}.cu"
    if path is None:
        build((source,))
        path = library_path(source)
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in c_signatures(source).items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _loaded[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    return load(name) if lib is None else lib


def operand(x: torch.Tensor, name: str, shape: tuple, device, dtype=torch.float32) -> tuple:
    """``(data_ptr, *strides)`` of a kernel's input, after checking its
    shape, dtype and device (any strides are taken)."""
    if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be {shape} {dtype} on {device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.data_ptr(), *x.stride()


def launch(name: str, entry: str, device, *args) -> None:
    """Call the C entry point ``entry`` of ``csrc/<name>.cu`` with ``args``
    and ``device``'s current stream as its last argument, raise if it
    returned a CUDA error (a refused launch never runs, and a later
    synchronize would not report it), and count it in :data:`launched`."""
    lib = library(name)
    raise_for(name, entry, getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream))
    launched[entry] += 1


def raise_for(name: str, what: str, status: int) -> None:
    """Raise for ``what`` unless the CUDA status ``status`` is 0, with the
    runtime's message for it, read through ``csrc/<name>.cu``."""
    if status != 0:
        message = getattr(library(name), f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
