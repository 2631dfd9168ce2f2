"""Build and bind the crop-raster CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``: no PyTorch headers, so the build takes
seconds.  The library lands in ``deepim_tpu_torch/_build/`` under a name
keyed by the hash of the sources and flags, so the first call after a
source change rebuilds it and every later call (and process) reuses it.
Nothing happens at import: :func:`load` builds on first use.  A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ENTRIES = ("deepim_raster_cols", "deepim_raster_sorted")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class BuildInfo(NamedTuple):
    path: Path  # the shared library
    seconds: float  # nvcc wall time, 0.0 when an existing build was reused
    log: str  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``_build/`` unless this exact build exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libdeepim_raster_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return BuildInfo(out, seconds, log)


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in _ENTRIES:
                fn = getattr(lib, name)
                # params, ids, starts, glob, rgb, depth, B, F, H, W, n_ids,
                # n_glob, stream -> cudaError_t
                fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
                fn.restype = i32
            lib.deepim_error_string.argtypes = [i32]
            lib.deepim_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
