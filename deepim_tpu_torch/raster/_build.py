"""Build and bind the raster CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc``, all started together, and one
link makes a shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers, so the build takes seconds.  The library
lands in ``deepim_tpu_torch/_build/`` under a name keyed by the hash of
the sources and flags, so the first call after a source change rebuilds
it and every later call (and process) reuses it.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
#: Each entry point and its C signature (pointers as c_void_p, never cut to
#: 32 bits); every one returns a cudaError_t.
_ENTRIES = {
    # params, ids, starts, glob, rgb, depth, B, F, H, W, n_ids, n_glob, stream
    "deepim_raster_cols": [_ptr] * 6 + [_i32] * 6 + [_ptr],
    "deepim_raster_sorted": [_ptr] * 6 + [_i32] * 6 + [_ptr],
    # params, lists, counts, rgb, depth, B, F, H, W, K, stream
    "deepim_raster_topk": [_ptr] * 5 + [_i32] * 5 + [_ptr],
}
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class BuildInfo(NamedTuple):
    path: Path  # the shared library
    seconds: float  # nvcc wall time (compiles and link), 0.0 when reused
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [f"{tmp}/{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        so = f"{tmp}/lib.so"
        link = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(so, out)  # atomic: a concurrent loader sees all or nothing
    return BuildInfo(out, time.perf_counter() - t0, log)


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _i32
            lib.deepim_error_string.argtypes = [_i32]
            lib.deepim_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
