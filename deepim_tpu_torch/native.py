"""The port's native host runtime: ``csrc/deepim_native.cpp`` bound with ctypes.

Port of ``deepim_tpu/native.py``, with its public names and returns:
:func:`load_ply`, :func:`load_obj`, :func:`vertex_normals`,
:func:`sample_points`, :func:`decimate`, :func:`decode_png` and
:class:`PrefetchReader`.  The C++ source is the port's own copy of the
reference's ``native/src/deepim_native.cpp``; it is built at first use by
:func:`deepim_tpu_torch.data.png.build_library` with the reference's flags
(``-O2 -std=c++17 -fPIC``, so float sums round as the reference's do),
linked with ``-lz -lpthread``, into ``deepim_tpu_torch/_build/`` under
``libdeepim_host_<hash>.so``.  ``CXX`` overrides the compiler.

The routing is the reference's, so that the port's default path is the
reference's default path:

- ``raster/mesh.py``: vertex normals and the decimation of untextured
  meshes from ``_NATIVE_MIN_FACES`` (20,000) faces up, the parsing of
  untextured PLY files and of single-material OBJ files;
- ``data/lm6d.py``: every PNG of a frame (``LM6DDataset._read_image``,
  the streamed loaders, ``load_frames_prefetched`` with the prefetcher) and
  ``data/video.py``'s frames.

There is no ``available()``: a failed build raises, naming the compiler's
output, and no path goes on in Python when the library cannot build.  A
function returns ``None`` only where the C++ itself refuses an input (a
PNG type it does not take, a truncated or malformed file); there, and for
an OBJ of several materials, the caller's Python path stands in, as the
reference's fallback does.

Plain versions, which the tests and ``chip_smoke.py`` hold the C++ to:
``mesh.compute_vertex_normals``, ``mesh.decimate_mesh``, ``mesh.load_ply``
and ``mesh.load_obj`` with ``plain=True`` (the reference's numpy and Python
paths), ``png.decode_png(data, plain=True)``, ``open(path, "rb").read()``
for the prefetcher, and :func:`sample_points_plain`, the numpy twin of the
C++ xorshift sampler.  ``sample_points`` stays off the seeded point-matching
protocol, as in the reference (``mesh.sample_points`` is numpy).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "deepim_native.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_handle = None

_pf = ctypes.POINTER(ctypes.c_float)
_pi = ctypes.POINTER(ctypes.c_int32)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_i32, _i64 = ctypes.c_int32, ctypes.c_int64


def build() -> Path:
    """``csrc/deepim_native.cpp`` built by ``png.build_library`` -> the
    shared library (raises when the compiler fails)."""
    from deepim_tpu_torch.data.png import build_library

    return build_library(SRC, "libdeepim_host", FLAGS, LIBS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ref = ctypes.POINTER
    signatures = {
        "dn_free": ([ctypes.c_void_p], None),
        "dn_load_ply": ([ctypes.c_char_p, ref(_pf), ref(_pf), ref(_pi), ref(_i64),
                         ref(_i64)], ctypes.c_int),
        "dn_load_obj": ([ctypes.c_char_p, ref(_pf), ref(_pf), ref(_pf), ref(_pi),
                         ref(ctypes.c_char_p), ref(_i64), ref(_i64), ref(_i32),
                         ref(_i32)], ctypes.c_int),
        "dn_vertex_normals": ([_pf, _i64, _pi, _i64, _pf], None),
        "dn_sample_points": ([_pf, _i64, _pi, _i64, _i64, ctypes.c_uint64, _pf], None),
        "dn_decimate": ([_pf, _pf, _i64, _pi, _i64, _i64, ref(_pf), ref(_pf), ref(_pi),
                         ref(_i64), ref(_i64)], ctypes.c_int),
        "dn_decode_png": ([_pu8, _i64, ref(_pu8), ref(_i32), ref(_i32), ref(_i32),
                           ref(_i32)], ctypes.c_int),
        "dn_prefetch_create": ([ref(ctypes.c_char_p), _i64, _i32, _i32], ctypes.c_void_p),
        "dn_prefetch_next": ([ctypes.c_void_p, ref(_pu8), ref(_i64)], _i64),
        "dn_prefetch_free": ([ctypes.c_void_p], None),
    }
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _lib() -> ctypes.CDLL:
    global _handle
    with _lock:
        if _handle is None:
            _handle = _bind(ctypes.CDLL(str(build())))
        return _handle


def _take(lib, ptr, n: int, dtype) -> np.ndarray:
    """Copy ``n`` elements out of a malloc'd C buffer and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype) if n else np.zeros(0, dtype)
    lib.dn_free(ptr)
    return arr


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _faces(f) -> np.ndarray:
    return np.ascontiguousarray(f, np.int32)


def load_ply(path: str):
    """-> (vertices (V, 3) f32, colors (V, 3) f32, faces (F, 3) i32), or
    None where the C++ refuses the file (truncated, big endian, not PLY)."""
    lib = _lib()
    pv, pc, pfc = _pf(), _pf(), _pi()
    nv, nf = _i64(), _i64()
    if lib.dn_load_ply(str(path).encode(), ctypes.byref(pv), ctypes.byref(pc),
                       ctypes.byref(pfc), ctypes.byref(nv), ctypes.byref(nf)):
        return None
    return (_take(lib, pv, nv.value * 3, np.float32).reshape(-1, 3),
            _take(lib, pc, nv.value * 3, np.float32).reshape(-1, 3),
            _take(lib, pfc, nf.value * 3, np.int32).reshape(-1, 3))


def load_obj(path: str):
    """-> (vertices (V, 3) f32, colors (V, 3) f32, uvs (V, 2) f32 or None,
    faces (F, 3) i32, mtllib file name or None, number of materials), or
    None where the C++ refuses the file.

    Geometry only (C++ §dn_load_obj): v/vt/f with (position, uv) corner
    dedup, fan triangulation, negative indices.  Materials (the MTL file,
    texture baking) stay with the caller.
    """
    lib = _lib()
    pv, pc, puv, pfc = _pf(), _pf(), _pf(), _pi()
    pmtl = ctypes.c_char_p()
    nv, nf, has_uv, nmat = _i64(), _i64(), _i32(), _i32()
    if lib.dn_load_obj(str(path).encode(), ctypes.byref(pv), ctypes.byref(pc),
                       ctypes.byref(puv), ctypes.byref(pfc), ctypes.byref(pmtl),
                       ctypes.byref(nv), ctypes.byref(nf), ctypes.byref(has_uv),
                       ctypes.byref(nmat)):
        return None
    v = _take(lib, pv, nv.value * 3, np.float32).reshape(-1, 3)
    c = _take(lib, pc, nv.value * 3, np.float32).reshape(-1, 3)
    uv = _take(lib, puv, nv.value * 2, np.float32).reshape(-1, 2)
    f = _take(lib, pfc, nf.value * 3, np.int32).reshape(-1, 3)
    mtllib = None
    if pmtl.value is not None:
        mtllib = pmtl.value.decode()
        lib.dn_free(pmtl)
    return v, c, uv if has_uv.value else None, f, mtllib, int(nmat.value)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals (V, 3) float32."""
    v, f = _f32(vertices), _faces(faces)
    out = np.zeros_like(v)
    _lib().dn_vertex_normals(v.ctypes.data_as(_pf), len(v), f.ctypes.data_as(_pi), len(f),
                             out.ctypes.data_as(_pf))
    return out


def sample_points(vertices: np.ndarray, faces: np.ndarray, n: int, seed: int = 0):
    """``n`` area-weighted surface points (n, 3) float32 from the C++
    xorshift stream (seed 0 is seed 1), or None with no faces or n <= 0."""
    lib = _lib()
    if len(faces) == 0 or n <= 0:
        return None
    v, f = _f32(vertices), _faces(faces)
    out = np.zeros((n, 3), np.float32)
    lib.dn_sample_points(v.ctypes.data_as(_pf), len(v), f.ctypes.data_as(_pi), len(f), n,
                         seed or 1, out.ctypes.data_as(_pf))
    return out


_MASK64 = (1 << 64) - 1


def sample_points_plain(vertices: np.ndarray, faces: np.ndarray, n: int, seed: int = 0):
    """:func:`sample_points` in numpy and Python integers, bit for bit: the
    plain version of C++ §dn_sample_points (float32 cross products, a
    float64 running area sum, the first face whose sum reaches the draw,
    float64 barycentric weights)."""
    if len(faces) == 0 or n <= 0:
        return None
    v, f = _f32(vertices), _faces(faces)
    v0, v1, v2 = (v[f[:, i]] for i in range(3))
    cr = np.cross(v1 - v0, v2 - v0).astype(np.float64)
    cdf = np.cumsum(0.5 * np.sqrt(cr[:, 0] * cr[:, 0] + cr[:, 1] * cr[:, 1]
                                  + cr[:, 2] * cr[:, 2]))
    s = seed or 1
    draws = np.empty(3 * n, np.uint64)
    for i in range(3 * n):
        s ^= (s << 13) & _MASK64
        s ^= s >> 7
        s ^= (s << 17) & _MASK64
        draws[i] = s
    r = (draws >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)
    u, r1, r2 = r[0::3] * cdf[-1], r[1::3], r[2::3]
    idx = np.minimum(np.searchsorted(cdf, u, side="left"), len(f) - 1)
    sq = np.sqrt(r1)
    w0, w1, w2 = 1.0 - sq, sq * (1.0 - r2), sq * r2
    pts = (w0[:, None] * v0[idx].astype(np.float64) + w1[:, None] * v1[idx].astype(np.float64)
           + w2[:, None] * v2[idx].astype(np.float64))
    return pts.astype(np.float32)


def decimate(vertices: np.ndarray, colors: np.ndarray, faces: np.ndarray, max_faces: int):
    """Vertex-clustering decimation -> (v, c, f), or None when the mesh has
    at most ``max_faces`` faces or no grid resolution brings it under."""
    lib = _lib()
    v, c, f = _f32(vertices), _f32(colors), _faces(faces)
    pv, pc, pfc = _pf(), _pf(), _pi()
    nv, nf = _i64(), _i64()
    if lib.dn_decimate(v.ctypes.data_as(_pf), c.ctypes.data_as(_pf), len(v),
                       f.ctypes.data_as(_pi), len(f), max_faces, ctypes.byref(pv),
                       ctypes.byref(pc), ctypes.byref(pfc), ctypes.byref(nv),
                       ctypes.byref(nf)):
        return None
    return (_take(lib, pv, nv.value * 3, np.float32).reshape(-1, 3),
            _take(lib, pc, nv.value * 3, np.float32).reshape(-1, 3),
            _take(lib, pfc, nf.value * 3, np.int32).reshape(-1, 3))


def decode_png(data: bytes):
    """PNG bytes -> (H, W, C) uint8, (H, W) uint8 grey or (H, W) uint16, in
    one call that holds no GIL (inflate and unfilter); None for a PNG the
    C++ refuses (palette, sub-byte or 16-bit colour, interlaced, corrupt)."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    pout = _pu8()
    w, h, ch, depth = _i32(), _i32(), _i32(), _i32()
    if lib.dn_decode_png(buf.ctypes.data_as(_pu8), len(buf), ctypes.byref(pout),
                         ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
                         ctypes.byref(depth)):
        return None
    raw = _take(lib, pout, h.value * w.value * ch.value * (depth.value // 8), np.uint8)
    if depth.value == 16:
        return raw.view(np.uint16).reshape(h.value, w.value)
    if ch.value == 1:
        return raw.reshape(h.value, w.value)
    return raw.reshape(h.value, w.value, ch.value)


class PrefetchReader:
    """Threaded in-order file reader (C++ worker threads, a bounded window).

    Iterating yields ``(index, bytes)`` in the order of ``paths``, with
    ``None`` for a file that cannot be read; at most ``capacity`` files wait
    ahead of the one being delivered.  :meth:`close` (idempotent; also on
    leaving a ``with`` block) stops the threads and frees what is unread.

    >>> with PrefetchReader(paths, num_threads=4) as reader:
    ...     for idx, data in reader:
    ...         img = decode_png(data)
    """

    def __init__(self, paths: list[str], num_threads: int = 4, capacity: int = 16):
        self._lib = _lib()
        encoded = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        self._handle = self._lib.dn_prefetch_create(arr, len(encoded), num_threads, capacity)
        self._closed = False

    def __iter__(self):
        while True:
            if self._closed:
                raise ValueError("PrefetchReader is closed")
            pout = _pu8()
            n = _i64()
            idx = self._lib.dn_prefetch_next(self._handle, ctypes.byref(pout),
                                             ctypes.byref(n))
            if idx < 0:
                return
            if n.value < 0:
                yield int(idx), None
                continue
            data = ctypes.string_at(pout, n.value)
            self._lib.dn_free(pout)
            yield int(idx), data

    def close(self):
        if not self._closed:
            self._closed = True
            self._lib.dn_prefetch_free(self._handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_closed", True) is False:
            self.close()
