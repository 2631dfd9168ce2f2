"""PNG reading and writing with the standard library's ``zlib``, numpy and
a small C++ row unfilter.

The port's image IO.  The reference writes PNGs with PIL and reads them with
its native decoder or PIL (``deepim_tpu/data/lm6d.py:137-148`` ->
``native/src/deepim_native.cpp §dn_decode_png``); the port depends on
neither (the card's machine is not promised PIL) and carries its own codec.
:func:`write_png` writes the three image types the datasets use: 8-bit RGB
(colour frames), 8-bit grey (label maps) and 16-bit grey (depth in metres
x 1,000), every row with filter 0 (None).

:func:`read_png` reads every colour type and bit depth of the PNG
specification, interlaced (Adam7) or not, and returns what the
reference's ``LM6DDataset._read_image`` returns for the file (its native
decoder's arrays, and where that refuses, ``np.asarray(PIL.Image.open)``):

- grey: 8 bits (H, W) uint8, 16 bits (H, W) uint16, 2 and 4 bits scaled
  to 0..255, 1 bit (H, W) bool;
- RGB (H, W, 3), grey + alpha (H, W, 2), RGBA (H, W, 4), uint8; at 16 bits
  the high byte of each sample, and grey + alpha as RGBA (L, L, L, A);
- palette (1, 2, 4 or 8 bits): the (H, W) uint8 indices, not the colours
  (a palette ``label.png`` gives its label ids).

It reads all five row filters: PIL picks Sub, Up and Paeth per row, and
other encoders use Average.  ``zlib`` inflates; ``csrc/png_unfilter.cpp``
undoes the row filters (and swaps 16-bit samples to host order) and
reassembles the seven passes of an interlaced image.  It is built at
first use with ``g++ -O3 -shared -fPIC`` into ``deepim_tpu_torch/_build/``
under a name keyed by the hash of its source and flags, and bound with
``ctypes``, so a call runs without the GIL and a thread pool decodes frames
in parallel.  A failed build raises, naming the compiler's output; there is
no fallback.  :func:`unfilter_plain`, the same unfiltering as a Python row
loop, and :func:`adam7_plain`, the reassembly in numpy, are the plain
versions the tests hold the C++ ones to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB, _PALETTE, _GREY_ALPHA, _RGBA = 0, 2, 3, 4, 6
_CHANNELS = {_GREY: 1, _RGB: 3, _PALETTE: 1, _GREY_ALPHA: 2, _RGBA: 4}
_DEPTHS = {_GREY: (1, 2, 4, 8, 16), _RGB: (8, 16), _PALETTE: (1, 2, 4, 8),
           _GREY_ALPHA: (8, 16), _RGBA: (8, 16)}
# (x0, y0, dx, dy) of the seven Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))

UNFILTER_SRC = Path(__file__).resolve().parent / "csrc" / "png_unfilter.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of a uint8 (H, W, 3) or (H, W) image, or a uint16 (H, W)
    one (16-bit grey); every row filter 0, zlib's default level (6, as
    PIL's)."""
    a = np.asarray(image)
    if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        colour, depth = _RGB, 8
    elif a.dtype == np.uint8 and a.ndim == 2:
        colour, depth = _GREY, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        colour, depth = _GREY, 16
        a = a.astype(">u2")
    else:
        raise ValueError(f"no PNG type for a {a.dtype} image of shape {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``image`` to ``path`` (see :func:`encode_png`)."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def unfilter_plain(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` ((h, 1 + row_bytes) uint8) in
    Python rows: the plain version of the C++ unfilter."""
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"bad PNG row filter {int(kinds.max())}")
    out = np.empty((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        cur = raw[y, 1:]
        kind = kinds[y]
        if kind == 0:
            row = cur
        elif kind == 1:  # Sub: a running sum over each byte of the pixel
            row = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = cur + prior
        else:
            buf = bytearray(cur.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            row = np.frombuffer(buf, np.uint8)
        out[y] = row
        prior = out[y]
    return out


def build_library(src: Path, stem: str, flags: tuple[str, ...] = CXX_FLAGS,
                  libs: tuple[str, ...] = ()) -> Path:
    """Compile the C++ source ``src`` with ``flags``, linking ``libs`` (such
    as ``-lz``), into ``_build/{stem}_{hash}.so`` unless this exact build
    exists -> the shared library.  The hash covers the source, the flags
    and the libraries.  Concurrent builders (test workers) each compile
    into a temporary directory and rename atomically.  A failed build
    raises, naming the compiler's output."""
    h = hashlib.sha256(" ".join(flags + libs).encode() + src.read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = f"{tmp}/lib.so"
        try:
            proc = subprocess.run([cxx, *flags, "-o", so, str(src), *libs],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {cxx!r} to build "
                               f"{src.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(so, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_unfilter() -> Path:
    """``csrc/png_unfilter.cpp`` built by :func:`build_library`."""
    return build_library(UNFILTER_SRC, "libdeepim_png")


def _png_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_unfilter()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.deepim_png_unfilter.argtypes = [p, i64, i64, i32, i32, p]
            lib.deepim_png_unfilter.restype = ctypes.c_int
            lib.deepim_png_adam7.argtypes = [p, i64, i64, i64, i32, p]
            lib.deepim_png_adam7.restype = ctypes.c_int
            _lib = lib
        return _lib


def unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int,
             swap16: bool = False) -> np.ndarray:
    """Undo the per-row filters of ``raw`` ((h, 1 + row_bytes) uint8) with
    the C++ unfilter -> (h, row_bytes) uint8; ``swap16`` swaps each byte
    pair afterwards (big-endian 16-bit samples to host order)."""
    fn = _png_lib().deepim_png_unfilter
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, row_bytes), np.uint8)
    code = fn(raw.ctypes.data, h, row_bytes, bpp, int(swap16), out.ctypes.data)
    if code:
        y = -code - 1
        raise ValueError(f"bad PNG row filter {int(raw.reshape(h, -1)[y, 0])} in row {y}")
    return out


def _passes(w: int, h: int, bits_pp: int):
    """The non-empty Adam7 passes: (x0, y0, dx, dy, width, height, row bytes)."""
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw and ph:
            yield x0, y0, dx, dy, pw, ph, -(-pw * bits_pp // 8)


def _unpack(rows: np.ndarray, width: int, bits: int) -> np.ndarray:
    """Rows of packed 1-, 2- or 4-bit samples (most significant first)
    -> (rows, width) uint8 sample values."""
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
    return samples.reshape(rows.shape[0], -1)[:, :width]


def adam7_plain(raw: np.ndarray, w: int, h: int, bits_pp: int) -> np.ndarray:
    """The seven passes of an interlaced image's inflated data, unfiltered
    by :func:`unfilter_plain` and put in place with numpy -> (h, w, bytes a
    pixel) uint8 (for ``bits_pp`` < 8, (h, w, 1) samples): the plain
    version of the C++ reassembly."""
    px = max(bits_pp // 8, 1)
    out = np.zeros((h, w, px), np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, row_bytes in _passes(w, h, bits_pp):
        n = ph * (row_bytes + 1)
        if pos + n > raw.size:
            raise ValueError("interlaced PNG image data has the wrong size")
        rows = unfilter_plain(raw[pos:pos + n].reshape(ph, row_bytes + 1), ph, row_bytes,
                              px)
        pos += n
        pix = (_unpack(rows, pw, bits_pp)[..., None] if bits_pp < 8
               else rows.reshape(ph, pw, px))
        out[y0::dy, x0::dx] = pix
    if pos != raw.size:
        raise ValueError("interlaced PNG image data has the wrong size")
    return out


def adam7(raw: np.ndarray, w: int, h: int, bits_pp: int) -> np.ndarray:
    """:func:`adam7_plain` with the C++ reassembly (16-bit samples stay
    big-endian)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, w, max(bits_pp // 8, 1)), np.uint8)
    code = _png_lib().deepim_png_adam7(raw.ctypes.data, raw.size, w, h, bits_pp,
                                       out.ctypes.data)
    if code == -1000000:
        raise ValueError("interlaced PNG image data has the wrong size")
    if code:
        raise ValueError(f"bad PNG row filter in interlaced row {-code - 1}")
    return out


def _as_pil(pix: np.ndarray, colour: int, depth: int) -> np.ndarray:
    """Pixels (h, w, bytes a pixel; 16-bit samples big-endian; sub-byte
    samples one a byte) -> the array ``np.asarray(PIL.Image.open(...))``
    gives for the file."""
    h, w = pix.shape[:2]
    if depth < 8:
        s = pix.reshape(h, w)
        if colour == _PALETTE:
            return s
        return s.astype(bool) if depth == 1 else s * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16:
        if colour == _GREY:
            return pix.view(">u2").astype(np.uint16).reshape(h, w)
        pix = pix[..., 0::2]  # the high byte of each sample
        if colour == _GREY_ALPHA:
            pix = pix[..., [0, 0, 0, 1]]
    return pix.reshape(h, w) if pix.shape[2] == 1 else np.ascontiguousarray(pix)


def decode_png(data: bytes, plain: bool = False) -> np.ndarray:
    """PNG bytes -> the array of the module docstring's table.  ``plain``
    unfilters with :func:`unfilter_plain` and reassembles with
    :func:`adam7_plain` (for the tests and timings that hold the C++ code
    to them)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    # Slices of a memoryview copy nothing, and zlib inflates into a buffer
    # of the exact size: what a decoding thread does holding the GIL is
    # kept short, since the GIL is what the thread launching the
    # refinement's kernels waits for.
    view = memoryview(data)
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", view[pos:pos + 4])
        kind = bytes(view[pos + 4:pos + 8])
        body = view[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth not in _DEPTHS.get(colour, ()):
        raise ValueError(f"unsupported PNG: colour type {colour}, bit depth {depth}")
    if interlace > 1:
        raise ValueError(f"unknown PNG interlace method {interlace}")
    bits_pp = _CHANNELS[colour] * depth
    row_bytes = -(-w * bits_pp // 8)
    size = (sum(ph * (rb + 1) for *_, ph, rb in _passes(w, h, bits_pp)) if interlace
            else h * (row_bytes + 1))
    try:
        stream = idat[0] if len(idat) == 1 else b"".join(idat)
        raw = np.frombuffer(zlib.decompress(stream, bufsize=max(size, 1)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt or truncated PNG image data: {e}") from e
    if raw.size != size:
        raise ValueError("PNG image data has the wrong size")
    if colour == _GREY and depth == 16 and not interlace:  # depth maps: swapped in C++
        if plain:
            rows = unfilter_plain(raw.reshape(h, row_bytes + 1), h, row_bytes, 2)
            return rows.view(">u2").astype(np.uint16).reshape(h, w)
        return unfilter(raw, h, row_bytes, 2, swap16=np.little_endian).view(np.uint16).reshape(h, w)
    px = max(bits_pp // 8, 1)
    if interlace:
        pix = adam7_plain(raw, w, h, bits_pp) if plain else adam7(raw, w, h, bits_pp)
    else:
        rows = (unfilter_plain(raw.reshape(h, row_bytes + 1), h, row_bytes, px) if plain
                else unfilter(raw, h, row_bytes, px))
        pix = (_unpack(rows, w, bits_pp)[..., None] if bits_pp < 8
               else rows.reshape(h, w, px))
    return _as_pil(pix, colour, depth)


def read_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG file, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def read_png(path: str) -> np.ndarray:
    """Read a PNG file (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read())
