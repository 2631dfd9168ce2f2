"""PNG reading and writing with the standard library's ``zlib`` and numpy.

The port's image IO.  The reference writes PNGs with PIL and reads them with
its native decoder or PIL (``deepim_tpu/data/lm6d.py:137-148``); the port
depends on neither (the card's machine is not promised PIL) and carries
its own codec for the three image types the datasets use:

- 8-bit RGB (colour frames), 8-bit grey (label maps),
- 16-bit grey, big-endian (depth in metres x 1,000).

:func:`write_png` writes every row with filter 0 (None).  :func:`read_png`
reads all five row filters: PIL picks Sub, Up and Paeth per row, and other
encoders use Average.  None, Sub and Up are whole-row numpy operations;
Average and Paeth depend on the pixel to their left and are undone one
row at a time in a Python loop, which is slow on large images written by
others (reading real datasets fast is left to the loaders that need it).
Interlaced, palette and alpha images raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB = 0, 2
_CHANNELS = {_GREY: 1, _RGB: 3}


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


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` ((h, 1 + row_bytes) uint8)."""
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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) or (H, W), or uint16 (H, W) for 16-bit
    grey."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
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
    if colour not in _CHANNELS or depth not in (8, 16) or (colour == _RGB and depth != 8):
        raise ValueError(f"unsupported PNG: colour type {colour}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    bpp = _CHANNELS[colour] * depth // 8
    row_bytes = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (row_bytes + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = _unfilter(raw.reshape(h, row_bytes + 1), h, row_bytes, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    return rows.reshape(h, w, 3) if colour == _RGB else rows.reshape(h, w)


def read_png(path: str) -> np.ndarray:
    """Read a PNG file (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read())
