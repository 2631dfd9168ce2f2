"""Public-release fixtures: a generated LM6d root re-laid out as each release
the converters read, in that release's own layout and units, plus a
minimal baseline JPEG encoder to write their ``.jpg`` frames.

No LINEMOD, BOP or YCB-Video files are in the repository; these writers
stand in for them.  They need numpy and scipy only (no PIL), so the CPU
tests and ``chip_smoke.py`` (on a machine without PIL) share them:

- :func:`encode_jpeg`: baseline JPEG (SOF0) with the standard tables of
  ITU-T T.81 Annex K (quality scaling as libjpeg's), 4:4:4, 4:2:2 or 4:2:0
  and grey, restart markers on request.  Used only to write fixtures.
- :func:`encode_jpeg_progressive`: the same coefficients as a progressive
  JPEG (SOF2) in libjpeg's default scan script (DC first and refine, AC
  first with EOB runs, two AC refinements of luma, one of chroma).
- :func:`encode_png_raw`: any PNG colour type and bit depth, Adam7
  interlaced on request, rows filtered with each of the five filters.
- :func:`write_bop_release`: BOP JSON (``scene_gt.json``, mm,
  ``depth_scale``, ``mask_visib``) or SIXD YAML (``gt.yml``/``info.yml``).
- :func:`write_lm_original_release`: the ACCV'12 LINEMOD release
  (``color{i}.jpg``, ``.dpt`` in mm, ``.rot``, ``.tra`` in cm, ``mesh.ply``
  in mm).
- :func:`write_ycb_original_release`: the original YCB-Video release
  (``-meta.mat`` with 1-based global class ids, ``factor_depth`` 10000,
  global-id labels, ``image_sets/keyframe.txt`` and ``classes.txt``).
- ``compare_*``: a converted root against the generated one it came from.

The tests at the bottom hold the writers to PIL (and scipy): PIL reads
every file they write, and decodes the encoder's JPEGs to the pixels the
port's decoder gives.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import zlib

import numpy as np

# -- a baseline JPEG encoder (fixtures only) ---------------------------------------

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1: the luminance and chrominance quantization tables, row-major
Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
Q_CHROMA = np.full(64, 99)
Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3: the typical Huffman tables (code-length counts, values)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
    0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
    0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
    0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
    0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}  # luma (h, v)

_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _scaled(table: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255)


def _codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a table -> (code, length) indexed by symbol."""
    counts, vals = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """A plane edge-padded to (bh * 8, bw * 8) -> (bh, bw, 8, 8) blocks."""
    p = np.pad(plane, ((0, bh * 8 - plane.shape[0]), (0, bw * 8 - plane.shape[1])), "edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Items of (value, bit length), MSB first, padded with 1 bits to a byte,
    0x00 stuffed after every 0xFF."""
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    item = np.repeat(np.arange(lens.size), lens)
    shift = lens[item] - 1 - (np.arange(total) - starts[item])
    bits = ((vals[item] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _coefficients(image: np.ndarray, quality: int, subsampling: str):
    """The quantized DCT coefficients of an image -> (sampling factors,
    MCUs across, MCUs down, quantization tables, per component its
    (my, mx, v, h, 64) zigzag-ordered blocks)."""
    img = np.asarray(image, np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
        hv = [(1, 1)]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        hv = [SAMPLING[subsampling], (1, 1), (1, 1)]
    hmax, vmax = hv[0]
    mx_n, my_n = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qts = [_scaled(Q_LUMA, quality), _scaled(Q_CHROMA, quality)]
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]

    comp_blocks = []  # per component: (my, mx, v, h, 64) zigzag coefficients
    for ci, (plane, (ch, cv)) in enumerate(zip(planes, hv)):
        fh, fv = hmax // ch, vmax // cv
        ph, pw = my_n * 8 * vmax, mx_n * 8 * hmax
        p = np.pad(np.round(plane), ((0, ph - h), (0, pw - w)), "edge")
        p = p.reshape(ph // fv, fv, pw // fh, fh).mean(axis=(1, 3))
        blk = _blocks(p - 128.0, my_n * cv, mx_n * ch)
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, blk, _DCT).reshape(my_n * cv, mx_n * ch, 64)
        q = np.round(coef / qts[min(ci, 1)]).astype(np.int64)[..., NATURAL]
        comp_blocks.append(q.reshape(my_n, cv, mx_n, ch, 64).transpose(0, 2, 1, 3, 4))
    return hv, mx_n, my_n, qts, comp_blocks


def _headers(h: int, w: int, hv, qts, sof: int) -> bytearray:
    """SOI, JFIF, the quantization tables and the frame header."""
    out = bytearray(b"\xff\xd8")
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq in range(min(len(hv), 2)):
        zz = qts[tq][NATURAL]
        out += _marker(0xDB, bytes([tq]) + bytes(zz.astype(np.uint8).tolist()))
    body = struct.pack(">BHHB", 8, h, w, len(hv))
    for ci, (ch, cv) in enumerate(hv):
        body += bytes([ci + 1, ch * 16 + cv, min(ci, 1)])
    return out + _marker(sof, body)


def _marker(m: int, body: bytes) -> bytes:
    return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(image: np.ndarray, quality: int = 90, subsampling: str = "4:2:0",
                restart: int = 0) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) grey -> baseline JPEG bytes (JFIF, one
    interleaved scan, Annex K tables scaled to ``quality``; ``restart``
    MCUs a restart interval, 0 for none)."""
    hv, mx_n, my_n, qts, comp_blocks = _coefficients(image, quality, subsampling)
    h, w = np.asarray(image).shape[:2]
    planes = hv
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]

    # every block in scan order: MCU by MCU, then component, then block row, column
    order = np.concatenate([cb.reshape(my_n * mx_n, -1, 64) for cb in comp_blocks], axis=1)
    per_mcu = order.shape[1]
    comp_of = np.concatenate([np.full(cv * ch, ci) for ci, (ch, cv) in enumerate(hv)])
    blocks = order.reshape(-1, 64)
    comp = np.tile(comp_of, my_n * mx_n)
    mcu = np.repeat(np.arange(my_n * mx_n), per_mcu)
    interval = mcu // restart if restart else np.zeros_like(mcu)

    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for ci in range(len(planes)):
        idx = np.flatnonzero(comp == ci)
        prev = np.concatenate([[0], dc[idx[:-1]]])
        prev[np.concatenate([[True], interval[idx[1:]] != interval[idx[:-1]]])] = 0
        diff[idx] = dc[idx] - prev

    def size_bits(v):
        size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
        return size, np.where(v < 0, v + (1 << size) - 1, v)

    tsel = np.minimum(comp, 1)
    keys, vals, lens = [], [], []
    s, bits = size_bits(diff)
    dcode = np.stack([tables[0][0][0], tables[1][0][0]])
    dlen = np.stack([tables[0][0][1], tables[1][0][1]])
    keys.append(np.arange(len(blocks)) * 257)
    vals.append((dcode[tsel, s] << s) | bits)
    lens.append(dlen[tsel, s] + s)

    acode = np.stack([tables[0][1][0], tables[1][1][0]])
    alen = np.stack([tables[0][1][1], tables[1][1][1]])
    b_i, k_i = np.nonzero(blocks[:, 1:])
    k_i = k_i + 1
    first = np.concatenate([[True], b_i[1:] != b_i[:-1]])
    prev_k = np.where(first, 0, np.concatenate([[0], k_i[:-1]]))
    run = k_i - prev_k - 1
    v = blocks[b_i, k_i]
    s, bits = size_bits(v)
    rs = (run % 16) * 16 + s
    t = tsel[b_i]
    keys.append(b_i * 257 + 4 * k_i + 3)
    vals.append((acode[t, rs] << s) | bits)
    lens.append(alen[t, rs] + s)
    for z in range(3):  # ZRL (16 zeros) before a run of 16 or more
        m = run // 16 > z
        keys.append(b_i[m] * 257 + 4 * k_i[m] + z)
        vals.append(acode[t[m], 0xF0])
        lens.append(alen[t[m], 0xF0])
    last = np.zeros(len(blocks), np.int64)
    np.maximum.at(last, b_i, k_i)
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 257 + 256)
    vals.append(acode[tsel[eob], 0x00])
    lens.append(alen[tsel[eob], 0x00])

    keys, vals, lens = map(np.concatenate, (keys, vals, lens))
    o = np.argsort(keys, kind="stable")
    keys, vals, lens = keys[o], vals[o], lens[o]
    item_interval = interval[keys // 257]
    scan = bytearray()
    bounds = np.searchsorted(item_interval, np.arange(item_interval.max() + 2))
    for i in range(len(bounds) - 1):
        if i:
            scan += bytes([0xFF, 0xD0 + ((i - 1) & 7)])
        scan += _pack(vals[bounds[i]:bounds[i + 1]], lens[bounds[i]:bounds[i + 1]])

    out = _headers(h, w, hv, qts, 0xC0)
    for tc, specs in ((0, (DC_LUMA, DC_CHROMA)), (1, (AC_LUMA, AC_CHROMA))):
        for th, (counts, vv) in enumerate(specs[:min(len(planes), 2)]):
            out += _marker(0xC4, bytes([tc * 16 + th]) + bytes(counts) + bytes(vv))
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        sos += bytes([ci + 1, min(ci, 1) * 17])
    out += _marker(0xDA, sos + bytes([0, 63, 0]))
    return bytes(out + scan + b"\xff\xd9")


# Tables holding every symbol (fixtures need no compression): DC sizes
# 0-11 at 4 bits; all 256 AC symbols, 254 at 8 bits and 2 at 9 (no code
# of all ones).
DC_ALL = ([0, 0, 0, 12] + [0] * 12, list(range(12)))
AC_ALL = ([0] * 7 + [254, 2] + [0] * 7, list(range(256)))


class _ScanWriter:
    """The bits of one progressive scan, restart interval by interval,
    with libjpeg's EOB-run and correction-bit buffering (jcphuff.c)."""

    def __init__(self):
        self.dc, self.ac = _codes(DC_ALL), _codes(AC_ALL)
        self.out = bytearray()
        self.vals: list[int] = []
        self.lens: list[int] = []
        self.eobrun, self.be, self.intervals = 0, [], 0

    def bits(self, v: int, n: int) -> None:
        if n:
            self.vals.append(v)
            self.lens.append(n)

    def sym(self, table, s: int) -> None:
        self.bits(int(table[0][s]), int(table[1][s]))

    def flush_eob(self) -> None:
        if self.eobrun:
            nb = self.eobrun.bit_length() - 1
            self.sym(self.ac, nb << 4)
            self.bits(self.eobrun - (1 << nb), nb)
            self.eobrun = 0
        for b in self.be:
            self.bits(b, 1)
        self.be = []

    def end_interval(self) -> None:
        self.flush_eob()
        if self.intervals:
            self.out += bytes([0xFF, 0xD0 + ((self.intervals - 1) & 7)])
        self.out += _pack(np.asarray(self.vals, np.int64), np.asarray(self.lens, np.int64))
        self.vals, self.lens = [], []
        self.intervals += 1


def _size_bits(v: int) -> tuple[int, int]:
    s = abs(v).bit_length()
    return s, (v + (1 << s) - 1 if v < 0 else v)


def _ac_first(wr: _ScanWriter, zz, ss: int, se: int, al: int) -> None:
    r = 0
    for k in range(ss, se + 1):
        c = int(zz[k])
        t = abs(c) >> al
        if t == 0:
            r += 1
            continue
        wr.flush_eob()
        while r > 15:
            wr.sym(wr.ac, 0xF0)
            r -= 16
        s, bits = _size_bits(t if c >= 0 else -t)
        wr.sym(wr.ac, (r << 4) + s)
        wr.bits(bits, s)
        r = 0
    if r:
        wr.eobrun += 1
        if wr.eobrun == 0x7FFF:
            wr.flush_eob()


def _ac_refine(wr: _ScanWriter, zz, ss: int, se: int, al: int) -> None:
    absv = [abs(int(zz[k])) >> al for k in range(64)]
    eob = max([k for k in range(ss, se + 1) if absv[k] == 1], default=0)
    r, br = 0, []
    for k in range(ss, se + 1):
        t = absv[k]
        if t == 0:
            r += 1
            continue
        while r > 15 and k <= eob:
            wr.flush_eob()
            wr.sym(wr.ac, 0xF0)
            r -= 16
            for b in br:
                wr.bits(b, 1)
            br = []
        if t > 1:  # nonzero in an earlier scan: one correction bit
            br.append(t & 1)
            continue
        wr.flush_eob()
        wr.sym(wr.ac, (r << 4) + 1)
        wr.bits(0 if int(zz[k]) < 0 else 1, 1)
        for b in br:
            wr.bits(b, 1)
        br, r = [], 0
    if r or br:
        wr.eobrun += 1
        wr.be += br
        if wr.eobrun == 0x7FFF or len(wr.be) > 937:
            wr.flush_eob()


def encode_jpeg_progressive(image: np.ndarray, quality: int = 90, subsampling: str = "4:2:0",
                            restart: int = 0) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) grey -> progressive JPEG bytes (SOF2)
    of the coefficients :func:`encode_jpeg` writes, in libjpeg's default
    scan script (``jpeg_simple_progression``): DC first (Al 1), luma AC
    1-5 and 6-63 first (Al 2), chroma AC 1-63 first (Al 1), luma AC
    refine (Al 1), DC refine, chroma then luma AC refine (Al 0); EOB runs
    and tables that hold every symbol; ``restart`` MCUs a restart
    interval."""
    hv, mx_n, my_n, qts, comp_blocks = _coefficients(image, quality, subsampling)
    h, w = np.asarray(image).shape[:2]
    hmax, vmax = hv[0]
    nc = len(hv)
    if nc == 3:
        script = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                  ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                  ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                  ((0,), 1, 63, 1, 0)]
    else:
        script = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                  ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    # each component's blocks as a (rows, columns, 64) grid
    grids = [cb.transpose(0, 2, 1, 3, 4).reshape(my_n * cv, mx_n * ch, 64)
             for cb, (ch, cv) in zip(comp_blocks, hv)]
    out = _headers(h, w, hv, qts, 0xC2)
    out += _marker(0xC4, bytes([0x00]) + bytes(DC_ALL[0]) + bytes(DC_ALL[1]))
    out += _marker(0xC4, bytes([0x10]) + bytes(AC_ALL[0]) + bytes(AC_ALL[1]))
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    for comps, ss, se, ah, al in script:
        wr = _ScanWriter()
        if len(comps) > 1:  # interleaved DC: MCU by MCU
            units = [[(ci, my * hv[ci][1] + by, mx * hv[ci][0] + bx) for ci in comps
                      for by in range(hv[ci][1]) for bx in range(hv[ci][0])]
                     for my in range(my_n) for mx in range(mx_n)]
        else:  # one component: its own block grid, one block a MCU
            ci = comps[0]
            cw, chh = -(-w * hv[ci][0] // hmax), -(-h * hv[ci][1] // vmax)
            units = [[(ci, by, bx)] for by in range(-(-chh // 8)) for bx in range(-(-cw // 8))]
        pred = [0] * nc
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                wr.end_interval()
                pred = [0] * nc
            for ci, by, bx in unit:
                zz = grids[ci][by, bx]
                if ss == 0 and ah == 0:
                    v = int(zz[0]) >> al
                    s, bits = _size_bits(v - pred[ci])
                    pred[ci] = v
                    wr.sym(wr.dc, s)
                    wr.bits(bits, s)
                elif ss == 0:
                    wr.bits((int(zz[0]) >> al) & 1, 1)
                elif ah == 0:
                    _ac_first(wr, zz, ss, se, al)
                else:
                    _ac_refine(wr, zz, ss, se, al)
        wr.end_interval()
        sos = bytes([len(comps)]) + b"".join(bytes([ci + 1, 0x00]) for ci in comps)
        out += _marker(0xDA, sos + bytes([ss, se, ah * 16 + al])) + wr.out
    return bytes(out + b"\xff\xd9")


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Rows (h, row bytes) with row y filtered by ``kinds[y % len(kinds)]``
    (the PNG specification's five filters) -> the filtered stream."""
    rows = rows.astype(np.int64)
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:cur.size]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:cur.size]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur
    return bytes(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def encode_png_raw(samples: np.ndarray, colour: int, depth: int, interlace: bool = False,
                   palette: bytes | None = None, kinds=(0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of ``samples`` ((H, W) or (H, W, channels) integers below
    2**depth) as colour type ``colour`` at bit depth ``depth``, every
    (reduced) image's rows filtered with ``kinds`` in turn, Adam7
    interlaced when ``interlace``; ``palette`` (RGB triples) is written as
    the PLTE chunk."""
    a = np.asarray(samples)
    a = a.reshape(a.shape[0], a.shape[1], -1).astype(np.int64)
    h, w, c = a.shape
    bpp = max(c * depth // 8, 1)

    def pack(img):  # (h', w', c) samples -> (h', row bytes)
        if depth == 16:
            return img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
        if depth == 8:
            return img.astype(np.uint8).reshape(img.shape[0], -1)
        bits = ((img.reshape(img.shape[0], -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
        return np.packbits(bits.reshape(img.shape[0], -1).astype(np.uint8), axis=1)

    if interlace:
        parts = [a[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
        raw = b"".join(_filter_rows(pack(p), bpp, kinds) for p in parts if p.size)
    else:
        raw = _filter_rows(pack(a), bpp, kinds)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                              0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# -- release layouts from a generated LM6d root ------------------------------------

def _frames(src_root: str, scene: str) -> list[str]:
    d = os.path.join(src_root, "data", "observed", scene)
    return sorted(f[:-10] for f in os.listdir(d) if f.endswith("-color.png"))


def _obs(root: str, scene: str, frame: str, suffix: str) -> str:
    return os.path.join(root, "data", "observed", scene, f"{frame}-{suffix}")


def _mm_mesh(src_root: str, obj: str):
    from deepim_tpu_torch.raster.mesh import Mesh, load_mesh
    from deepim_tpu_torch.data.lm6d import LM6DDataset

    m = load_mesh(LM6DDataset(src_root, [obj]).model_path(obj))
    return Mesh(m.vertices * 1000.0, m.faces, m.colors, m.normals)


def write_bop_release(src_root: str, objects: list[str], out: str, k: np.ndarray,
                      form: str = "json", depth_scale: float = 0.1, rgb: str = "png",
                      t_scale: float = 1000.0, quality: int = 90) -> dict[int, str]:
    """A generated LM6d root (object ``ci`` in scene ``{ci:02d}``) as a BOP
    ``test`` split (``form="json"``) or a SIXD one (``"yaml"``): object
    ``ci`` becomes obj_id ``ci + 1`` and scene ``ci + 1``; meshes, poses in
    mm (``t_scale`` 1000; 1 writes metres, which the converter must not
    be given); depth as uint16 * ``depth_scale`` = mm; visible masks from
    the labels; RGB frames copied (``rgb="png"``) or JPEG (``"jpg"``) ->
    {obj_id: name}."""
    from deepim_tpu_torch.data.png import read_png, write_png
    from deepim_tpu_torch.raster.mesh import save_ply

    yaml_form = form == "yaml"
    os.makedirs(os.path.join(out, "models"), exist_ok=True)
    info = {}
    for ci, obj in enumerate(objects):
        oid = ci + 1
        name = f"obj_{oid:02d}.ply" if yaml_form else f"obj_{oid:06d}.ply"
        save_ply(os.path.join(out, "models", name), _mm_mesh(src_root, obj))
        info[str(oid)] = {"diameter": 0.0}
        scene = f"{ci:02d}"
        sdir = os.path.join(out, "test", f"{oid:02d}" if yaml_form else f"{oid:06d}")
        for sub in ("rgb", "depth", "mask_visib"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        gt, cam = {}, {}
        for frame in _frames(src_root, scene):
            im = int(frame)
            stem = f"{im:04d}" if yaml_form else f"{im:06d}"
            if rgb == "png":
                shutil.copyfile(_obs(src_root, scene, frame, "color.png"),
                                os.path.join(sdir, "rgb", f"{stem}.png"))
            else:
                with open(os.path.join(sdir, "rgb", f"{stem}.jpg"), "wb") as f:
                    f.write(encode_jpeg(read_png(_obs(src_root, scene, frame, "color.png")),
                                        quality))
            depth_mm = read_png(_obs(src_root, scene, frame, "depth.png")).astype(np.float64)
            write_png(os.path.join(sdir, "depth", f"{stem}.png"),
                      np.round(depth_mm / depth_scale).astype(np.uint16))
            label = read_png(_obs(src_root, scene, frame, "label.png"))
            write_png(os.path.join(sdir, "mask_visib", f"{im:06d}_000000.png"),
                      np.where(label == ci + 1, 255, 0).astype(np.uint8))
            pose = np.loadtxt(_obs(src_root, scene, frame, f"pose_{obj}.txt")).reshape(3, 4)
            gt[im] = [{"cam_R_m2c": pose[:, :3].reshape(-1).tolist(),
                       "cam_t_m2c": (pose[:, 3] * t_scale).tolist(), "obj_id": oid}]
            cam[im] = {"cam_K": k.reshape(-1).tolist(), "depth_scale": depth_scale}
        if yaml_form:
            import yaml

            for fname, d in (("gt.yml", gt), ("info.yml", cam)):
                with open(os.path.join(sdir, fname), "w") as f:
                    yaml.safe_dump(d, f)
        else:
            for fname, d in (("scene_gt.json", gt), ("scene_camera.json", cam)):
                with open(os.path.join(sdir, fname), "w") as f:
                    json.dump({str(i): v for i, v in d.items()}, f)
    with open(os.path.join(out, "models", "models_info.json"), "w") as f:
        json.dump(info, f)
    return {ci + 1: obj for ci, obj in enumerate(objects)}


def write_dpt(path: str, depth_mm: np.ndarray, swap_header: bool = False) -> None:
    rows, cols = depth_mm.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", *((cols, rows) if swap_header else (rows, cols))))
        depth_mm.astype(np.uint16).tofile(f)


def write_lm_original_release(src_root: str, objects: list[str], out: str,
                              quality: int = 90, subsampling: str = "4:2:0",
                              tra_scale: float = 100.0) -> None:
    """A generated LM6d root as the ACCV'12 release: per object ``mesh.ply``
    (mm) and ``data/`` with ``color{i}.jpg`` (:func:`encode_jpeg`),
    ``depth{i}.dpt`` (mm; odd frames with the swapped header some mirrors
    write), ``rot{i}.rot`` and ``tra{i}.tra`` (``tra_scale`` 100: cm)."""
    from deepim_tpu_torch.data.png import read_png
    from deepim_tpu_torch.raster.mesh import save_ply

    for ci, obj in enumerate(objects):
        data = os.path.join(out, obj, "data")
        os.makedirs(data, exist_ok=True)
        save_ply(os.path.join(out, obj, "mesh.ply"), _mm_mesh(src_root, obj))
        scene = f"{ci:02d}"
        for frame in _frames(src_root, scene):
            i = int(frame)
            rgb = read_png(_obs(src_root, scene, frame, "color.png"))
            with open(os.path.join(data, f"color{i}.jpg"), "wb") as f:
                f.write(encode_jpeg(rgb, quality, subsampling))
            write_dpt(os.path.join(data, f"depth{i}.dpt"),
                      read_png(_obs(src_root, scene, frame, "depth.png")), swap_header=i % 2 == 1)
            pose = np.loadtxt(_obs(src_root, scene, frame, f"pose_{obj}.txt")).reshape(3, 4)
            with open(os.path.join(data, f"rot{i}.rot"), "w") as f:
                f.write("3 3\n" + "\n".join(" ".join(f"{v:.9f}" for v in row)
                                            for row in pose[:, :3]) + "\n")
            with open(os.path.join(data, f"tra{i}.tra"), "w") as f:
                f.write("1 3\n" + " ".join(f"{v:.9f}" for v in pose[:, 3] * tra_scale) + "\n")


def ycb_classes(objects: list[str]) -> list[str]:
    """A 21-class list (as the release's) holding ``objects`` at spread,
    non-consecutive positions, so global ids differ from slots."""
    classes = [f"ycb_class_{i:02d}" for i in range(21)]
    for ci, obj in enumerate(objects):
        classes[(2 + 5 * ci) % 21] = obj
    return classes


def write_ycb_original_release(src_root: str, objects: list[str], out: str, k: np.ndarray,
                               keyframe_every: int = 2) -> list[str]:
    """A generated LM6d root as the original YCB-Video release: object
    ``ci`` is sequence ``{ci:04d}`` of its frames, colour PNGs copied,
    depth at ``factor_depth`` 10000, labels of global 1-based class ids,
    ``-meta.mat`` (poses (3, 4, 1), ``cls_indexes``, ``factor_depth``,
    ``intrinsic_matrix``), ``models/{name}/`` copied, every
    ``keyframe_every``-th frame in ``image_sets/keyframe.txt`` (plus one
    of a sequence not in the drop) -> the class list (also written to
    ``image_sets/classes.txt``)."""
    from scipy.io import savemat

    from deepim_tpu_torch.data.png import read_png, write_png

    classes = ycb_classes(objects)
    keyframes = []
    for ci, obj in enumerate(objects):
        gid = classes.index(obj) + 1
        scene, seq = f"{ci:02d}", f"{ci:04d}"
        sdir = os.path.join(out, "data", seq)
        os.makedirs(sdir, exist_ok=True)
        for n, frame in enumerate(_frames(src_root, scene)):
            shutil.copyfile(_obs(src_root, scene, frame, "color.png"),
                            os.path.join(sdir, f"{frame}-color.png"))
            depth_mm = read_png(_obs(src_root, scene, frame, "depth.png")).astype(np.int64)
            write_png(os.path.join(sdir, f"{frame}-depth.png"), (depth_mm * 10).astype(np.uint16))
            label = read_png(_obs(src_root, scene, frame, "label.png"))
            write_png(os.path.join(sdir, f"{frame}-label.png"),
                      np.where(label == ci + 1, gid, 0).astype(np.uint8))
            pose = np.loadtxt(_obs(src_root, scene, frame, f"pose_{obj}.txt")).reshape(3, 4)
            savemat(os.path.join(sdir, f"{frame}-meta.mat"), {
                "poses": pose[:, :, None].astype(np.float32),
                "cls_indexes": np.array([[gid]], np.uint8),
                "factor_depth": np.array([[10000.0]]), "intrinsic_matrix": k})
            if n % keyframe_every == 0:
                keyframes.append(f"{seq}/{frame}")
        shutil.copytree(os.path.join(src_root, "models", obj), os.path.join(out, "models", obj))
    os.makedirs(os.path.join(out, "image_sets"), exist_ok=True)
    with open(os.path.join(out, "image_sets", "keyframe.txt"), "w") as f:
        f.write("\n".join(keyframes + ["0099/000777"]) + "\n")
    with open(os.path.join(out, "image_sets", "classes.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    return classes


# -- a converted root against the generated one --------------------------------------

def _diffs(gen: str, conv: str, pairs, rgb_ref=None) -> dict:
    """pairs: (gen scene, gen frame, conv dir+stem prefix, obj, label id
    in the converted root or None for no label)."""
    from deepim_tpu_torch.data.jpeg import imread

    pose_err = depth_err = 0.0
    labels_equal = rgb_equal = True
    for scene, frame, prefix, obj, conv_id, gen_id in pairs:
        g = lambda s: _obs(gen, scene, frame, s)  # noqa: E731
        pose_err = max(pose_err, float(np.abs(
            np.loadtxt(prefix + f"-pose_{obj}.txt") - np.loadtxt(g(f"pose_{obj}.txt"))).max()))
        depth_err = max(depth_err, float(np.abs(
            imread(prefix + "-depth.png").astype(np.int64)
            - imread(g("depth.png")).astype(np.int64)).max()))
        want_rgb = imread(g("color.png")) if rgb_ref is None else rgb_ref(scene, frame)
        rgb_equal &= bool(np.array_equal(imread(prefix + "-color.png"), want_rgb))
        if conv_id is not None:
            labels_equal &= bool(np.array_equal(imread(prefix + "-label.png") == conv_id,
                                                imread(g("label.png")) == gen_id))
        else:
            labels_equal &= not os.path.exists(prefix + "-label.png")
    return {"frames": len(pairs), "pose_max_abs": pose_err, "depth_max_mm": depth_err,
            "labels_equal": labels_equal, "rgb_equal": rgb_equal}


def compare_bop(gen: str, conv: str, objects: list[str], rgb_ref=None,
                form: str = "json") -> dict:
    """A converted BOP release (:func:`write_bop_release`) against its root."""
    width = 2 if form == "yaml" else 6
    pairs = [(f"{ci:02d}", fr, os.path.join(conv, "data", "observed", f"{ci + 1:0{width}d}", fr),
              obj, ci + 1, ci + 1)
             for ci, obj in enumerate(objects) for fr in _frames(gen, f"{ci:02d}")]
    return _diffs(gen, conv, pairs, rgb_ref)


def compare_lm_original(gen: str, conv: str, objects: list[str], rgb_ref) -> dict:
    pairs = [(f"{ci:02d}", fr, os.path.join(conv, "data", "observed", obj, fr), obj, None, None)
             for ci, obj in enumerate(objects) for fr in _frames(gen, f"{ci:02d}")]
    return _diffs(gen, conv, pairs, rgb_ref)


def compare_ycb(gen: str, conv: str, objects: list[str]) -> dict:
    pairs = [(f"{ci:02d}", fr, os.path.join(conv, "data", "video", f"{ci:04d}", fr), obj, 1,
              ci + 1)
             for ci, obj in enumerate(objects) for fr in _frames(gen, f"{ci:02d}")]
    return _diffs(gen, conv, pairs)


def assert_trees_match(a: str, b: str) -> int:
    """Two converted roots hold the same files with the same contents:
    images decode equal, text matrices (poses) within rtol 1e-6, PLY
    meshes' vertices within rtol 1e-6 and faces equal, anything else
    byte for byte -> the number of files compared."""
    from deepim_tpu_torch.data.jpeg import imread
    from deepim_tpu_torch.raster.mesh import load_ply

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(a)
    assert names == files(b), (names, files(b))
    for rel in names:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith((".png", ".jpg")):
            np.testing.assert_array_equal(imread(pa), imread(pb), err_msg=rel)
        elif rel.endswith(".txt") and "image_set" not in rel and "video_sets" not in rel:
            np.testing.assert_allclose(np.loadtxt(pa), np.loadtxt(pb), rtol=1e-6, atol=1e-12,
                                       err_msg=rel)
        elif rel.endswith(".ply"):
            ma, mb = load_ply(pa), load_ply(pb)
            np.testing.assert_allclose(ma.vertices, mb.vertices, rtol=1e-6, err_msg=rel)
            np.testing.assert_array_equal(ma.faces, mb.faces, err_msg=rel)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return len(names)


# -- the writers against PIL (CPU tests) ---------------------------------------

K_SMALL = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)


def _image(h, w, grey=False, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1) + rng.randint(0, 50, (h, w, 3))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 0] if grey else a


def _generated(tmp_path, objects=("box", "icosphere")):
    from deepim_tpu_torch.data.toolkit import gen_procedural_dataset

    root = str(tmp_path / "gen")
    gen_procedural_dataset(root, list(objects), K_SMALL, (48, 64), frames_per_obj=3,
                           device="cpu")
    return root


def test_encoder_writes_what_pil_and_the_port_decode_alike():
    import io

    import pytest
    from PIL import Image

    from deepim_tpu_torch.data.jpeg import decode_jpeg

    for (h, w) in ((48, 64), (47, 61), (9, 17)):
        for sub in ("4:4:4", "4:2:2", "4:2:0", "grey"):
            for restart in (0, 1, 5):
                img = _image(h, w, grey=sub == "grey")
                data = encode_jpeg(img, 85, "4:4:4" if sub == "grey" else sub, restart)
                pil = np.asarray(Image.open(io.BytesIO(data)))
                assert pil.shape == img.shape
                np.testing.assert_array_equal(decode_jpeg(data), pil)
                # as faithful an encoding as PIL's own at these settings
                ref = io.BytesIO()
                Image.fromarray(img).save(ref, "JPEG", quality=85, subsampling={
                    "4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": 0}[sub])
                pil_err = np.abs(np.asarray(Image.open(ref)).astype(int) - img).mean()
                assert np.abs(pil.astype(int) - img).mean() < pil_err + 0.5, (h, w, sub)
    with pytest.raises(KeyError):
        encode_jpeg(_image(8, 8), subsampling="4:1:1")


def test_bop_and_sixd_writers_are_readable(tmp_path):
    from PIL import Image

    gen = _generated(tmp_path, ("box",))
    for form in ("json", "yaml"):
        out = str(tmp_path / form)
        assert write_bop_release(gen, ["box"], out, K_SMALL, form=form, rgb="jpg") == {1: "box"}
        sdir = os.path.join(out, "test", "01" if form == "yaml" else "000001")
        stem = "0000" if form == "yaml" else "000000"
        assert Image.open(os.path.join(sdir, "rgb", f"{stem}.jpg")).size == (64, 48)
        dep = np.asarray(Image.open(os.path.join(sdir, "depth", f"{stem}.png")))
        gen_dep = np.asarray(Image.open(os.path.join(gen, "data", "observed", "00",
                                                     "000000-depth.png")))
        np.testing.assert_array_equal(dep, gen_dep.astype(np.int64) * 10)
        mask = np.asarray(Image.open(os.path.join(sdir, "mask_visib", "000000_000000.png")))
        assert set(np.unique(mask)) <= {0, 255} and mask.any()


def test_lm_original_and_ycb_writers_are_readable(tmp_path):
    from PIL import Image
    from scipy.io import loadmat

    from deepim_tpu_torch.data.lm_original import read_dpt

    gen = _generated(tmp_path)
    out = str(tmp_path / "accv")
    write_lm_original_release(gen, ["box", "icosphere"], out)
    assert Image.open(os.path.join(out, "box", "data", "color1.jpg")).size == (64, 48)
    assert read_dpt(os.path.join(out, "box", "data", "depth1.dpt")).shape == (48, 64)
    ycb = str(tmp_path / "ycb")
    classes = write_ycb_original_release(gen, ["box", "icosphere"], ycb, K_SMALL)
    meta = loadmat(os.path.join(ycb, "data", "0001", "000000-meta.mat"))
    assert int(meta["cls_indexes"][0, 0]) == classes.index("icosphere") + 1 == 8
    label = np.asarray(Image.open(os.path.join(ycb, "data", "0001", "000000-label.png")))
    assert set(np.unique(label)) <= {0, 8}
