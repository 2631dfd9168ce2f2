"""JPEG reading: a Huffman-coded, 8-bit decoder, baseline and progressive.

The port's JPEG reader.  The original LINEMOD release ships its frames as
``color{i}.jpg`` and BOP's training splits as ``.jpg``; the reference reads
them through PIL (``deepim_tpu/data/lm_original.py:141``,
``deepim_tpu/data/bop.py:58-59``), which the port does not depend on.
:func:`decode_jpeg` returns the pixels PIL returns, bit for bit: PIL decodes
with libjpeg-turbo's defaults, and this module does what those are:

- the integer "islow" inverse DCT (``jidctint.c``);
- fancy (triangle) chroma upsampling for 4:2:2 and 4:2:0
  (``jdsample.c §h2v1_fancy_upsample, §h2v2_fancy_upsample``), the rows
  beyond the image's edge being its edge rows (``jdmainct.c``);
- the fixed-point YCbCr -> RGB tables (``jdcolor.c``).

It reads 8-bit grey and three-component images (YCbCr, or RGB where an
Adobe marker or the component ids say so) at 4:4:4, 4:2:2 and 4:2:0, one
scan or several, with restart markers, sequential (SOF0/SOF1) or
progressive (SOF2: DC first and refine scans, AC first scans with EOB
runs, AC refine scans, each adding to the coefficients the one IDCT
reads; the Huffman tables a scan uses are those defined before it).
libjpeg smooths blocks of a progressive image only while some
coefficient's refinement is incomplete (``jdcoefct.c §smoothing_ok``); a
fully refined file, which every encoder's default script writes, is not
smoothed, so the pixels stay PIL's; one whose coefficients 0-9 stop short
of the last refinement raises.  Lossless, hierarchical,
arithmetic-coded, 12-bit and four-component (CMYK/YCCK) files raise
``ValueError`` naming the marker, as does a truncated file.

The markers are parsed here; ``csrc/jpeg_decode.cpp`` does the rest in
three C functions (entropy decoding of a scan, the IDCT, upsampling and
colour), built with ``g++`` like the PNG unfilter
(:func:`deepim_tpu_torch.data.png.build_library`, no fallback) and bound
with ``ctypes``, so decoding runs without the GIL.  ``plain=True`` runs
the same three stages in Python and numpy: the plain version the tests
hold the C++ one to.  :func:`imread` reads a PNG or a JPEG by its magic
bytes.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from deepim_tpu_torch.data import png

DECODE_SRC = Path(__file__).resolve().parent / "csrc" / "jpeg_decode.cpp"
_lock = threading.Lock()
_lib = None

# jpeg_natural_order: the zigzag position k of a coefficient -> its index
# in the 8x8 block, row-major
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_UNSUPPORTED = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)", 0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCC: "arithmetic-coded JPEG (DAC)", 0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
}
_ERRORS = {-1: "bad Huffman code", -2: "truncated JPEG: the scan's data ran out",
           -3: "missing or out-of-order restart marker",
           -4: "corrupt JPEG: a run past the scan's last coefficient",
           -5: "corrupt JPEG: a progressive scan with a bad spectral band"}


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    width: int = 0  # samples (downsampled_width)
    height: int = 0
    bw: int = 0  # coefficient plane, blocks
    bh: int = 0


@dataclass
class Scan:
    comps: list[tuple[int, int, int]]  # (component index, DC table, AC table)
    restart: int
    data: bytes
    huff: np.ndarray  # the (8, 272) tables defined before this scan
    band: tuple[int, int, int, int] = (0, 63, 0, 0)  # Ss, Se, Ah, Al


@dataclass
class Frame:
    width: int
    height: int
    comps: list[Component]
    qt: dict[int, np.ndarray] = field(default_factory=dict)  # natural order, uint16
    scans: list[Scan] = field(default_factory=list)
    transform: int = 1  # 0 grey, 1 YCbCr, 2 RGB
    progressive: bool = False


def _scan_end(data: bytes, pos: int) -> int:
    """Index of the marker ending the entropy-coded segment at ``pos``
    (the first 0xFF not followed by 0x00 or a restart marker)."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            return len(data)
        nxt = data[pos + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            pos += 1 if nxt == 0xFF else 2
            continue
        return pos


def parse(data: bytes) -> Frame:
    """The markers of a JPEG file -> its frame, tables and scans."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos, frame, restart = 2, None, 0
    jfif = adobe = None
    huff = np.zeros((8, 272), np.uint8)
    qt: dict[int, np.ndarray] = {}
    scans: list[Scan] = []
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # libjpeg skips garbage between markers
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG: a marker without its length")
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + n]
        if len(body) != n - 2:
            raise ValueError(f"truncated JPEG: marker 0x{m:02X} runs past the end")
        pos += n
        if m in _UNSUPPORTED:
            raise ValueError(f"unsupported {_UNSUPPORTED[m]}: only baseline and progressive "
                             "Huffman JPEG (SOF0-SOF2) is read")
        if m in (0xC0, 0xC1, 0xC2):
            precision, hh, ww, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"unsupported {precision}-bit JPEG (SOF{m - 0xC0}): "
                                 "only 8-bit samples are read")
            if nc not in (1, 3):
                raise ValueError(f"unsupported JPEG with {nc} components (SOF{m - 0xC0}; "
                                 "CMYK/YCCK are not read)")
            if hh == 0:
                raise ValueError("unsupported JPEG: height 0 (DNL marker)")
            comps = [Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                               body[8 + 3 * i]) for i in range(nc)]
            frame = Frame(ww, hh, comps, progressive=m == 0xC2)
        elif m == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                nv = int(counts.sum(dtype=np.int64))
                if tc > 1 or th > 3 or nv > 256:
                    raise ValueError("corrupt JPEG: bad DHT marker")
                t = huff[4 * tc + th]
                t[:] = 0
                t[:16] = counts
                t[16:16 + nv] = np.frombuffer(body[i + 17:i + 17 + nv], np.uint8)
                i += 17 + nv
        elif m == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                zz = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[NATURAL] = zz
                qt[tq] = table
                i += 1 + size
        elif m == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else 1
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            ns = body[0]
            ids = {c.cid: k for k, c in enumerate(frame.comps)}
            sel = []
            for j in range(ns):
                cid, tables = body[1 + 2 * j], body[2 + 2 * j]
                if cid not in ids:
                    raise ValueError(f"corrupt JPEG: scan names component {cid}")
                sel.append((ids[cid], tables >> 4, tables & 15))
            ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            band = (ss, se, ahal >> 4, ahal & 15)
            if not frame.progressive and band != (0, 63, 0, 0):
                raise ValueError("unsupported progressive scan in a baseline JPEG")
            if frame.progressive and (ss > se or se > 63 or (ss == 0) != (se == 0)
                                      or (ss > 0 and ns != 1) or band[3] > 13):
                raise ValueError(_ERRORS[-5])
            end = _scan_end(data, pos)
            scans.append(Scan(sel, restart, data[pos:end], huff.copy(), band))
            pos = end
    if frame is None:
        raise ValueError("not a JPEG image: no SOF marker")
    if not scans:
        raise ValueError("truncated JPEG: no scan")
    if frame.progressive:
        _check_refined(frame, scans)
    frame.qt, frame.scans = qt, scans
    if len(frame.comps) == 1:
        frame.transform = 0
    elif adobe is not None and not jfif:
        frame.transform = 1 if adobe else 2
    elif not jfif and [c.cid for c in frame.comps] == [82, 71, 66]:  # 'R', 'G', 'B'
        frame.transform = 2
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    for c in frame.comps:
        if c.tq not in qt:
            raise ValueError(f"corrupt JPEG: no quantization table {c.tq}")
        c.width = -(-frame.width * c.h // hmax)
        c.height = -(-frame.height * c.v // vmax)
        c.bw = -(-frame.width // (8 * hmax)) * c.h
        c.bh = -(-frame.height // (8 * vmax)) * c.v
    if len(frame.comps) == 3:
        y, cb, cr = frame.comps
        if (y.h, y.v) != (hmax, vmax) or any(
                (hmax // c.h, vmax // c.v) not in ((1, 1), (2, 1), (2, 2))
                or hmax % c.h or vmax % c.v for c in (cb, cr)):
            raise ValueError("unsupported chroma sampling "
                             f"{[(c.h, c.v) for c in frame.comps]}: 4:4:4, 4:2:2 and "
                             "4:2:0 are read")
    return frame


def _check_refined(frame: Frame, scans: list[Scan]) -> None:
    """Raise unless every component's coefficients 0-9 end at point
    transform 0: otherwise libjpeg smooths the blocks
    (``jdcoefct.c §smoothing_ok``, which reads the first 10), and the
    pixels would not be PIL's."""
    bits = np.full((len(frame.comps), 64), -1)
    for scan in scans:
        ss, se, _, al = scan.band
        for ci, _, _ in scan.comps:
            bits[ci, ss:se + 1] = al
    if (bits[:, :10] != 0).any():
        raise ValueError("unsupported progressive JPEG whose coefficients 0-9 are not fully "
                         "refined: libjpeg smooths such blocks")


def _scan_geometry(frame: Frame, scan: Scan) -> tuple[int, int, list[tuple[int, int]]]:
    """(MCUs across, MCUs down, blocks (h, v) of each scan component a MCU)."""
    if len(scan.comps) == 1:  # non-interleaved: one block a MCU
        c = frame.comps[scan.comps[0][0]]
        return -(-c.width // 8), -(-c.height // 8), [(1, 1)]
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    return (-(-frame.width // (8 * hmax)), -(-frame.height // (8 * vmax)),
            [(frame.comps[i].h, frame.comps[i].v) for i, _, _ in scan.comps])


# -- the plain stages (Python and numpy) ---------------------------------------

def _lookup(spec: np.ndarray) -> list:
    """A DHT's codes -> a 65,536-entry table: the top 16 bits of the stream
    -> (code length, symbol), or None where no code starts so."""
    table: list = [None] * 65536
    code, k = 0, 16
    for length in range(1, 17):
        for _ in range(int(spec[length - 1])):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = [(length, int(spec[k]))] * (1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return table


def _intervals(seg: bytes) -> list[bytes]:
    """A scan's segment -> its restart intervals, each with the stuffed
    0x00 after 0xFF removed; the markers' numbers are checked."""
    out, pos, n = [], 0, 0
    while True:
        i = seg.find(b"\xff", pos)
        while i >= 0 and i + 1 < len(seg) and seg[i + 1] == 0x00:
            i = seg.find(b"\xff", i + 2)
        if i < 0 or i + 1 >= len(seg):
            out.append(seg[pos:].replace(b"\xff\x00", b"\xff"))
            return out
        if seg[i + 1] != 0xD0 + (n & 7):
            raise ValueError(_ERRORS[-3])
        out.append(seg[pos:i].replace(b"\xff\x00", b"\xff"))
        pos, n = i + 2, n + 1


def decode_scan_plain(frame: Frame, scan: Scan, coefs: list[np.ndarray]) -> None:
    """Entropy-decode ``scan`` into ``coefs`` (one (bh * bw, 64) int16 array
    of natural-order coefficients a component), in Python."""
    mx_n, my_n, hv = _scan_geometry(frame, scan)
    dcs = {t: _lookup(scan.huff[t]) for _, t, _ in scan.comps}
    acs = {t: _lookup(scan.huff[4 + t]) for _, _, t in scan.comps}
    per = [(coefs[ci], frame.comps[ci].bw, dcs[td], acs[ta], h, v)
           for (ci, td, ta), (h, v) in zip(scan.comps, hv)]
    natural = NATURAL.tolist()
    total = mx_n * my_n
    restart = scan.restart or total
    intervals = _intervals(scan.data)
    if len(intervals) < -(-total // restart):
        raise ValueError(_ERRORS[-2])
    for start in range(0, total, restart):
        seg = intervals[start // restart]
        nbits = 8 * len(seg)
        seg = seg + bytes(8)
        p = 0
        pred = [0] * len(per)
        for m in range(start, min(start + restart, total)):
            my, mx = divmod(m, mx_n)
            for c, (plane, bw, dc, ac, h, v) in enumerate(per):
                for by in range(v):
                    row = (my * v + by) * bw + mx * h
                    for bx in range(h):
                        blk = plane[row + bx]
                        i = p >> 3
                        peek = (int.from_bytes(seg[i:i + 5], "big") >> (8 - (p & 7))) & 0xFFFFFFFF
                        hit = dc[peek >> 16]
                        if hit is None:
                            raise ValueError(_ERRORS[-1])
                        length, s = hit
                        diff = (peek >> (32 - length - s)) & ((1 << s) - 1) if s else 0
                        if s and diff < (1 << (s - 1)):
                            diff -= (1 << s) - 1
                        p += length + s
                        pred[c] += diff
                        blk[0] = pred[c]
                        k = 1
                        while k < 64:
                            i = p >> 3
                            peek = (int.from_bytes(seg[i:i + 5], "big")
                                    >> (8 - (p & 7))) & 0xFFFFFFFF
                            hit = ac[peek >> 16]
                            if hit is None:
                                raise ValueError(_ERRORS[-1])
                            length, rs = hit
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                p += length
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            if k > 63:
                                raise ValueError(_ERRORS[-4])
                            val = (peek >> (32 - length - s)) & ((1 << s) - 1)
                            if val < (1 << (s - 1)):
                                val -= (1 << s) - 1
                            blk[natural[k]] = val
                            p += length + s
                            k += 1
            if p > nbits:
                raise ValueError(_ERRORS[-2])


class _BitReader:
    """MSB-first bits of one restart interval (stuffing removed), read past
    its end as zeros; ``p`` counts the bits taken."""

    def __init__(self, seg: bytes):
        self.nbits = 8 * len(seg)
        self.seg = seg + bytes(8)
        self.p = 0

    def peek32(self) -> int:
        i = self.p >> 3
        return (int.from_bytes(self.seg[i:i + 5], "big") >> (8 - (self.p & 7))) & 0xFFFFFFFF

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek32() >> (32 - n)
        self.p += n
        return v

    def decode(self, table) -> int:
        hit = table[self.peek32() >> 16]
        if hit is None:
            raise ValueError(_ERRORS[-1])
        self.p += hit[0]
        return hit[1]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def decode_prog_scan_plain(frame: Frame, scan: Scan, coefs: list[np.ndarray]) -> None:
    """Entropy-decode one scan of a progressive file into ``coefs`` (see
    :func:`decode_scan_plain`), adding to what earlier scans left: the
    plain version of ``deepim_jpeg_decode_prog_scan``."""
    mx_n, my_n, hv = _scan_geometry(frame, scan)
    dcs = {t: _lookup(scan.huff[t]) for _, t, _ in scan.comps}
    acs = {t: _lookup(scan.huff[4 + t]) for _, _, t in scan.comps}
    per = [(coefs[ci], frame.comps[ci].bw, dcs[td], acs[ta], h, v)
           for (ci, td, ta), (h, v) in zip(scan.comps, hv)]
    total = mx_n * my_n
    restart = scan.restart or total
    intervals = _intervals(scan.data)
    if len(intervals) < -(-total // restart):
        raise ValueError(_ERRORS[-2])
    for start in range(0, total, restart):
        bits = _BitReader(intervals[start // restart])
        try:
            _prog_interval(bits, per, range(start, min(start + restart, total)), mx_n,
                           scan.band)
        except ValueError:
            if bits.p > bits.nbits:  # a bad code read from the zeros past the data
                raise ValueError(_ERRORS[-2]) from None
            raise
        if bits.p > bits.nbits:
            raise ValueError(_ERRORS[-2])


def _prog_interval(bits: _BitReader, per: list, mcus: range, mx_n: int, band) -> None:
    """The MCUs ``mcus`` of one restart interval of a progressive scan (DC
    predictions and the EOB run start afresh)."""
    ss, se, ah, al = band
    natural = NATURAL.tolist()
    p1, m1 = 1 << al, -(1 << al)
    pred = [0] * len(per)
    eobrun = 0
    for m in mcus:
        my, mx = divmod(m, mx_n)
        for c, (plane, bw, dc, ac, h, v) in enumerate(per):
            for by in range(v):
                row = (my * v + by) * bw + mx * h
                for bx in range(h):
                    blk = plane[row + bx]
                    if ss == 0 and ah == 0:  # DC first: the difference, shifted up by al
                        s = bits.decode(dc)
                        pred[c] += _extend(bits.get(s), s)
                        blk[0] = pred[c] * p1
                    elif ss == 0:  # DC refine: one more bit
                        if bits.get(1):
                            blk[0] |= p1
                    elif ah == 0:
                        eobrun = _ac_first(bits, ac, blk, natural, ss, se, al, eobrun)
                    else:
                        eobrun = _ac_refine(bits, ac, blk, natural, ss, se, p1, m1, eobrun)


def _ac_first(bits, ac, blk, natural, ss, se, al, eobrun) -> int:
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.decode(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > se:
                raise ValueError(_ERRORS[-4])
            blk[natural[k]] = _extend(bits.get(s), s) * (1 << al)
        elif r == 15:
            k += 15
        else:
            return (1 << r) + bits.get(r) - 1
        k += 1
    return 0


def _ac_refine(bits, ac, blk, natural, ss, se, p1, m1, eobrun) -> int:
    def correct(i):
        if bits.get(1) and (int(blk[i]) & p1) == 0:
            blk[i] += p1 if blk[i] >= 0 else m1

    k = ss
    if eobrun == 0:
        while k <= se:
            rs = bits.decode(ac)
            r, value = rs >> 4, 0
            if rs & 15:
                value = p1 if bits.get(1) else m1
            elif r != 15:
                eobrun = (1 << r) + bits.get(r)
                break
            while k <= se:  # skip r zero coefficients, correcting nonzero ones
                i = natural[k]
                if blk[i] != 0:
                    correct(i)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if value:
                if k > se:
                    raise ValueError(_ERRORS[-4])
                blk[natural[k]] = value
            k += 1
    if eobrun > 0:
        for kk in range(k, se + 1):
            if blk[natural[kk]] != 0:
                correct(natural[kk])
        eobrun -= 1
    return eobrun


_IDCT = dict(F0_298631336=2446, F0_390180644=3196, F0_541196100=4433, F0_765366865=6270,
             F0_899976223=7373, F1_175875602=9633, F1_501321110=12299, F1_847759065=15137,
             F1_961570560=16069, F2_053119869=16819, F2_562915447=20995, F3_072711026=25172)


def _idct_1d(x: list[np.ndarray]) -> list[np.ndarray]:
    """jidctint.c's even and odd parts on eight int64 arrays -> eight."""
    f = _IDCT
    z1 = (x[2] + x[6]) * f["F0_541196100"]
    tmp2e = z1 + x[6] * -f["F1_847759065"]
    tmp3e = z1 + x[2] * f["F0_765366865"]
    tmp0e = (x[0] + x[4]) << 13
    tmp1e = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0e + tmp3e, tmp0e - tmp3e
    tmp11, tmp12 = tmp1e + tmp2e, tmp1e - tmp2e
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["F1_175875602"]
    t0 = t0 * f["F0_298631336"]
    t1 = t1 * f["F2_053119869"]
    t2 = t2 * f["F3_072711026"]
    t3 = t3 * f["F1_501321110"]
    z1 = z1 * -f["F0_899976223"]
    z2 = z2 * -f["F2_562915447"]
    z3 = z3 * -f["F1_961570560"] + z5
    z4 = z4 * -f["F0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _idct_limit(x: np.ndarray) -> np.ndarray:
    v = x & 1023  # libjpeg's range-limit table, indexed as it indexes it
    return np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(v < 896, 0, v - 896)))


def idct_plain(coefs: np.ndarray, bh: int, bw: int, qt: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-DCT (bh * bw, 64) natural-order coefficients
    -> a (bh * 8, bw * 8) uint8 plane, in numpy int64."""
    blocks = coefs.astype(np.int64) * qt.astype(np.int64)
    b = blocks.reshape(-1, 8, 8)
    cols = _idct_1d([b[:, r, :] for r in range(8)])  # pass 1: down each column
    ws = np.stack([(c + (1 << 10)) >> 11 for c in cols], axis=1)
    rows = _idct_1d([ws[:, :, c] for c in range(8)])  # pass 2: along each row
    out = np.stack([_idct_limit((r + (1 << 17)) >> 18) for r in rows], axis=2)
    return out.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8).astype(np.uint8)


def _upsample_plain(plane: np.ndarray, cw: int, ch: int, fh: int, fv: int) -> np.ndarray:
    p = plane[:ch, :cw].astype(np.int64)
    if fh == 1 and fv == 1:
        return p
    if cw <= 2:
        return np.repeat(np.repeat(p, fv, 0), fh, 1)
    if fv == 1:  # h2v1
        out = np.empty((ch, 2 * cw), np.int64)
        out[:, 0] = p[:, 0]
        out[:, 1] = (p[:, 0] * 3 + p[:, 1] + 2) >> 2
        out[:, 2:-2:2] = (p[:, 1:-1] * 3 + p[:, :-2] + 1) >> 2
        out[:, 3:-2:2] = (p[:, 1:-1] * 3 + p[:, 2:] + 2) >> 2
        out[:, -2] = (p[:, -1] * 3 + p[:, -2] + 1) >> 2
        out[:, -1] = p[:, -1]
        return out
    above = np.concatenate([p[:1], p[:-1]], 0)
    below = np.concatenate([p[1:], p[-1:]], 0)
    out = np.empty((2 * ch, 2 * cw), np.int64)
    for v, other in ((0, above), (1, below)):
        s = p * 3 + other
        o = out[v::2]
        o[:, 0] = (s[:, 0] * 4 + 8) >> 4
        o[:, 1] = (s[:, 0] * 3 + s[:, 1] + 7) >> 4
        o[:, 2:-2:2] = (s[:, 1:-1] * 3 + s[:, :-2] + 8) >> 4
        o[:, 3:-2:2] = (s[:, 1:-1] * 3 + s[:, 2:] + 7) >> 4
        o[:, -2] = (s[:, -1] * 3 + s[:, -2] + 8) >> 4
        o[:, -1] = (s[:, -1] * 4 + 7) >> 4
    return out


def _ycc_tables() -> tuple[np.ndarray, ...]:
    def fix(x):
        return int(x * 65536 + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def finish_plain(frame: Frame, planes: list[np.ndarray]) -> np.ndarray:
    """Upsample and colour-convert the IDCT planes -> (H, W[, 3]) uint8."""
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    h, w = frame.height, frame.width
    up = [_upsample_plain(pl, c.width, c.height, hmax // c.h, vmax // c.v)[:h, :w]
          for pl, c in zip(planes, frame.comps)]
    if frame.transform == 0:
        return up[0].astype(np.uint8)
    if frame.transform == 2:
        return np.stack(up, -1).astype(np.uint8)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y, cb, cr = up
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# -- the C++ stages ----------------------------------------------------------------

def build_decoder() -> Path:
    """``csrc/jpeg_decode.cpp`` built by
    :func:`deepim_tpu_torch.data.png.build_library`."""
    return png.build_library(DECODE_SRC, "libdeepim_jpeg")


def _decoder():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_decoder()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.deepim_jpeg_decode_scan.argtypes = [p, i64, i32, p, p, i64, i64, i64, p]
            lib.deepim_jpeg_decode_scan.restype = ctypes.c_int
            lib.deepim_jpeg_decode_prog_scan.argtypes = [p, i64, i32, p, p, i64, i64, i64,
                                                         i32, i32, i32, i32, p]
            lib.deepim_jpeg_decode_prog_scan.restype = ctypes.c_int
            lib.deepim_jpeg_idct.argtypes = [p, i64, i64, p, p]
            lib.deepim_jpeg_idct.restype = None
            lib.deepim_jpeg_finish.argtypes = [p, p, p, i32, i32, i64, i64, p]
            lib.deepim_jpeg_finish.restype = None
            _lib = lib
        return _lib


def _decode_cpp(frame: Frame) -> np.ndarray:
    lib = _decoder()
    sizes = [c.bh * c.bw * 64 for c in frame.comps]
    offsets = np.cumsum([0] + sizes[:-1])
    coefs = np.zeros(sum(sizes), np.int16)
    for scan in frame.scans:
        mx_n, my_n, hv = _scan_geometry(frame, scan)
        info = np.array([[h, v, td, ta, offsets[ci], frame.comps[ci].bw]
                         for (ci, td, ta), (h, v) in zip(scan.comps, hv)], np.int64)
        huff = np.ascontiguousarray(scan.huff)
        if frame.progressive:
            code = lib.deepim_jpeg_decode_prog_scan(
                scan.data, len(scan.data), len(scan.comps), info.ctypes.data,
                huff.ctypes.data, mx_n, my_n, scan.restart, *scan.band, coefs.ctypes.data)
        else:
            code = lib.deepim_jpeg_decode_scan(scan.data, len(scan.data), len(scan.comps),
                                               info.ctypes.data, huff.ctypes.data, mx_n, my_n,
                                               scan.restart, coefs.ctypes.data)
        if code:
            raise ValueError(_ERRORS[code])
    planes = []
    for c, off, size in zip(frame.comps, offsets, sizes):
        plane = np.empty((c.bh * 8, c.bw * 8), np.uint8)
        qt = np.ascontiguousarray(frame.qt[c.tq])
        lib.deepim_jpeg_idct(coefs[off:off + size].ctypes.data, c.bh, c.bw, qt.ctypes.data,
                             plane.ctypes.data)
        planes.append(plane)
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    n = len(planes)
    ptrs = (ctypes.c_void_p * n)(*[pl.ctypes.data for pl in planes])
    strides = np.array([pl.shape[1] for pl in planes], np.int64)
    dims = np.array([[c.width, c.height, hmax // c.h, vmax // c.v] for c in frame.comps],
                    np.int64)
    shape = (frame.height, frame.width) + (() if frame.transform == 0 else (3,))
    out = np.empty(shape, np.uint8)
    lib.deepim_jpeg_finish(ptrs, strides.ctypes.data, dims.ctypes.data, n, frame.transform,
                           frame.height, frame.width, out.ctypes.data)
    return out


def decode_jpeg(data: bytes, plain: bool = False) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB, or (H, W) for a grey image.
    ``plain`` decodes with the Python and numpy stages (for the tests and
    timings that hold the C++ decoder to them)."""
    frame = parse(data)
    if not plain:
        return _decode_cpp(frame)
    coefs = [np.zeros((c.bh * c.bw, 64), np.int16) for c in frame.comps]
    for scan in frame.scans:
        (decode_prog_scan_plain if frame.progressive else decode_scan_plain)(frame, scan, coefs)
    planes = [idct_plain(cf, c.bh, c.bw, frame.qt[c.tq]) for cf, c in zip(coefs, frame.comps)]
    return finish_plain(frame, planes)


def imread(path: str) -> np.ndarray:
    """A PNG or a JPEG file, told apart by its first bytes -> what
    :func:`~deepim_tpu_torch.data.png.decode_png` or :func:`decode_jpeg`
    returns."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return png.decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
