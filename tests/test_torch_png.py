"""deepim_tpu_torch.data.png and utils.viz against PIL and deepim_tpu.utils (CPU).

- PNGs the port writes (8-bit RGB, 8-bit grey, 16-bit grey) read back by
  PIL equal the arrays written, and the port reads its own.
- PNGs PIL writes, of a noisy gradient that makes PIL filter rows with
  Sub, Up and Paeth, decode equal in the port.  PIL never picks the
  Average filter, so a small encoder here writes rows with each of the
  five filters; PIL and the port read them alike.
- The viz helpers equal the reference's, and ``save_image`` writes what
  PIL reads back.
- The C++ row unfilter (``csrc/png_unfilter.cpp``) against the Python rows
  (``unfilter_plain``) and the reference's native decoder
  (``deepim_tpu.native.decode_png``): every filter, mixed per row, RGB,
  grey and 16-bit, odd widths, random rows of every filter and pixel size;
  bit for bit.  A bad filter byte and a truncated stream raise; a failed
  build raises with the compiler's output (there is no fallback);
  concurrent builders agree on one library.
- Every colour type and bit depth, plain and Adam7-interlaced, written by
  ``test_torch_release_fixtures.encode_png_raw`` (interlaced files by hand:
  PIL writes none) at sizes that leave passes empty: the port returns
  what the reference's ``LM6DDataset._read_image`` returns (its native
  decoder, or PIL where that refuses), dtype, shape and values; the C++
  reassembly equals ``adam7_plain``.  PIL-written palette (1, 2, 4 and
  8 bits; a palette ``label.png`` gives its label ids), grey + alpha and
  RGBA files, the same.
"""

import io
import struct
import threading
import zlib

import os
import sys

import numpy as np
import pytest
from PIL import Image

from deepim_tpu import native
from deepim_tpu.data.lm6d import LM6DDataset
from deepim_tpu.utils import viz as viz_j
from deepim_tpu_torch.data import png
from deepim_tpu_torch.utils import viz as viz_t

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_release_fixtures import encode_png_raw  # noqa: E402


def _images(seed=0, h=24, w=32):
    """A noisy gradient as 8-bit RGB, 8-bit grey and 16-bit grey."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.clip(np.stack([xx * 5, yy * 6, (xx + yy) * 2], -1) + rng.randint(0, 40, (h, w, 3)),
                  0, 255).astype(np.uint8)
    return {"rgb8": rgb, "grey8": rgb[..., 1].copy(),
            "grey16": (rgb[..., 0].astype(np.uint16) * 250 + rng.randint(0, 200, (h, w))
                       ).astype(np.uint16)}


def _filters(data: bytes) -> set[int]:
    """The row filter types of a non-interlaced PNG."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        hdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else hdr
        idat += body if kind == b"IDAT" else b""
    w, h, depth, colour = hdr[:4]
    row = w * {0: 1, 2: 3}[colour] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (row + 1)] for y in range(h)}


def _encode_filtered(image: np.ndarray, kinds) -> bytes:
    """PNG bytes of ``image`` with row y filtered by ``kinds[y % len(kinds)]``
    (the PNG specification's five filters, written out per byte)."""
    if image.dtype == np.uint16:
        rows, colour, depth, bpp = image.astype(">u2").view(np.uint8), 0, 16, 2
    elif image.ndim == 3:
        rows, colour, depth, bpp = image.reshape(image.shape[0], -1), 2, 8, 3
    else:
        rows, colour, depth, bpp = image, 0, 8, 1
    h, w = image.shape[:2]
    rows = rows.reshape(h, -1).astype(np.int64)
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind, cur = kinds[y % len(kinds)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
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

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                               0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "grey16"])
def test_port_written_png_reads_back_in_pil(tmp_path, kind):
    image = _images()[kind]
    path = str(tmp_path / "a.png")
    png.write_png(path, image)
    with Image.open(path) as im:
        got = np.asarray(im)
    np.testing.assert_array_equal(got, image)
    back = png.read_png(path)
    assert back.dtype == image.dtype and back.shape == image.shape
    np.testing.assert_array_equal(back, image)
    assert _filters(open(path, "rb").read()) == {0}


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "grey16"])
def test_pil_written_png_decodes_in_port(kind):
    image = _images(seed=1)[kind]
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    data = buf.getvalue()
    assert {1, 2, 4} <= _filters(data)  # PIL picked Sub, Up and Paeth rows
    got = png.decode_png(data)
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "grey16"])
def test_every_row_filter_decodes(kind):
    image = _images(seed=2)[kind]
    data = _encode_filtered(image, kinds=(0, 1, 2, 3, 4, 3, 4, 1))
    assert _filters(data) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
    np.testing.assert_array_equal(png.decode_png(data), image)


def test_unsupported_images_raise(tmp_path):
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 4), np.uint8))
    bad_depth = encode_png_raw(np.zeros((4, 4)), 3, 8).replace(  # a 16-bit palette
        struct.pack(">IIBB", 4, 4, 8, 3), struct.pack(">IIBB", 4, 4, 16, 3))
    with pytest.raises(ValueError, match="colour type 3, bit depth 16"):
        png.decode_png(bad_depth)
    with pytest.raises(ValueError):
        png.decode_png(b"not a png at all")


def test_viz_matches_reference(tmp_path):
    rng = np.random.RandomState(3)
    flow = rng.randn(12, 16, 2).astype(np.float32) * 5
    np.testing.assert_array_equal(viz_t.flow_to_rgb(flow), viz_j.flow_to_rgb(flow))
    np.testing.assert_array_equal(viz_t.flow_to_rgb(flow, 3.0), viz_j.flow_to_rgb(flow, 3.0))
    obs, ren = rng.rand(12, 16, 3), rng.rand(12, 16, 3)
    depth = np.where(rng.rand(12, 16) > 0.5, rng.rand(12, 16), 0.0)
    over = viz_t.overlay_render(obs, ren, depth)
    np.testing.assert_array_equal(over, viz_j.overlay_render(obs, ren, depth))
    mask = rng.rand(12, 16)
    np.testing.assert_array_equal(viz_t.mask_to_rgb(mask), viz_j.mask_to_rgb(mask))
    grey = (rng.rand(10, 5) * 255).astype(np.uint8)
    montage = viz_t.side_by_side(over, grey, viz_t.mask_to_rgb(mask))
    np.testing.assert_array_equal(montage, viz_j.side_by_side(over, grey,
                                                              viz_j.mask_to_rgb(mask)))
    viz_t.save_image(str(tmp_path / "m.png"), montage)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "m.png")), montage)


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "grey16"])
@pytest.mark.parametrize("width", [1, 7, 33])
def test_cpp_unfilter_matches_plain_and_reference(kind, width):
    image = _images(seed=width, h=11, w=width)[kind]
    for kinds in ((4,), (3,), (0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 2)):
        data = _encode_filtered(image, kinds)
        got = png.decode_png(data)
        assert got.dtype == image.dtype and got.shape == image.shape
        np.testing.assert_array_equal(got, image)
        np.testing.assert_array_equal(png.decode_png(data, plain=True), image)
        np.testing.assert_array_equal(native.decode_png(data), image)


@pytest.mark.parametrize("bpp", [1, 2, 3, 6])
def test_cpp_unfilter_random_rows(bpp):
    """Random bytes under random filter types: the C++ rows equal the
    Python rows byte for byte (and, swapped, pair for pair)."""
    rng = np.random.RandomState(bpp)
    h, row_bytes = 17, bpp * 13
    raw = rng.randint(0, 256, (h, row_bytes + 1)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, h)
    want = png.unfilter_plain(raw, h, row_bytes, bpp)
    np.testing.assert_array_equal(png.unfilter(raw, h, row_bytes, bpp), want)
    if bpp % 2 == 0:
        swapped = png.unfilter(raw, h, row_bytes, bpp, swap16=True)
        np.testing.assert_array_equal(swapped.view(np.uint16), want.view(">u2").astype(np.uint16))


def test_bad_filter_and_truncated_stream_raise():
    image = _images(seed=4)["rgb8"]
    raw = np.zeros((3, 1 + 6), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="bad PNG row filter 5 in row 1"):
        png.unfilter(raw, 3, 6, 3)
    data = _encode_filtered(image, (4,))
    with pytest.raises(ValueError, match="truncated|wrong size"):
        png.decode_png(data[:len(data) // 2])
    assert native.decode_png(data[:len(data) // 2]) is None  # the reference fails too


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(png, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="false failed"):
        png.decode_png(png.encode_png(_images()["rgb8"]))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        png.build_unfilter()


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    monkeypatch.setattr(png, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(png.build_unfilter())
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1 and paths[0].exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]


# (colour type, bit depth) of every PNG the specification allows
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _raw_png(colour, depth, interlace, h=37, w=41, seed=0):
    rng = np.random.RandomState(seed + depth)
    samples = rng.randint(0, 1 << depth, (h, w, CHANNELS[colour]))
    palette = (bytes(rng.randint(0, 256, 3 << depth).astype(np.uint8)) if colour == 3
               else None)
    return encode_png_raw(samples, colour, depth, interlace, palette)


@pytest.mark.parametrize("colour,depth", PNG_TYPES)
@pytest.mark.parametrize("interlace", [False, True])
def test_every_png_type_reads_as_the_reference(tmp_path, colour, depth, interlace):
    data = _raw_png(colour, depth, interlace)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    want = LM6DDataset._read_image(str(path))
    for got in (png.read_png(str(path)), png.decode_png(data, plain=True)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (3, 5), (9, 13), (16, 16)])
@pytest.mark.parametrize("bits_pp", [1, 2, 4, 8, 16, 24, 48, 64])
def test_adam7_cpp_matches_plain(size, bits_pp):
    """The C++ reassembly against the numpy one, at sizes whose passes are
    partly empty, for every pixel size (sub-byte ones unpacked)."""
    h, w = size
    colour, depth = {1: (0, 1), 2: (3, 2), 4: (0, 4), 8: (0, 8), 16: (4, 8), 24: (2, 8),
                     48: (2, 16), 64: (6, 16)}[bits_pp]
    data = _raw_png(colour, depth, True, h, w, seed=7)
    raw = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:
                                             data.index(b"IEND") - 8]), np.uint8)
    np.testing.assert_array_equal(png.adam7(raw, w, h, bits_pp),
                                  png.adam7_plain(raw, w, h, bits_pp))
    with pytest.raises(ValueError, match="wrong size"):
        png.adam7(raw[:-1], w, h, bits_pp)


@pytest.mark.parametrize("kind", ["P1", "P2", "P4", "P8", "label", "LA", "RGBA"])
def test_pil_written_palette_and_alpha_pngs(tmp_path, kind):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "a.png")
    if kind.startswith("P"):
        bits = int(kind[1])
        im = Image.fromarray(rng.randint(0, 1 << bits, (29, 35)).astype(np.uint8), "P")
        im.putpalette(list(rng.randint(0, 256, 3 << bits)))
        im.save(path, bits=bits)
        want_ids = np.asarray(im)
    elif kind == "label":  # label ids 0-4 stored as palette indices
        want_ids = rng.randint(0, 5, (29, 35)).astype(np.uint8)
        im = Image.fromarray(want_ids, "P")
        im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255, 255, 255, 0])
        im.save(path)
    else:
        c = 2 if kind == "LA" else 4
        Image.fromarray(rng.randint(0, 256, (29, 35, c)).astype(np.uint8), kind).save(path)
        want_ids = None
    with open(path, "rb") as f:
        data = f.read()
    assert data[25] == {"LA": 4, "RGBA": 6}.get(kind, 3)  # the colour type PIL wrote
    want = LM6DDataset._read_image(path)
    got = png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.decode_png(data, plain=True), want)
    if want_ids is not None:
        np.testing.assert_array_equal(got, want_ids)
