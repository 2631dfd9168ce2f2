"""deepim_tpu_torch.data.jpeg against PIL (CPU).

The reference reads JPEG frames through PIL (libjpeg-turbo's defaults: the
islow IDCT, fancy chroma upsampling, the fixed-point YCbCr tables); the
port's decoder must return PIL's pixels bit for bit, and its C++ stages
(``csrc/jpeg_decode.cpp``) the plain Python/numpy stages' exactly:

- PIL-written files: grey, 4:4:4, 4:2:2 and 4:2:0, even and odd sizes
  (47x61, 9x17), qualities from 30 to 100, with restart markers every
  block and every row; smooth and noisy content;
- files of the fixture encoder (``test_torch_release_fixtures.encode_jpeg``)
  with restart intervals, read by PIL, the C++ and the plain decoder;
- progressive files (SOF2), written by PIL (libjpeg's default scan
  script: DC first and refine, AC first with EOB runs, AC refine) and by
  the fixture encoder (``encode_jpeg_progressive``), at the same sizes,
  subsamplings and restart intervals: PIL's pixels, bit for bit.  They
  are fully refined, so libjpeg does not smooth them; a file whose first
  ten coefficients stop short of the last refinement (libjpeg smooths it)
  raises;
- lossless, arithmetic-coded, 12-bit and CMYK files raise naming the
  marker; a truncated file and a missing restart marker raise; a failed
  build raises with the compiler's output (no fallback);
- ``imread`` picks PNG or JPEG by the magic bytes.

Tolerance: none; every comparison is array equality.
"""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from deepim_tpu_torch.data import jpeg, png

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_release_fixtures import encode_jpeg, encode_jpeg_progressive  # noqa: E402

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _image(h, w, seed=0, noise=60, grey=False):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([xx * 3, yy * 4, 255 - (xx + yy) * 2], -1) + rng.randint(0, noise + 1, (h, w, 3))
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 1] if grey else a


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("size", [(48, 64), (47, 61), (9, 17)])
@pytest.mark.parametrize("mode", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [{}, {"restart_marker_blocks": 1},
                                     {"restart_marker_rows": 1}])
def test_pil_files_decode_to_pils_pixels(size, mode, restart):
    img = _image(*size, grey=mode == "grey")
    kw = dict(restart)
    if mode != "grey":
        kw["subsampling"] = SUBSAMPLING[mode]
    for quality in (30, 75, 100):
        data = _pil_jpeg(img, quality=quality, **kw)
        want = _pil_decode(data)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0"])
def test_noisy_frame_cpp_equals_plain_equals_pil(mode):
    """Full-range noise at 96x128: every Huffman category, clamped IDCT
    outputs, YCbCr values off the RGB gamut."""
    img = np.random.RandomState(3).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    data = _pil_jpeg(img, quality=95, subsampling=SUBSAMPLING[mode])
    fast, plain = jpeg.decode_jpeg(data), jpeg.decode_jpeg(data, plain=True)
    np.testing.assert_array_equal(fast, plain)
    np.testing.assert_array_equal(fast, _pil_decode(data))


@pytest.mark.parametrize("mode", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [0, 1, 7])
def test_fixture_encoder_files(mode, restart):
    img = _image(47, 61, seed=1, grey=mode == "grey")
    data = encode_jpeg(img, 80, "4:4:4" if mode == "grey" else mode, restart)
    want = _pil_decode(data)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)


def test_stages_agree():
    """The C++ IDCT and the numpy one on random coefficients (past the
    range real files give, so the range limit's wrap is exercised)."""
    rng = np.random.RandomState(0)
    coefs = rng.randint(-1024, 1024, (6, 64)).astype(np.int16)
    coefs[::2, 5:] = 0  # blocks with few coefficients
    qt = rng.randint(1, 40, 64).astype(np.uint16)
    plain = jpeg.idct_plain(coefs, 2, 3, qt)
    fast = np.empty((16, 24), np.uint8)
    jpeg._decoder().deepim_jpeg_idct(coefs.ctypes.data, 2, 3, qt.ctypes.data, fast.ctypes.data)
    np.testing.assert_array_equal(fast, plain)


def _replace_sof(data: bytes, marker: int, precision: int | None = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_unsupported_files_raise_naming_the_marker():
    img = _image(16, 16)
    base = _pil_jpeg(img)
    with pytest.raises(ValueError, match=r"lossless JPEG \(SOF3\)"):
        jpeg.decode_jpeg(_replace_sof(base, 0xC3))
    with pytest.raises(ValueError, match=r"arithmetic-coded JPEG \(SOF9\)"):
        jpeg.decode_jpeg(_replace_sof(base, 0xC9))
    with pytest.raises(ValueError, match=r"12-bit JPEG \(SOF0\)"):
        jpeg.decode_jpeg(_replace_sof(base, 0xC0, precision=12))
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="4 components"):
        jpeg.decode_jpeg(buf.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG....")


@pytest.mark.parametrize("plain", [False, True])
def test_truncated_and_corrupt_files_raise(plain):
    data = _pil_jpeg(_image(64, 64, noise=255), quality=95)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:len(data) // 2], plain=plain)
    rst = _pil_jpeg(_image(32, 32), restart_marker_blocks=1)
    i = rst.index(b"\xff\xd1")  # the second restart marker, renumbered
    bad = rst[:i + 1] + b"\xd5" + rst[i + 2:]
    with pytest.raises(ValueError, match="restart marker"):
        jpeg.decode_jpeg(bad, plain=plain)


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(png, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="false failed"):
        jpeg.decode_jpeg(_pil_jpeg(_image(8, 8)))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        jpeg.build_decoder()


def test_imread_picks_the_codec(tmp_path):
    img = _image(20, 30)
    png.write_png(str(tmp_path / "a.png"), img)
    (tmp_path / "b.jpg").write_bytes(_pil_jpeg(img, quality=90))
    (tmp_path / "c.bin").write_bytes(b"GIF89a")
    np.testing.assert_array_equal(jpeg.imread(str(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(jpeg.imread(str(tmp_path / "b.jpg")),
                                  _pil_decode((tmp_path / "b.jpg").read_bytes()))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        jpeg.imread(str(tmp_path / "c.bin"))


def _sos_count(data: bytes) -> int:
    return data.count(b"\xff\xda")


@pytest.mark.parametrize("size", [(48, 64), (47, 61), (9, 17)])
@pytest.mark.parametrize("mode", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [{}, {"restart_marker_blocks": 1},
                                     {"restart_marker_rows": 1}])
def test_progressive_pil_files_decode_to_pils_pixels(size, mode, restart):
    img = _image(*size, grey=mode == "grey")
    kw = dict(restart, progressive=True)
    if mode != "grey":
        kw["subsampling"] = SUBSAMPLING[mode]
    for quality in (30, 95):
        data = _pil_jpeg(img, quality=quality, **kw)
        assert b"\xff\xc2" in data and _sos_count(data) >= 6
        assert (b"\xff\xd0" in data) == bool(restart)
        want = _pil_decode(data)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:0"])
def test_progressive_noisy_frame_cpp_equals_plain_equals_pil(mode):
    """Full-range noise: long AC bands in every scan, corrections on most
    coefficients of the refine scans."""
    img = np.random.RandomState(5).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    data = _pil_jpeg(img, quality=95, subsampling=SUBSAMPLING[mode], progressive=True)
    fast, plain = jpeg.decode_jpeg(data), jpeg.decode_jpeg(data, plain=True)
    np.testing.assert_array_equal(fast, plain)
    np.testing.assert_array_equal(fast, _pil_decode(data))


@pytest.mark.parametrize("mode", ["grey", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [0, 1, 7])
def test_progressive_fixture_encoder_files(mode, restart):
    """The fixture encoder's progressive files (EOB runs across blocks, ZRLs
    and correction bits buffered across them) read alike in PIL, the C++
    and the plain decoder."""
    img = _image(47, 61, seed=2, grey=mode == "grey")
    data = encode_jpeg_progressive(img, 80, "4:4:4" if mode == "grey" else mode, restart)
    want = _pil_decode(data)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)


def test_progressive_file_without_its_last_refinement_raises():
    data = encode_jpeg_progressive(_image(16, 16), 80, "4:2:0")
    cut = data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"  # drop luma's last AC refinement
    with pytest.raises(ValueError, match="not fully refined"):
        jpeg.decode_jpeg(cut)


@pytest.mark.parametrize("plain", [False, True])
def test_progressive_truncated_file_raises(plain):
    data = _pil_jpeg(_image(64, 64, noise=255), quality=95, progressive=True)
    i = data.rindex(b"\xff\xda")  # into the last scan: every scan is there, cut short
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:i + 40] + b"\xff\xd9", plain=plain)
