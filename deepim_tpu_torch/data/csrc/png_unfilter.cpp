// PNG row unfiltering (filters 0-4 of the PNG specification) and Adam7
// reassembly, host code.
//
// deepim_png_unfilter: the inflated image data of a non-interlaced image,
// h rows of 1 filter byte + row_bytes bytes -> h * row_bytes unfiltered
// bytes; with swap16 != 0 every byte pair is swapped afterwards (16-bit
// samples, big-endian in the file, to the host's little-endian order).
// Returns 0, or -(1 + y) when row y has a filter type above 4.
//
// deepim_png_adam7: the inflated data of an Adam7-interlaced image (seven
// reduced images, each its own filtered rows) -> the full image, one pixel
// after another: bits_pp / 8 bytes a pixel (16-bit samples stay
// big-endian), or for bits_pp < 8 (1-, 2- and 4-bit grey or palette) one
// byte a pixel holding its sample.  Returns 0, -(1 + y) for a bad filter
// byte in row y of a pass (rows counted across the passes), or -1000000
// when the data does not hold the seven passes.
//
// Only the C++ standard library: the inflation stays in Python's zlib.
// Bound with ctypes, so a call runs without the GIL and a thread pool
// decodes frames in parallel.

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// Unfilter h rows of `raw` (1 + row_bytes bytes each) into `out`
// (row_bytes each) -> 0, or -(1 + y) for a bad filter byte in row y.
int unfilter_rows(const uint8_t* raw, int64_t h, int64_t row_bytes, int32_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (row_bytes + 1);
    const int kind = src[0];
    ++src;
    uint8_t* dst = out + y * row_bytes;
    const uint8_t* up = y ? dst - row_bytes : nullptr;
    const int64_t lead = bpp < row_bytes ? bpp : row_bytes;
    switch (kind) {
      case 0:
        for (int64_t x = 0; x < row_bytes; ++x) dst[x] = src[x];
        break;
      case 1:
        for (int64_t x = 0; x < lead; ++x) dst[x] = src[x];
        for (int64_t x = lead; x < row_bytes; ++x) dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
        break;
      case 2:
        if (up) {
          for (int64_t x = 0; x < row_bytes; ++x) dst[x] = (uint8_t)(src[x] + up[x]);
        } else {
          for (int64_t x = 0; x < row_bytes; ++x) dst[x] = src[x];
        }
        break;
      case 3:
        for (int64_t x = 0; x < lead; ++x) dst[x] = (uint8_t)(src[x] + ((up ? up[x] : 0) >> 1));
        for (int64_t x = lead; x < row_bytes; ++x)
          dst[x] = (uint8_t)(src[x] + ((dst[x - bpp] + (up ? up[x] : 0)) >> 1));
        break;
      case 4:
        if (up) {
          for (int64_t x = 0; x < lead; ++x) dst[x] = (uint8_t)(src[x] + up[x]);  // a = c = 0
          for (int64_t x = lead; x < row_bytes; ++x)
            dst[x] = (uint8_t)(src[x] + paeth(dst[x - bpp], up[x], up[x - bpp]));
        } else {  // b = c = 0: Paeth picks a, as Sub does
          for (int64_t x = 0; x < lead; ++x) dst[x] = src[x];
          for (int64_t x = lead; x < row_bytes; ++x) dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
        }
        break;
      default:
        return (int)-(1 + y);
    }
  }
  return 0;
}

void swap_pairs(uint8_t* p, int64_t n) {
  for (int64_t i = 0; i + 1 < n; i += 2) {
    const uint8_t hi = p[i];
    p[i] = p[i + 1];
    p[i + 1] = hi;
  }
}

// (x0, y0, dx, dy) of the seven Adam7 passes.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

}  // namespace

extern "C" int deepim_png_unfilter(const uint8_t* raw, int64_t h, int64_t row_bytes,
                                   int32_t bpp, int32_t swap16, uint8_t* out) {
  const int code = unfilter_rows(raw, h, row_bytes, bpp, out);
  if (code) return code;
  if (swap16) swap_pairs(out, h * row_bytes);
  return 0;
}

extern "C" int deepim_png_adam7(const uint8_t* raw, int64_t raw_len, int64_t w, int64_t h,
                                int32_t bits_pp, uint8_t* out) {
  // bytes a pixel in the output, and the filters' byte distance
  const int32_t px = bits_pp >= 8 ? bits_pp / 8 : 1;
  std::vector<uint8_t> rows;
  int64_t pos = 0, rows_before = 0;
  for (const auto& p : kAdam7) {
    const int64_t pw = w > p[0] ? (w - p[0] + p[2] - 1) / p[2] : 0;
    const int64_t ph = h > p[1] ? (h - p[1] + p[3] - 1) / p[3] : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no rows at all
    const int64_t row_bytes = (pw * bits_pp + 7) / 8;
    if (pos + ph * (row_bytes + 1) > raw_len) return -1000000;
    rows.resize(ph * row_bytes);
    const int code = unfilter_rows(raw + pos, ph, row_bytes, px, rows.data());
    if (code) return (int)(code - rows_before);
    pos += ph * (row_bytes + 1);
    rows_before += ph;
    for (int64_t y = 0; y < ph; ++y) {
      const uint8_t* src = rows.data() + y * row_bytes;
      uint8_t* dst_row = out + ((p[1] + y * p[3]) * w + p[0]) * px;
      if (bits_pp >= 8) {
        for (int64_t x = 0; x < pw; ++x)
          for (int b = 0; b < px; ++b) dst_row[x * p[2] * px + b] = src[x * px + b];
      } else {  // samples packed most significant bits first
        const int per_byte = 8 / bits_pp, mask = (1 << bits_pp) - 1;
        for (int64_t x = 0; x < pw; ++x) {
          const int shift = 8 - bits_pp * (int)(x % per_byte + 1);
          dst_row[x * p[2]] = (uint8_t)((src[x / per_byte] >> shift) & mask);
        }
      }
    }
  }
  if (pos != raw_len) return -1000000;
  return 0;
}
