// PNG row unfiltering (filters 0-4 of the PNG specification), host code.
//
// Input: the inflated image data, h rows of 1 filter byte + row_bytes
// bytes.  Output: h * row_bytes unfiltered bytes; with swap16 != 0 every
// byte pair is swapped afterwards (16-bit samples, big-endian in the file,
// to the host's little-endian order).  Only the C++ standard library: the
// inflation stays in Python's zlib.  Bound with ctypes, so a call runs
// without the GIL and a thread pool decodes frames in parallel.
//
// Returns 0, or -(1 + y) when row y has a filter type above 4.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

}  // namespace

extern "C" int deepim_png_unfilter(const uint8_t* raw, int64_t h, int64_t row_bytes,
                                   int32_t bpp, int32_t swap16, uint8_t* out) {
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
  if (swap16) {
    const int64_t n = h * row_bytes;
    for (int64_t i = 0; i + 1 < n; i += 2) {
      const uint8_t hi = out[i];
      out[i] = out[i + 1];
      out[i + 1] = hi;
    }
  }
  return 0;
}
