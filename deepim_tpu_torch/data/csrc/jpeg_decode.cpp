// Baseline and progressive (Huffman-coded, 8-bit) JPEG decoding, host code.
//
// Three stages, each a C function bound with ctypes (a call runs without
// the GIL), each the counterpart of a numpy/Python stage in jpeg.py:
//
//   deepim_jpeg_decode_scan  entropy-decode one scan's segment (restart
//                            markers included) into quantized coefficients
//                            in natural order, int16, 64 per block;
//                            deepim_jpeg_decode_prog_scan does the same for
//                            one scan of a progressive file (jdphuff.c's DC
//                            first / refine and AC first / refine, with EOB
//                            runs), adding to the coefficients the earlier
//                            scans left;
//   deepim_jpeg_idct         dequantize and inverse-DCT one component with
//                            libjpeg's integer "islow" IDCT (jidctint.c);
//   deepim_jpeg_finish       upsample chroma with libjpeg's fancy
//                            (triangle) filter (jdsample.c h2v1/h2v2) and
//                            convert YCbCr to RGB with its fixed-point
//                            tables (jdcolor.c).
//
// Those three are what libjpeg(-turbo) does by default, so the pixels are
// the ones PIL returns for the same file.  Only the C++ standard library.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A Huffman table from the DHT's 16 code-length counts and its values.
struct Huff {
  int32_t maxcode[17];  // largest code of each length, -1 if none
  int32_t offset[17];   // index into vals of a length's first code, less it
  uint8_t vals[256];
};

void build_huff(const uint8_t* spec, Huff& h) {  // spec: 16 counts, 256 values
  std::memcpy(h.vals, spec + 16, 256);
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = spec[l - 1];
    h.offset[l] = k - code;
    code += n;
    k += n;
    h.maxcode[l] = n ? code - 1 : -1;
    code <<= 1;
  }
}

// Reads bits MSB first, dropping the 0x00 after a stuffed 0xFF.  At a
// marker it stops and feeds zeros, counting them, so a read past the
// segment's data is seen (a truncated or corrupt file).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  int64_t fed_real = 0, fed_zero = 0;  // bits fed from data / as padding
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        if (p[0] == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
            fed_real += 8;
          } else {
            at_marker = true;
            fed_zero += 8;
          }
        } else {
          byte = *p++;
          fed_real += 8;
        }
      } else {
        fed_zero += 8;
      }
      acc = (acc << 8) | byte;
      n += 8;
    }
  }
  // Bits consumed beyond the data: nonzero means the data ran out.
  bool overran() const { return fed_real + fed_zero - n > fed_real; }
  uint32_t get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    n -= k;
    return (uint32_t)(acc >> n) & ((1u << k) - 1);
  }
  int decode(const Huff& h) {  // -> the symbol, or -1 for no such code
    if (n < 16) fill();
    for (int l = 1; l <= 16; ++l) {
      const int32_t code = (int32_t)(acc >> (n - l)) & ((1 << l) - 1);
      if (code <= h.maxcode[l]) {
        n -= l;
        return h.vals[h.offset[l] + code];
      }
    }
    return -1;
  }
};

inline int extend(uint32_t v, int s) {  // F.2.2.1: the sign from the top bit
  return s == 0 ? 0 : (v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v);
}

// -- islow IDCT (jidctint.c) -------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: x & 1023 indexes a table that clamps
// x + 128 to 0..255 (wrapping only far outside that range).
inline uint8_t idct_limit(int64_t x) {
  const int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

// One 8x8 pass: in[0..7 * stride] -> the eight outputs of the even/odd parts.
inline void idct_1d(const int64_t* in, int stride, int64_t out[8]) {
  int64_t z2 = in[2 * stride], z3 = in[6 * stride];
  int64_t z1 = (z2 + z3) * F0_541196100;
  const int64_t tmp2e = z1 + z3 * -F1_847759065;
  const int64_t tmp3e = z1 + z2 * F0_765366865;
  z2 = in[0];
  z3 = in[4 * stride];
  const int64_t tmp0e = (z2 + z3) * ((int64_t)1 << kConstBits);
  const int64_t tmp1e = (z2 - z3) * ((int64_t)1 << kConstBits);
  const int64_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int64_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;

  int64_t tmp0 = in[7 * stride], tmp1 = in[5 * stride], tmp2 = in[3 * stride],
          tmp3 = in[1 * stride];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  const int64_t z5 = (z3 + z4) * F1_175875602;
  tmp0 *= F0_298631336;
  tmp1 *= F2_053119869;
  tmp2 *= F3_072711026;
  tmp3 *= F1_501321110;
  z1 *= -F0_899976223;
  z2 *= -F2_562915447;
  z3 *= -F1_961570560;
  z4 *= -F0_390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// -- colour (jdcolor.c) -------------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// Upsample one component plane (cw x ch valid samples, row stride `stride`)
// by (fh, fv) in {1, 2}^2 into out (ch*fv rows of cw*fh samples).
void upsample(const uint8_t* in, int64_t stride, int64_t cw, int64_t ch, int fh, int fv,
              uint8_t* out) {
  const int64_t ow = cw * fh;
  if (fh == 1 && fv == 1) {
    for (int64_t y = 0; y < ch; ++y) std::memcpy(out + y * ow, in + y * stride, cw);
    return;
  }
  if (cw <= 2) {  // libjpeg's box filter where fancy upsampling needs 3 columns
    for (int64_t y = 0; y < ch * fv; ++y)
      for (int64_t x = 0; x < ow; ++x) out[y * ow + x] = in[(y / fv) * stride + x / fh];
    return;
  }
  if (fv == 1) {  // h2v1_fancy_upsample
    for (int64_t y = 0; y < ch; ++y) {
      const uint8_t* r = in + y * stride;
      uint8_t* o = out + y * ow;
      o[0] = r[0];
      o[1] = (uint8_t)((r[0] * 3 + r[1] + 2) >> 2);
      for (int64_t x = 1; x < cw - 1; ++x) {
        const int v = r[x] * 3;
        o[2 * x] = (uint8_t)((v + r[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + r[x + 1] + 2) >> 2);
      }
      o[2 * cw - 2] = (uint8_t)((r[cw - 1] * 3 + r[cw - 2] + 1) >> 2);
      o[2 * cw - 1] = r[cw - 1];
    }
    return;
  }
  // h2v2_fancy_upsample: the rows above the first and below the last are
  // those rows themselves (jdmainct.c's context rows).
  std::vector<int> sum(cw);
  for (int64_t y = 0; y < ch; ++y) {
    for (int v = 0; v < 2; ++v) {
      const int64_t y1 = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < ch ? y + 1 : ch - 1);
      const uint8_t* r0 = in + y * stride;
      const uint8_t* r1 = in + y1 * stride;
      for (int64_t x = 0; x < cw; ++x) sum[x] = r0[x] * 3 + r1[x];
      uint8_t* o = out + (2 * y + v) * ow;
      o[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
      o[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int64_t x = 1; x < cw - 1; ++x) {
        o[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        o[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      o[2 * cw - 2] = (uint8_t)((sum[cw - 1] * 3 + sum[cw - 2] + 8) >> 4);
      o[2 * cw - 1] = (uint8_t)((sum[cw - 1] * 4 + 7) >> 4);
    }
  }
}

}  // namespace

// comp: per scan component (h, v, dc table, ac table, offset of its plane in
// coefs in int16 units, plane width in blocks).  huff: 8 tables of 272
// bytes (DC 0-3, AC 0-3).  Returns 0, or -1 bad Huffman code, -2 data ran
// out, -3 missing restart marker, -4 run past coefficient 63.
extern "C" int deepim_jpeg_decode_scan(const uint8_t* data, int64_t len, int32_t ncomp,
                                       const int64_t* comp, const uint8_t* huff,
                                       int64_t mcus_x, int64_t mcus_y, int64_t restart,
                                       int16_t* coefs) {
  Huff tables[8];
  for (int i = 0; i < 8; ++i) build_huff(huff + 272 * i, tables[i]);
  Bits b{data, data + len};
  int pred[4] = {0, 0, 0, 0};
  const int64_t total = mcus_x * mcus_y;
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart && m && m % restart == 0) {
      if (b.overran()) return -2;
      b.n = 0;  // drop the padding bits of the last byte
      if (!b.at_marker) {  // fill() had not reached the marker yet
        if (b.p + 1 >= b.end || b.p[0] != 0xFF) return -3;
      }
      if (b.p + 1 >= b.end || b.p[1] != 0xD0 + (rst & 7)) return -3;
      b.p += 2;
      b.at_marker = false;
      b.acc = 0;
      b.fed_real = b.fed_zero = 0;
      ++rst;
      for (int c = 0; c < 4; ++c) pred[c] = 0;
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const int64_t* ci = comp + 6 * c;
      const Huff& dc = tables[ci[2]];
      const Huff& ac = tables[4 + ci[3]];
      for (int64_t by = 0; by < ci[1]; ++by) {
        for (int64_t bx = 0; bx < ci[0]; ++bx) {
          int16_t* blk = coefs + ci[4] + ((my * ci[1] + by) * ci[5] + mx * ci[0] + bx) * 64;
          const int s = b.decode(dc);
          if (s < 0) return -1;
          pred[c] += extend(b.get(s), s);
          blk[0] = (int16_t)pred[c];
          for (int k = 1; k < 64;) {
            const int rs = b.decode(ac);
            if (rs < 0) return -1;
            const int r = rs >> 4, sz = rs & 15;
            if (sz == 0) {
              if (r != 15) break;  // EOB
              k += 16;
              continue;
            }
            k += r;
            if (k > 63) return -4;
            blk[kNatural[k]] = (int16_t)extend(b.get(sz), sz);
            ++k;
          }
        }
      }
    }
  }
  return b.overran() ? -2 : 0;
}

// One scan of a progressive file: spectral band ss..se, successive
// approximation ah (the previous point transform, 0 on a first scan) and al
// (this scan's); the arguments otherwise as deepim_jpeg_decode_scan's.  A
// DC scan may interleave components; an AC scan has one.  Returns those
// codes (-2 where the data ran out before a bad code or run), or -5 for a
// band that is no band.
extern "C" int deepim_jpeg_decode_prog_scan(const uint8_t* data, int64_t len, int32_t ncomp,
                                            const int64_t* comp, const uint8_t* huff,
                                            int64_t mcus_x, int64_t mcus_y, int64_t restart,
                                            int32_t ss, int32_t se, int32_t ah, int32_t al,
                                            int16_t* coefs) {
  if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ncomp != 1) || al > 13)
    return -5;
  Huff tables[8];
  for (int i = 0; i < 8; ++i) build_huff(huff + 272 * i, tables[i]);
  Bits b{data, data + len};
  int pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  const int64_t total = mcus_x * mcus_y;
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart && m && m % restart == 0) {
      if (b.overran()) return -2;
      b.n = 0;
      if (!b.at_marker) {
        if (b.p + 1 >= b.end || b.p[0] != 0xFF) return -3;
      }
      if (b.p + 1 >= b.end || b.p[1] != 0xD0 + (rst & 7)) return -3;
      b.p += 2;
      b.at_marker = false;
      b.acc = 0;
      b.fed_real = b.fed_zero = 0;
      ++rst;
      for (int c = 0; c < 4; ++c) pred[c] = 0;
      eobrun = 0;
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const int64_t* ci = comp + 6 * c;
      const Huff& dc = tables[ci[2]];
      const Huff& ac = tables[4 + ci[3]];
      for (int64_t by = 0; by < ci[1]; ++by) {
        for (int64_t bx = 0; bx < ci[0]; ++bx) {
          int16_t* blk = coefs + ci[4] + ((my * ci[1] + by) * ci[5] + mx * ci[0] + bx) * 64;
          if (ss == 0) {
            if (ah == 0) {  // DC first: the difference, shifted up by al
              const int sz = b.decode(dc);
              if (sz < 0) return b.overran() ? -2 : -1;
              pred[c] += extend(b.get(sz), sz);
              blk[0] = (int16_t)(int)((unsigned)pred[c] << al);
            } else if (b.get(1)) {  // DC refine: one more bit
              blk[0] = (int16_t)(blk[0] | p1);
            }
            continue;
          }
          if (ah == 0) {  // AC first
            if (eobrun > 0) {
              --eobrun;
              continue;
            }
            for (int k = ss; k <= se; ++k) {
              const int rs = b.decode(ac);
              if (rs < 0) return b.overran() ? -2 : -1;
              const int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                if (k > se) return b.overran() ? -2 : -4;
                blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(b.get(sz), sz) << al);
              } else if (r == 15) {
                k += 15;  // ZRL
              } else {  // an EOB run of 2^r + the next r bits blocks, this one first
                eobrun = ((int64_t)1 << r) + b.get(r) - 1;
                break;
              }
            }
            continue;
          }
          // AC refine: new coefficients of magnitude 1 (at al), and one
          // correction bit for each coefficient already nonzero
          int k = ss;
          auto correct = [&](int16_t* coef) {
            if (b.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          };
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              const int rs = b.decode(ac);
              if (rs < 0) return b.overran() ? -2 : -1;
              int r = rs >> 4, value = 0;
              if (rs & 15) {
                value = b.get(1) ? p1 : m1;  // the size is 1 in a valid file
              } else if (r != 15) {
                eobrun = ((int64_t)1 << r) + b.get(r);
                break;
              }
              do {  // skip r zero coefficients, correcting the nonzero ones passed
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0) {
                  correct(coef);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (value) {
                if (k > se) return b.overran() ? -2 : -4;
                blk[kNatural[k]] = (int16_t)value;
              }
            }
          }
          if (eobrun > 0) {  // the rest of the band: corrections only
            for (; k <= se; ++k) {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) correct(coef);
            }
            --eobrun;
          }
        }
      }
    }
  }
  return b.overran() ? -2 : 0;
}

// coefs: (bh * bw) blocks of 64 natural-order quantized coefficients; qt:
// the quantization table in natural order; out: (bh * 8) x (bw * 8) samples.
extern "C" void deepim_jpeg_idct(const int16_t* coefs, int64_t bh, int64_t bw,
                                 const uint16_t* qt, uint8_t* out) {
  const int64_t stride = bw * 8;
  int64_t in[64], ws[64], col[8];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const int16_t* blk = coefs + (by * bw + bx) * 64;
      for (int i = 0; i < 64; ++i) in[i] = (int64_t)blk[i] * qt[i];
      for (int c = 0; c < 8; ++c) {  // pass 1: columns
        idct_1d(in + c, 8, col);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = descale(col[r], kConstBits - kPass1Bits);
      }
      for (int r = 0; r < 8; ++r) {  // pass 2: rows
        idct_1d(ws + r * 8, 1, col);
        uint8_t* o = out + (by * 8 + r) * stride + bx * 8;
        for (int c = 0; c < 8; ++c) o[c] = idct_limit(descale(col[c], kConstBits + kPass1Bits + 3));
      }
    }
  }
}

// planes[i]: component i's IDCT output (row stride strides[i]); dims[i] =
// (valid width, valid height, fh, fv): its upsampling factors.  transform:
// 0 grey, 1 YCbCr -> RGB, 2 RGB as stored.  out: (h, w) or (h, w, 3).
extern "C" void deepim_jpeg_finish(const uint8_t* const* planes, const int64_t* strides,
                                   const int64_t* dims, int32_t ncomp, int32_t transform,
                                   int64_t h, int64_t w, uint8_t* out) {
  std::vector<std::vector<uint8_t>> up(ncomp);
  std::vector<int64_t> upw(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* d = dims + 4 * c;
    upw[c] = d[0] * d[2];
    up[c].resize((size_t)(upw[c] * d[1] * d[3]));
    upsample(planes[c], strides[c], d[0], d[1], (int)d[2], (int)d[3], up[c].data());
  }
  if (transform == 0) {
    for (int64_t y = 0; y < h; ++y) std::memcpy(out + y * w, up[0].data() + y * upw[0], w);
    return;
  }
  static const YccTables t;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* p0 = up[0].data() + y * upw[0];
    const uint8_t* p1 = up[1].data() + y * upw[1];
    const uint8_t* p2 = up[2].data() + y * upw[2];
    uint8_t* o = out + y * w * 3;
    for (int64_t x = 0; x < w; ++x) {
      if (transform == 2) {
        o[3 * x] = p0[x];
        o[3 * x + 1] = p1[x];
        o[3 * x + 2] = p2[x];
        continue;
      }
      const int yy = p0[x], cb = p1[x], cr = p2[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}
