// The scans of a sequential or progressive Huffman JPEG (8-bit), decoded to
// an RGB image as cv2.imread decodes it through its bundled libjpeg-turbo at
// its defaults: the Huffman decode with the DC predictors and the restart
// markers; dequantisation and the slow-integer IDCT in the arithmetic of
// libjpeg-turbo's x86 SIMD version of jidctint.c (16-bit dequantised
// coefficients and sums, a saturating 16-bit workspace, the output clamped),
// which cv2 takes on x86-64; the chroma upsampling of jdsample.c (fancy h2v1,
// h2v2 and h1v2; box replication where a component is 2 samples wide or less,
// or the factors are other integers); the fixed-point YCbCr to RGB of
// jdcolor.c, its YCCK to CMYK, and OpenCV's CMYK to BGR.
//
// A file of one sequential scan of every component is decoded MCU by MCU
// straight into sample planes (jpeg_decode). Any other file, progressive or
// sequential in several scans, is decoded scan by scan into per-component
// buffers of quantised coefficients (jpeg_decode_scans: jdphuff.c's DC and
// AC first and refinement scans with their EOB runs, jdhuff.c's sequential
// blocks), then one output pass dequantises, transforms, upsamples and
// converts them (jdcoefct.c's decompress_data; for a progressive file whose
// scans leave one of the first ten coefficients unrefined, as one cut off
// after its first scans, decompress_smooth_data's block smoothing).
//
// Host code: the frame decoder (data/jpeg.py) parses the markers and calls
// these routines through ctypes, which releases the interpreter lock, so the
// Loader's threads decode frames in parallel. ops/cuda_build.py compiles this
// file with the host C++ compiler at first use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// the natural (row-major) index of each zigzag position, then 16 entries of
// 63 so that a corrupt run past the block's end stays inside it
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Error : int64_t {
  kOk = 0,
  kTruncated = 1,     // the scan ends before its last block
  kBadCode = 2,       // a bit string that is no code of the table
  kBadRestart = 3,    // a missing or misnumbered RSTn marker
  kBadTable = 4,      // a Huffman table that libjpeg refuses (see build_huffman)
  kMissingTable = 5,  // a scan component names an undefined Huffman table
  kBadProgression = 6,  // scan parameters libjpeg refuses (JERR_BAD_PROGRESSION)
  kScanEndsEarly = 8,   // a scan's data ends at a marker before its last block
};

constexpr int kFastBits = 9;

struct Huffman {
  uint16_t fast[1 << kFastBits];  // (length << 8) | symbol for codes of <= 9 bits; 0: a longer code
  // an AC table's codes with their magnitude bits in <= 9 bits: (value << 8) | (run << 4) | total length; 0: none
  int32_t fast_ac[1 << kFastBits];
  int32_t maxcode[17];            // the largest code of each length, -1 where none
  int32_t valptr[17];             // the index in symbols of each length's first code, less that code
  uint8_t symbols[256];
  bool present;
};

// counts: the number of codes of each length 1-16; symbols: in code order.
// Refuses what libjpeg's jpeg_make_d_derived_tbl refuses: more than 256
// codes, a length whose codes do not fit in its bits with the all-ones code
// left free (checked before that length's codes are written), a DC symbol
// past 15.
bool build_huffman(const uint8_t* counts, const uint8_t* symbols, bool dc, Huffman& h) {
  std::memset(&h, 0, sizeof(h));
  int total = 0;
  for (int l = 0; l < 16; ++l) total += counts[l];
  if (total == 0) return true;  // absent
  if (total > 256) return false;
  std::memcpy(h.symbols, symbols, total);
  for (int k = 0; k < total && dc; ++k)
    if (h.symbols[k] > 15) return false;
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = counts[l - 1];
    if (code + n >= (1 << l)) return false;
    h.valptr[l] = k - code;
    h.maxcode[l] = n ? code + n - 1 : -1;
    for (int i = 0; i < n; ++i, ++k, ++code) {
      if (l <= kFastBits) {
        const int shift = kFastBits - l;
        for (int j = 0; j < (1 << shift); ++j) h.fast[(code << shift) | j] = static_cast<uint16_t>((l << 8) | h.symbols[k]);
      }
    }
    code <<= 1;
  }
  for (int i = 0; i < (1 << kFastBits); ++i) {  // a code and its magnitude bits looked up at once
    const int l = h.fast[i] >> 8, rs = h.fast[i] & 0xFF, size = rs & 15;
    if (!h.fast[i] || !size || l + size > kFastBits) continue;
    int32_t v = (i >> (kFastBits - l - size)) & ((1 << size) - 1);
    if (v < (1 << (size - 1))) v += 1 - (1 << size);
    h.fast_ac[i] = static_cast<int32_t>(static_cast<uint32_t>(v) << 8) | ((rs >> 4) << 4) | (l + size);
  }
  h.present = true;
  return true;
}

// The entropy-coded bits, MSB first, with the 0xFF00 stuffing removed. At a
// marker (or the data's end) it feeds zero bits and stops counting them as
// real: a decode that consumes one has run past the data.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;   // n bits, MSB-aligned
  int n = 0;
  int64_t real = 0;   // real bits among the n, less those consumed past them
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint64_t byte = 0;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          byte = *p++;
          real += 8;
        } else if (p + 1 < end && p[1] == 0x00) {
          byte = 0xFF;
          p += 2;
          real += 8;
        } else {
          at_marker = true;
        }
      }
      buf |= byte << (56 - n);
      n += 8;
    }
  }
  void skip(int k) {
    buf <<= k;
    n -= k;
    real -= k;
  }
  // k (1-16) bits as an unsigned value
  uint32_t get(int k) {
    if (n < k) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - k));
    skip(k);
    return v;
  }
  // the next RSTn: the rest of the current byte is padding; returns false
  // unless the marker RST(expected) follows
  bool restart(int expected) {
    if (real >= 8 || real < 0) return false;
    while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;  // fill bytes before the marker
    if (!(p + 1 < end && p[0] == 0xFF && p[1] == 0xD0 + expected)) return false;
    p += 2;
    buf = 0;
    n = 0;
    real = 0;
    at_marker = false;
    return true;
  }
};

inline int decode(Bits& b, const Huffman& h) {
  if (b.n < 16) b.fill();
  const uint16_t e = h.fast[b.buf >> (64 - kFastBits)];
  if (e) {
    b.skip(e >> 8);
    return e & 0xFF;
  }
  const uint32_t code16 = static_cast<uint32_t>(b.buf >> 48);
  for (int l = kFastBits + 1; l <= 16; ++l) {
    const int32_t code = static_cast<int32_t>(code16 >> (16 - l));
    if (code <= h.maxcode[l]) {
      b.skip(l);
      return h.symbols[h.valptr[l] + code];
    }
  }
  return -1;
}

// JPEG's magnitude category: s bits, a value below 2^(s-1) is negative
inline int32_t receive_extend(Bits& b, int s) {
  if (s == 0) return 0;
  const int32_t v = static_cast<int32_t>(b.get(s));
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// one block's coefficients (natural order, zeroed by the caller)
int64_t decode_block(Bits& b, const Huffman& dc, const Huffman& ac, int32_t& pred, int16_t* coef) {
  const int s = decode(b, dc);
  if (s < 0 || s > 15) return kBadCode;
  pred += receive_extend(b, s);
  coef[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64; ++k) {
    if (b.n < 16) b.fill();
    const int32_t f = ac.fast_ac[b.buf >> (64 - kFastBits)];
    if (f) {
      b.skip(f & 15);
      k += (f >> 4) & 15;
      coef[kNatural[k]] = static_cast<int16_t>(f >> 8);
      continue;
    }
    const int rs = decode(b, ac);
    if (rs < 0) return kBadCode;
    const int r = rs >> 4, size = rs & 15;
    if (size) {
      k += r;
      coef[kNatural[k]] = static_cast<int16_t>(receive_extend(b, size));
    } else {
      if (r != 15) break;  // end of block
      k += 15;             // sixteen zeros
    }
  }
  return b.real < 0 ? kTruncated : kOk;
}

// --- the slow-integer IDCT, as libjpeg-turbo's SIMD version computes it ----

inline int32_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t sat16(int32_t x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); }
// (x + 2^(n-1)) >> n of a 32-bit sum, which wraps as the SIMD code's adds do
inline int32_t descale(uint32_t x, int n) { return static_cast<int32_t>(x + (1u << (n - 1))) >> n; }

constexpr uint32_t F029 = 2446, F039 = 3196, F054 = 4433, F076 = 6270, F089 = 7373, F117 = 9633, F150 = 12299,
                   F184 = 15137, F196 = 16069, F205 = 16819, F256 = 20995, F307 = 25172;

// One 1-D pass over 8 values in[0], in[s], ..., in[7 s] (16-bit inputs; the
// sums in0 +- in4, in7 + in3 and in5 + in1 in 16 bits, the products and their
// sums in 32, unsigned so that they wrap), descaled by `shift` into out[0],
// out[s], ... The products are paired as the SIMD code pairs them; with no
// overflow this equals jidctint.c's pass exactly.
inline void idct_1d(const int32_t* in, int32_t* out, int s, int shift) {
  const uint32_t z2 = in[2 * s], z3 = in[6 * s];
  const uint32_t tmp2 = z2 * F054 + z3 * (F054 - F184);
  const uint32_t tmp3 = z2 * (F054 + F076) + z3 * F054;
  const uint32_t t0 = static_cast<uint32_t>(wrap16(in[0] + in[4 * s])) << 13;
  const uint32_t t1 = static_cast<uint32_t>(wrap16(in[0] - in[4 * s])) << 13;
  const uint32_t tmp10 = t0 + tmp3, tmp13 = t0 - tmp3, tmp11 = t1 + tmp2, tmp12 = t1 - tmp2;

  const uint32_t i7 = in[7 * s], i5 = in[5 * s], i3 = in[3 * s], i1 = in[s];
  const uint32_t z3o = wrap16(in[7 * s] + in[3 * s]), z4o = wrap16(in[5 * s] + in[s]);
  const uint32_t z3s = z3o * (F117 - F196) + z4o * F117;
  const uint32_t z4s = z3o * F117 + z4o * (F117 - F039);
  const uint32_t o0 = i7 * (F029 - F089) - i1 * F089 + z3s;
  const uint32_t o3 = i1 * (F150 - F089) - i7 * F089 + z4s;
  const uint32_t o1 = i5 * (F205 - F256) - i3 * F256 + z4s;
  const uint32_t o2 = i3 * (F307 - F256) - i5 * F256 + z3s;

  out[0] = descale(tmp10 + o3, shift);
  out[7 * s] = descale(tmp10 - o3, shift);
  out[s] = descale(tmp11 + o2, shift);
  out[6 * s] = descale(tmp11 - o2, shift);
  out[2 * s] = descale(tmp12 + o1, shift);
  out[5 * s] = descale(tmp12 - o1, shift);
  out[3 * s] = descale(tmp13 + o0, shift);
  out[4 * s] = descale(tmp13 - o0, shift);
}

// coef: natural order; q: the quantisation table, natural order; out: 8 rows
// of 8 samples, `stride` bytes apart
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int64_t stride) {
  int32_t in[64], ws[64], res[64];
  bool dc_only = true;  // every column's vertical AC terms zero: pass 1 is a shift
  for (int i = 8; i < 64 && dc_only; ++i) dc_only = coef[i] == 0;
  if (dc_only) {
    for (int c = 0; c < 8; ++c) {
      const int32_t v = wrap16(wrap16(coef[c] * static_cast<int32_t>(q[c])) * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  } else {
    for (int i = 0; i < 64; ++i) in[i] = wrap16(coef[i] * static_cast<int32_t>(q[i]));
    for (int c = 0; c < 8; ++c) idct_1d(in + c, ws + c, 8, 13 - 2);  // the columns
    for (int i = 0; i < 64; ++i) ws[i] = sat16(ws[i]);
  }
  for (int r = 0; r < 8; ++r) idct_1d(ws + r * 8, res + r * 8, 1, 13 + 2 + 3);  // the rows
  for (int r = 0; r < 8; ++r) {
    uint8_t* o = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = res[r * 8 + c];
      o[c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// --- chroma upsampling (jdsample.c) -----------------------------------------

// src: a (dh, dw) plane, `sstride` apart; dst: the (dh * vexp, dw * hexp)
// result, `dstride` apart
void upsample(const uint8_t* src, int64_t sstride, int dh, int dw, int hexp, int vexp, uint8_t* dst,
              int64_t dstride) {
  if (hexp == 2 && vexp == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int32_t> sum(dw + 2);
    for (int y = 0; y < 2 * dh; ++y) {
      const int near = y >> 1;
      int far = (y & 1) ? near + 1 : near - 1;
      far = far < 0 ? 0 : (far >= dh ? dh - 1 : far);
      const uint8_t* a = src + near * sstride;
      const uint8_t* b = src + far * sstride;
      for (int x = 0; x < dw; ++x) sum[x + 1] = 3 * a[x] + b[x];
      sum[0] = sum[1];
      sum[dw + 1] = sum[dw];
      uint8_t* o = dst + y * dstride;
      for (int x = 0; x < dw; ++x) {
        o[2 * x] = static_cast<uint8_t>((3 * sum[x + 1] + sum[x] + 8) >> 4);
        o[2 * x + 1] = static_cast<uint8_t>((3 * sum[x + 1] + sum[x + 2] + 7) >> 4);
      }
    }
  } else if (hexp == 2 && vexp == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < dh; ++y) {
      const uint8_t* a = src + y * sstride;
      uint8_t* o = dst + y * dstride;
      for (int x = 0; x < dw; ++x) {
        const int left = a[x > 0 ? x - 1 : 0], right = a[x < dw - 1 ? x + 1 : dw - 1];
        o[2 * x] = static_cast<uint8_t>((3 * a[x] + left + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((3 * a[x] + right + 2) >> 2);
      }
    }
  } else if (hexp == 1 && vexp == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < 2 * dh; ++y) {
      const int near = y >> 1;
      int far = (y & 1) ? near + 1 : near - 1;
      far = far < 0 ? 0 : (far >= dh ? dh - 1 : far);
      const int bias = (y & 1) ? 2 : 1;
      const uint8_t* a = src + near * sstride;
      const uint8_t* b = src + far * sstride;
      uint8_t* o = dst + y * dstride;
      for (int x = 0; x < dw; ++x) o[x] = static_cast<uint8_t>((3 * a[x] + b[x] + bias) >> 2);
    }
  } else {  // fullsize, h2v1 / h2v2 box, int_upsample
    for (int y = 0; y < dh * vexp; ++y) {
      const uint8_t* a = src + (y / vexp) * sstride;
      uint8_t* o = dst + y * dstride;
      for (int x = 0; x < dw * hexp; ++x) o[x] = a[x / hexp];
    }
  }
}

inline uint8_t clamp255(int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

enum Colour { kGrey = 0, kYCbCr = 1, kRGB = 2, kCMYK = 3, kYCCK = 4, kRaw = 5 };

// jdcolor.c's YCbCr to RGB: SCALEBITS 16, the four tables, ONE_HALF rounding
struct YccTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t{1} << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int32_t>((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = static_cast<int32_t>((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = static_cast<int32_t>(-46802 * x);                     // -FIX(0.71414)
      cb_g[i] = static_cast<int32_t>(-22554 * x + one_half);          // -FIX(0.34414), + ONE_HALF
    }
  }
};

// A frame component's samples for the output: at least its own (height,
// width) samples, `stride` apart, to be upsampled hexp x vexp.
struct Samples {
  const uint8_t* px;
  int64_t stride;
  int width, height, hexp, vexp;
};

// Every component at full size (upsampled where it is subsampled; the
// upsampling replicates a component's last row and column, and reads nothing
// past them), then converted to `out`, (H, W, 3) RGB: grey replicated, YCbCr
// through jdcolor.c's tables, RGB copied, CMYK (YCCK first turned to CMYK as
// jdcolor.c's ycck_cmyk_convert does) through OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
// on the stored samples: R = K - ((255 - C) K >> 8), G from M, B from Y alike.
void finish(int W, int H, int nc, int colour, const Samples* comp, uint8_t* out) {
  std::vector<uint8_t> full[4];
  const uint8_t* rows[4];
  int64_t strides[4];
  for (int c = 0; c < nc; ++c) {
    const Samples& s = comp[c];
    if (s.hexp == 1 && s.vexp == 1) {
      rows[c] = s.px;
      strides[c] = s.stride;
      continue;
    }
    const int64_t fw = static_cast<int64_t>(s.width) * s.hexp;
    full[c].resize(fw * s.height * s.vexp);
    upsample(s.px, s.stride, s.height, s.width, s.hexp, s.vexp, full[c].data(), fw);
    rows[c] = full[c].data();
    strides[c] = fw;
  }

  if (colour == kYCbCr) {
    const YccTables t;
    for (int y = 0; y < H; ++y) {
      const uint8_t* py = rows[0] + y * strides[0];
      const uint8_t* pb = rows[1] + y * strides[1];
      const uint8_t* pr = rows[2] + y * strides[2];
      uint8_t* o = out + static_cast<int64_t>(y) * W * 3;
      for (int x = 0; x < W; ++x) {
        const int32_t yy = py[x], cb = pb[x], cr = pr[x];
        o[3 * x] = clamp255(yy + t.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
      }
    }
  } else if (colour == kCMYK || colour == kYCCK) {
    const YccTables t;
    for (int y = 0; y < H; ++y) {
      const uint8_t* p[4];
      for (int c = 0; c < 4; ++c) p[c] = rows[c] + y * strides[c];
      uint8_t* o = out + static_cast<int64_t>(y) * W * 3;
      for (int x = 0; x < W; ++x) {
        int32_t cmy[3] = {p[0][x], p[1][x], p[2][x]};
        const int32_t k = p[3][x];
        if (colour == kYCCK) {
          const int32_t yy = cmy[0], cb = cmy[1], cr = cmy[2];
          cmy[0] = 255 - clamp255(yy + t.cr_r[cr]);
          cmy[1] = 255 - clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          cmy[2] = 255 - clamp255(yy + t.cb_b[cb]);
        }
        for (int ch = 0; ch < 3; ++ch) o[3 * x + ch] = static_cast<uint8_t>(k - (((255 - cmy[ch]) * k) >> 8));
      }
    }
  } else if (colour == kRaw) {
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + static_cast<int64_t>(y) * W * nc;
      for (int x = 0; x < W; ++x)
        for (int c = 0; c < nc; ++c) o[nc * x + c] = rows[c][y * strides[c] + x];
    }
  } else {
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + static_cast<int64_t>(y) * W * 3;
      for (int x = 0; x < W; ++x)
        for (int ch = 0; ch < 3; ++ch) o[3 * x + ch] = rows[nc == 1 ? 0 : ch][y * strides[nc == 1 ? 0 : ch] + x];
    }
  }
}

// --- progressive scans (jdphuff.c) ------------------------------------------

// a coefficient scaled by the point transform and stored as a 16-bit JCOEF
inline int16_t shifted(int32_t v, int al) { return static_cast<int16_t>(static_cast<uint32_t>(v) << al); }

// DC first: the difference from the component's predictor, shifted left by Al
int64_t decode_dc_first(Bits& b, const Huffman& dc, int al, int32_t& pred, int16_t* blk) {
  const int s = decode(b, dc);
  if (s < 0 || s > 15) return kBadCode;
  pred += receive_extend(b, s);
  blk[0] = shifted(pred, al);
  return kOk;
}

// DC refinement: one raw bit, OR-ed in at 1 << Al
void decode_dc_refine(Bits& b, int al, int16_t* blk) {
  if (b.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

// AC first: the band Ss..Se of one block, or one block of an EOB run
int64_t decode_ac_first(Bits& b, const Huffman& ac, int ss, int se, int al, uint32_t& eobrun, int16_t* blk) {
  if (eobrun) {
    --eobrun;
    return kOk;
  }
  for (int k = ss; k <= se; ++k) {
    if (b.n < 16) b.fill();
    const int32_t f = ac.fast_ac[b.buf >> (64 - kFastBits)];
    if (f) {
      b.skip(f & 15);
      k += (f >> 4) & 15;
      blk[kNatural[k]] = shifted(f >> 8, al);
      continue;
    }
    const int rs = decode(b, ac);
    if (rs < 0) return kBadCode;
    const int r = rs >> 4, size = rs & 15;
    if (size) {
      k += r;
      blk[kNatural[k]] = shifted(receive_extend(b, size), al);
    } else if (r == 15) {
      k += 15;
    } else {  // EOBr: this band and the next (1 << r) + (r bits) - 1 bands are zero
      eobrun = (1u << r) + (r ? b.get(r) : 0) - 1;
      break;
    }
  }
  return kOk;
}

// a correction bit for a coefficient already nonzero: adds 1 << Al to its
// magnitude where the bit is set (once: a bit already there is left)
inline void correct(Bits& b, int p1, int16_t* coef) {
  if (b.get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : -p1));
}

// AC refinement, as decode_mcu_AC_refine: the next bit of every coefficient
// of the band already nonzero, interleaved with the coefficients that become
// +-(1 << Al) and the zero runs before them, which skip nonzero positions
int64_t decode_ac_refine(Bits& b, const Huffman& ac, int ss, int se, int al, uint32_t& eobrun, int16_t* blk) {
  const int p1 = 1 << al;
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      const int rs = decode(b, ac);
      if (rs < 0) return kBadCode;
      int r = rs >> 4, s = rs & 15;
      if (s) {  // a newly nonzero coefficient (its size should be 1), its sign in the next bit
        s = b.get(1) ? p1 : -p1;
      } else if (r != 15) {  // EOBr: the rest of this band and of the next (1 << r) + (r bits) - 1
        eobrun = (1u << r) + (r ? b.get(r) : 0);
        break;
      }
      do {  // past r zero coefficients, correcting each nonzero one on the way
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          correct(b, p1, coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun > 0) {  // the band's remaining nonzero coefficients take their correction bits
    for (; k <= se; ++k)
      if (blk[kNatural[k]] != 0) correct(b, p1, blk + kNatural[k]);
    --eobrun;
  }
  return kOk;
}

// One frame component of a multi-scan decode: its layout (see _Geometry in
// data/jpeg.py), its coefficient buffer over the MCU-padded block grid, and
// libjpeg's coef_bits (per zigzag position, the Al of the last scan that
// held it, -1 before any).
struct Component {
  int h, v, width, height, block_cols, block_rows, grid_cols;
  std::vector<int16_t> coef;
  int coef_bits[64];
};

enum Kind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

constexpr int kScanFields = 21;

// the natural positions of zigzag 0-9, the coefficients block smoothing
// estimates: Q00, Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30
constexpr int kSmoothed[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// libjpeg's smoothing_ok after the last scan (jdcoefct.c): every quantisation
// table latched with its first ten values (zigzag) nonzero, every DC known,
// and one of the first ten coefficients of some component not refined to its
// last bit. Its coef_bits latch is each component's coef_bits as the last
// scan left them: a scan cut short raises, so no scan is still in progress.
bool needs_smoothing(const std::vector<Component>& comps, const uint16_t* quant) {
  bool useful = false;
  for (size_t c = 0; c < comps.size(); ++c) {
    for (const int p : kSmoothed)
      if (quant[64 * c + p] == 0) return false;
    if (comps[c].coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k) useful |= comps[c].coef_bits[k] != 0;
  }
  return useful;
}

// a coefficient estimate num / (q * 256), rounded half away from zero, its
// magnitude kept below 2^al where the coefficient's last scan had al > 0
inline int16_t estimate(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// jdcoefct.c's decompress_smooth_data for block (by, bx) of component p, whose
// frame has T iMCU rows: its coefficients copied into ws, with each of zigzag
// 1-9 that is zero and not known to its last bit estimated from the DC values
// of the 5x5 blocks around it; where no AC coefficient of the component is
// known at all (change_dc), the DC too, by a Gaussian-like kernel. The
// neighbours' columns clamp at the component's edges; their rows clamp by
// libjpeg's own rule, which counts the image's block rows with this iMCU
// row's count (so in the last iMCU row of a component with v > 1 the clamp
// may fall a row early), and may read a row of the MCU padding below the
// image, which holds the DC that an interleaved scan decoded there.
void smooth_block(const Component& p, const uint16_t* q, int T, int by, int bx, int16_t* ws) {
  const int16_t* coef = p.coef.data();
  std::memcpy(ws, coef + (static_cast<int64_t>(by) * p.grid_cols + bx) * 64, 64 * sizeof(int16_t));
  const int r = by / p.v;
  int block_rows = p.v;
  if (r == T - 1) {
    block_rows = p.block_rows % p.v;
    if (block_rows == 0) block_rows = p.v;
  }
  const int ibr = r * block_rows + by % p.v, ibrs = block_rows * T;
  int rows[5];
  rows[2] = by;
  rows[1] = ibr > 0 ? by - 1 : by;
  rows[0] = ibr > 1 ? by - 2 : rows[1];
  rows[3] = ibr < ibrs - 1 ? by + 1 : by;
  rows[4] = ibr < ibrs - 2 ? by + 2 : rows[3];
  int dc[26];  // DC01-DC25 as libjpeg names them: row-major over the 5x5 neighbourhood
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 5; ++j) {
      int x = bx + j - 2;
      x = x < 0 ? 0 : (x > p.block_cols - 1 ? p.block_cols - 1 : x);
      dc[1 + 5 * i + j] = coef[(static_cast<int64_t>(rows[i]) * p.grid_cols + x) * 64];
    }
  }
  const int* bits = p.coef_bits;
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
  int64_t Q[10];
  for (int k = 0; k < 10; ++k) Q[k] = q[kSmoothed[k]];
  const int* D = dc;
  int64_t num[10];
  if (change_dc) {
    num[1] = -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] -
             38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25];
    num[2] = -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] +
             D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25];
    num[3] = D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] +
             2 * D[19] + D[23];
    num[4] = -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25];
    num[5] = 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] -
             5 * D[18] + 2 * D[19];
    num[6] = D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19];
    num[7] = D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19];
    num[8] = D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19];
    num[9] = D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19];
  } else {
    num[1] = -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15];
    num[2] = -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23];
    num[3] = -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23];
    num[4] = D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] - D[6] + 10 * D[7] -
             10 * D[9];
    num[5] = -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15];
  }
  for (int k = 1; k < (change_dc ? 10 : 6); ++k) {
    const int pos = kSmoothed[k];
    if (bits[k] != 0 && ws[pos] == 0) ws[pos] = estimate(Q[0] * num[k], Q[k], bits[k]);
  }
  if (change_dc) {
    const int64_t n0 = -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] + 42 * D[8] +
                       6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] -
                       6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] - 6 * D[22] -
                       8 * D[23] - 6 * D[24] - 2 * D[25];
    ws[0] = estimate(Q[0] * n0, Q[0], 0);
  }
}

}  // namespace

// Decodes the scan whose entropy-coded data starts at `scan` (its first
// `scan_len` bytes hold it, and may run on past it) into `out`, a (height,
// width, 3) RGB uint8 array (for colour 5, (height, width, components)).
//   frame: width, height, the number of frame components (1, 3 or 4), the
//          restart interval in MCUs (0: none), colour (0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK, 5 raw);
//   comps: per scan component, in scan order: its frame index, h, v, DC table, AC table;
//   quant: per frame component, in frame order, its 64 quantisation values, natural order;
//   huff:  the 4 DC then the 4 AC tables, each 16 code counts then 256 symbols (all counts 0: absent).
// Returns 0 or an Error.
extern "C" int64_t jpeg_decode(const uint8_t* scan, int64_t scan_len, const int32_t* frame, const int32_t* comps,
                               const uint16_t* quant, const uint8_t* huff, uint8_t* out) {
  const int W = frame[0], H = frame[1], nc = frame[2], restart = frame[3], colour = frame[4];
  Huffman tables[8];  // built where the scan names them, as libjpeg builds them
  bool built[8] = {};
  for (int c = 0; c < nc; ++c) {
    for (const int t : {comps[c * 5 + 3], 4 + comps[c * 5 + 4]}) {
      if (built[t]) continue;
      if (!build_huffman(huff + t * 272, huff + t * 272 + 16, t < 4, tables[t])) return kBadTable;
      built[t] = true;
    }
  }

  int hmax = 1, vmax = 1;
  for (int c = 0; c < nc && nc > 1; ++c) {
    hmax = comps[c * 5 + 1] > hmax ? comps[c * 5 + 1] : hmax;
    vmax = comps[c * 5 + 2] > vmax ? comps[c * 5 + 2] : vmax;
  }
  // a single-component scan is not interleaved: an MCU is one block, the
  // blocks cover the component alone
  const int mcux = nc == 1 ? (W + 7) / 8 : (W + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = nc == 1 ? (H + 7) / 8 : (H + 8 * vmax - 1) / (8 * vmax);
  struct Plane {
    std::vector<uint8_t> px;
    int64_t stride;
    int h, v, frame_index;
    const Huffman* dc;
    const Huffman* ac;
    const uint16_t* q;
    int32_t pred;
  };
  std::vector<Plane> planes(nc);
  for (int c = 0; c < nc; ++c) {
    Plane& p = planes[c];
    p.frame_index = comps[c * 5];
    p.h = nc == 1 ? 1 : comps[c * 5 + 1];
    p.v = nc == 1 ? 1 : comps[c * 5 + 2];
    p.dc = &tables[comps[c * 5 + 3]];
    p.ac = &tables[4 + comps[c * 5 + 4]];
    if (!p.dc->present || !p.ac->present) return kMissingTable;
    p.q = quant + 64 * p.frame_index;
    p.stride = static_cast<int64_t>(mcux) * p.h * 8;
    p.px.resize(p.stride * mcuy * p.v * 8);
    p.pred = 0;
  }

  Bits bits{scan, scan + scan_len};
  int16_t coef[64];
  int64_t err = kOk;
  const int64_t n_mcu = static_cast<int64_t>(mcux) * mcuy;
  for (int64_t m = 0; m < n_mcu && err == kOk; ++m) {
    if (restart && m && m % restart == 0) {
      if (!bits.restart(static_cast<int>((m / restart - 1) % 8))) {
        err = bits.real < 0 ? kTruncated : kBadRestart;
        break;
      }
      for (Plane& p : planes) p.pred = 0;
    }
    const int64_t my = m / mcux, mx = m % mcux;
    for (Plane& p : planes) {
      for (int dy = 0; dy < p.v && err == kOk; ++dy) {
        for (int dx = 0; dx < p.h && err == kOk; ++dx) {
          std::memset(coef, 0, sizeof(coef));
          err = decode_block(bits, *p.dc, *p.ac, p.pred, coef);
          if (err == kOk) {
            uint8_t* o = p.px.data() + (my * p.v + dy) * 8 * p.stride + (mx * p.h + dx) * 8;
            idct_islow(coef, p.q, o, p.stride);
          }
        }
      }
    }
  }
  if (err != kOk) return err;

  Samples samples[4];
  for (const Plane& p : planes) {
    const int hexp = hmax / p.h, vexp = vmax / p.v;
    // the component's own size
    samples[p.frame_index] = {p.px.data(), p.stride, (W + hexp - 1) / hexp, (H + vexp - 1) / vexp, hexp, vexp};
  }
  finish(W, H, nc, colour, samples, out);
  return kOk;
}

// Decodes a progressive file, or a sequential one in several scans, into
// `out`, a (height, width, 3) RGB uint8 array (as jpeg_decode's): each scan into the components'
// coefficient buffers, then the output pass over them.
//   data:     the file;
//   frame:    width, height, the number of frame components (1, 3 or 4), colour (as jpeg_decode's), progressive;
//   sampling: per frame component, h and v (1 and 1 in a grey frame);
//   quant:    per frame component, its 64 quantisation values as latched at its first scan (zeros if none);
//   scans:    per scan, kScanFields values: the offset and length of its entropy-coded data, whether that data
//             runs to the file's end, its restart interval, its component count, Ss, Se, Ah, Al, then per
//             scan component its frame index and the slots of its DC and AC tables (-1: not decoded with one);
//   classes:  per table slot, 0 DC or 1 AC; huff: per slot, 16 code counts then 256 symbols.
// Returns 0, an Error, or a scan's Error | (the scan's index << 8).
extern "C" int64_t jpeg_decode_scans(const uint8_t* data, const int32_t* frame, const int32_t* sampling,
                                     const uint16_t* quant, int64_t n_scans, const int64_t* scans, int64_t n_tables,
                                     const uint8_t* classes, const uint8_t* huff, uint8_t* out) {
  const int W = frame[0], H = frame[1], nc = frame[2], colour = frame[3];
  const bool progressive = frame[4] != 0;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < nc; ++c) {
    hmax = sampling[2 * c] > hmax ? sampling[2 * c] : hmax;
    vmax = sampling[2 * c + 1] > vmax ? sampling[2 * c + 1] : vmax;
  }
  const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
  std::vector<Component> comps(nc);
  for (int c = 0; c < nc; ++c) {
    Component& p = comps[c];
    p.h = sampling[2 * c];
    p.v = sampling[2 * c + 1];
    p.width = (W * p.h + hmax - 1) / hmax;
    p.height = (H * p.v + vmax - 1) / vmax;
    p.block_cols = (p.width + 7) / 8;
    p.block_rows = (p.height + 7) / 8;
    p.grid_cols = mcux * p.h;
    p.coef.assign(static_cast<size_t>(p.grid_cols) * mcuy * p.v * 64, 0);
    for (int& bits : p.coef_bits) bits = -1;
  }
  std::vector<Huffman> tables(n_tables);
  std::vector<char> built(n_tables, 0);
  auto table = [&](int64_t slot, const Huffman*& t) -> int64_t {  // built at first use, as libjpeg builds them
    if (slot < 0 || slot >= n_tables) return kMissingTable;
    if (!built[slot]) {
      if (!build_huffman(huff + slot * 272, huff + slot * 272 + 16, classes[slot] == 0, tables[slot])) return kBadTable;
      built[slot] = 1;
    }
    t = &tables[slot];
    return t->present ? kOk : kMissingTable;
  };

  for (int64_t i = 0; i < n_scans; ++i) {
    const int64_t* rec = scans + i * kScanFields;
    const int restart = static_cast<int>(rec[3]), ns = static_cast<int>(rec[4]);
    const int ss = static_cast<int>(rec[5]), se = static_cast<int>(rec[6]);
    const int ah = static_cast<int>(rec[7]), al = static_cast<int>(rec[8]);
    const int64_t truncated = rec[2] ? kTruncated : kScanEndsEarly;
    Kind kind = kSequential;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      bad |= (ah != 0 && al != ah - 1) || al > 13;
      if (bad) return kBadProgression | (i << 8);
      kind = ss == 0 ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
    }
    const Huffman* dc[4] = {};
    const Huffman* ac[4] = {};
    Component* unit[4];
    for (int j = 0; j < ns; ++j) {
      const int64_t* c = rec + 9 + 3 * j;
      unit[j] = &comps[c[0]];
      if (progressive)
        for (int k = ss; k <= se; ++k) unit[j]->coef_bits[k] = al;
      if (kind == kSequential || kind == kDcFirst) {
        const int64_t err = table(c[1], dc[j]);
        if (err) return err | (i << 8);
      }
      if (kind == kSequential || kind == kAcFirst || kind == kAcRefine) {
        const int64_t err = table(c[2], ac[j]);
        if (err) return err | (i << 8);
      }
    }
    // an interleaved scan runs over the frame's MCUs; a one-component scan
    // over that component's own blocks, an MCU each
    const int cols = ns == 1 ? unit[0]->block_cols : mcux;
    const int64_t n_mcu = static_cast<int64_t>(cols) * (ns == 1 ? unit[0]->block_rows : mcuy);
    Bits bits{data + rec[0], data + rec[0] + rec[1]};
    int32_t pred[4] = {};
    uint32_t eobrun = 0;
    for (int64_t m = 0; m < n_mcu; ++m) {
      if (restart && m && m % restart == 0) {
        if (!bits.restart(static_cast<int>((m / restart - 1) % 8)))
          return (bits.real < 0 ? truncated : kBadRestart) | (i << 8);
        for (int32_t& p : pred) p = 0;
        eobrun = 0;
      }
      const int64_t my = m / cols, mx = m % cols;
      for (int j = 0; j < ns; ++j) {
        Component& p = *unit[j];
        const int h = ns == 1 ? 1 : p.h, v = ns == 1 ? 1 : p.v;
        for (int dy = 0; dy < v; ++dy) {
          for (int dx = 0; dx < h; ++dx) {
            int16_t* blk = p.coef.data() + ((my * v + dy) * p.grid_cols + mx * h + dx) * 64;
            int64_t err = kOk;
            switch (kind) {
              case kSequential: err = decode_block(bits, *dc[j], *ac[j], pred[j], blk); break;
              case kDcFirst: err = decode_dc_first(bits, *dc[j], al, pred[j], blk); break;
              case kDcRefine: decode_dc_refine(bits, al, blk); break;
              case kAcFirst: err = decode_ac_first(bits, *ac[j], ss, se, al, eobrun, blk); break;
              case kAcRefine: err = decode_ac_refine(bits, *ac[j], ss, se, al, eobrun, blk); break;
            }
            if (err == kOk && bits.real < 0) err = truncated;
            if (err == kTruncated) err = truncated;
            if (err) return err | (i << 8);
          }
        }
      }
    }
  }
  const bool smooth = progressive && needs_smoothing(comps, quant);

  // the output pass: each component's own blocks (block-smoothed where
  // libjpeg smooths them) dequantised and transformed
  std::vector<uint8_t> planes[4];
  Samples samples[4];
  int16_t ws[64];
  for (int c = 0; c < nc; ++c) {
    const Component& p = comps[c];
    const int64_t stride = static_cast<int64_t>(p.block_cols) * 8;
    planes[c].resize(stride * p.block_rows * 8);
    for (int by = 0; by < p.block_rows; ++by) {
      for (int bx = 0; bx < p.block_cols; ++bx) {
        const int16_t* blk = p.coef.data() + (static_cast<int64_t>(by) * p.grid_cols + bx) * 64;
        if (smooth) {
          smooth_block(p, quant + 64 * c, mcuy, by, bx, ws);
          blk = ws;
        }
        idct_islow(blk, quant + 64 * c, planes[c].data() + by * 8 * stride + bx * 8, stride);
      }
    }
    samples[c] = {planes[c].data(), stride, p.width, p.height, hmax / p.h, vmax / p.v};
  }
  finish(W, H, nc, colour, samples, out);
  return kOk;
}
