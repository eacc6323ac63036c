// The lossless WebP (VP8L) decode that cv2.imread runs through libwebp, from
// the bitstream to ARGB pixels, computed as libwebp's vp8l_dec.c,
// huffman_utils.c and lossless.c compute it:
//   the header (signature 0x2f, 14-bit width and height, an alpha hint, a
//   version that must be 0);
//   the transforms, each at most once, undone in reverse order: predictor (14
//   modes a tile, 14 and 15 read as mode 0), cross-colour (sign-extended int8
//   multipliers, products shifted right by 5), subtract-green and colour
//   indexing (a delta-coded palette, pixels bundled 8, 4, 2 or 1 to a byte,
//   an index past the palette giving 0);
//   the colour cache (hash (0x1e35a7bd * argb) >> (32 - bits), every pixel
//   inserted as it is made);
//   the meta prefix codes (an entropy image naming each tile's group of five
//   codes) and the prefix codes, simple (one or two symbols) or read through
//   the 19-symbol code-length code with its repeat codes and max_symbol; a
//   code of one symbol reads no bits, any other must be complete;
//   LZ77 copies (length and distance prefixes with extra bits, the 120-entry
//   distance map of (dx, dy), overlapping copies).
// Reading past the data's end is an error, as in libwebp (which, for a
// bitstream under 8 bytes, lets a read run to 64 bits).
//
// Host code: data/webp.py calls vp8l_decode through ctypes, which releases
// the interpreter lock, so the Loader's threads decode frames in parallel;
// data/vp8l.py is its plain Python twin. ops/cuda_build.py compiles this file
// with the host C++ compiler at first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Error : int64_t {
  kBadCode = -1,    // a bitstream that libwebp refuses
  kTruncated = -2,  // a read past the data's end
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kRootBits = 8;

// (dy << 4) | (8 - dx) of each of the 120 short distance codes, the (dx, dy)
// of the VP8L specification's distance map (libwebp's kCodeToPlane)
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct Bits {  // LSB first, as VP8LBitReader
  const uint8_t* p;
  int64_t n, pos = 0, used = 0, limit;
  uint64_t val = 0;
  int have = 0;
  Bits(const uint8_t* src, int64_t len) : p(src), n(len), limit(len >= 8 ? 8 * len : 64) {}
  uint32_t peek(int k) {
    while (have <= 56) {
      val |= static_cast<uint64_t>(pos < n ? p[pos] : 0) << have;
      ++pos;
      have += 8;
    }
    return static_cast<uint32_t>(val & ((1ull << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    have -= k;
    used += k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool eos() const { return used > limit; }
};

struct Entry {
  uint8_t len;     // bits of the code (from the root or from the subtable)
  uint8_t sub;     // a root entry's subtable bits; 0 for a symbol
  uint16_t value;  // the symbol, or the subtable's offset
};

struct Code {  // one prefix code: a root table of 2^8 entries and its subtables
  std::vector<Entry> table;
  bool single = false;  // one symbol, read with no bits
  int read(Bits& br) const {
    const uint32_t v = br.peek(15);
    const Entry& e = table[v & ((1u << kRootBits) - 1)];
    if (!e.sub) {
      br.skip(e.len);
      return e.value;
    }
    const Entry& f = table[e.value + ((v >> kRootBits) & ((1u << e.sub) - 1))];
    br.skip(kRootBits + f.len);
    return f.value;
  }
};

uint32_t reverse_bits(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
  return r;
}

// The canonical code of the given lengths (VP8LBuildHuffmanTable): false when
// every length is 0, a length passes 15, or the code is neither one symbol nor
// complete.
bool build(const int* lengths, int size, Code& code) {
  int count[16] = {0};
  for (int s = 0; s < size; ++s) {
    if (lengths[s] < 0 || lengths[s] > 15) return false;
    ++count[lengths[s]];
  }
  if (count[0] == size) return false;
  code.table.assign(1 << kRootBits, Entry{0, 0, 0});
  code.single = size - count[0] == 1;
  if (code.single) {  // one symbol: no bits
    for (int s = 0; s < size; ++s)
      if (lengths[s]) for (Entry& e : code.table) e.value = static_cast<uint16_t>(s);
    return true;
  }
  int64_t left = 1;
  for (int len = 1; len <= 15; ++len) {
    left = 2 * left - count[len];
    if (left < 0) return false;
  }
  if (left != 0) return false;
  uint32_t next[16] = {0};  // the first canonical code of each length
  for (int len = 2; len <= 15; ++len) next[len] = (next[len - 1] + count[len - 1]) << 1;
  // the subtables' sizes: the longest code under each root entry
  std::vector<uint32_t> rev(size);
  std::vector<int> sub_bits(1 << kRootBits, 0);
  for (int s = 0; s < size; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    rev[s] = reverse_bits(next[len]++, len);
    if (len > kRootBits) {
      int& b = sub_bits[rev[s] & ((1u << kRootBits) - 1)];
      if (len - kRootBits > b) b = len - kRootBits;
    }
  }
  for (int r = 0; r < (1 << kRootBits); ++r) {
    if (!sub_bits[r]) continue;
    code.table[r] = Entry{0, static_cast<uint8_t>(sub_bits[r]), static_cast<uint16_t>(code.table.size())};
    code.table.resize(code.table.size() + (size_t{1} << sub_bits[r]), Entry{0, 0, 0});
  }
  for (int s = 0; s < size; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    if (len <= kRootBits) {
      for (uint32_t k = rev[s]; k < (1u << kRootBits); k += 1u << len)
        code.table[k] = Entry{static_cast<uint8_t>(len), 0, static_cast<uint16_t>(s)};
    } else {
      const Entry& root = code.table[rev[s] & ((1u << kRootBits) - 1)];
      const int sl = len - kRootBits;
      for (uint32_t k = rev[s] >> kRootBits; k < (1u << root.sub); k += 1u << sl)
        code.table[root.value + k] = Entry{static_cast<uint8_t>(sl), 0, static_cast<uint16_t>(s)};
    }
  }
  return true;
}

struct Group {
  Code codes[5];  // green + length + cache, red, blue, alpha, distance
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

inline int div_round_up(int v, int bits) { return (v + (1 << bits) - 1) >> bits; }

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

inline uint32_t clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint32_t>(v); }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {  // top: the pixel above
  const uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {  // Select(T, L, TL)
      int d = 0;
      for (int sh = 0; sh < 32; sh += 8)
        d += sub3((T >> sh) & 0xff, (L >> sh) & 0xff, (TL >> sh) & 0xff);
      return d <= 0 ? T : L;
    }
    case 12: {
      uint32_t out = 0;
      for (int sh = 0; sh < 32; sh += 8)
        out |= clip255(static_cast<int>((L >> sh) & 0xff) + static_cast<int>((T >> sh) & 0xff) -
                       static_cast<int>((TL >> sh) & 0xff)) << sh;
      return out;
    }
    case 13: {
      const uint32_t ave = average2(L, T);
      uint32_t out = 0;
      for (int sh = 0; sh < 32; sh += 8) {
        const int a = (ave >> sh) & 0xff, b = (TL >> sh) & 0xff;
        out |= clip255(a + (a - b) / 2) << sh;
      }
      return out;
    }
    default: return 0xff000000u;  // 0, 14, 15
  }
}

inline int8_t as_int8(uint32_t v) { return static_cast<int8_t>(v & 0xff); }

inline int delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

void inverse(const Transform& t, std::vector<uint32_t>& px, std::vector<uint32_t>& out) {
  const int w = t.xsize, h = t.ysize;
  switch (t.type) {
    case 0: {  // predictor, in place
      const int tiles = div_round_up(w, t.bits);
      uint32_t* p = px.data();
      p[0] = add_pixels(p[0], 0xff000000u);
      for (int x = 1; x < w; ++x) p[x] = add_pixels(p[x], p[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = p + static_cast<int64_t>(y) * w;
        const uint32_t* modes = t.data.data() + static_cast<int64_t>(y >> t.bits) * tiles;
        row[0] = add_pixels(row[0], row[-w]);
        for (int x = 1; x < w; ++x)
          row[x] = add_pixels(row[x], predict((modes[x >> t.bits] >> 8) & 0xf, row[x - 1], row + x - w));
      }
      return;
    }
    case 1: {  // cross-colour, in place
      const int tiles = div_round_up(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px.data() + static_cast<int64_t>(y) * w;
        const uint32_t* m = t.data.data() + static_cast<int64_t>(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t code = m[x >> t.bits], argb = row[x];
          const int8_t g2r = as_int8(code), g2b = as_int8(code >> 8), r2b = as_int8(code >> 16);
          const int8_t green = as_int8(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + delta(g2r, green)) & 0xff;
          blue = (blue + delta(g2b, green) + delta(r2b, as_int8(red))) & 0xff;
          row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
      }
      return;
    }
    case 2:  // subtract-green, in place
      for (uint32_t& v : px) {
        const uint32_t g = (v >> 8) & 0xff;
        v = (v & 0xff00ff00u) | ((((v >> 16) + g) & 0xff) << 16) | (((v & 0xff) + g) & 0xff);
      }
      return;
    default: {  // colour indexing: px holds (xsize >> bits rounded up) x h packed pixels
      const int packed_w = div_round_up(w, t.bits), per_byte = 1 << t.bits, bpp = 8 >> t.bits;
      out.assign(static_cast<size_t>(w) * h, 0);
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px.data() + static_cast<int64_t>(y) * packed_w;
        uint32_t* dst = out.data() + static_cast<int64_t>(y) * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & (per_byte - 1)) == 0) packed = (src[x >> t.bits] >> 8) & 0xff;
          dst[x] = t.data[packed & ((1u << bpp) - 1)];
          packed >>= bpp;
        }
      }
      px.swap(out);
    }
  }
}

struct Decoder {
  Bits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  // A lossless ALPH chunk's stream: libwebp decodes one whose only transform
  // is colour indexing, without a colour cache, whose red, blue and alpha
  // codes are one symbol each, through its 8-bit path, where the main
  // image's last symbol may read past the data's end.
  bool alpha = false;
  explicit Decoder(const uint8_t* src, int64_t n, bool alpha_stream) : br(src, n), alpha(alpha_stream) {}

  int64_t read_code(int alphabet, Code& code) {
    std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
    if (br.read(1)) {  // simple: one or two symbols
      const int two = br.read(1);
      const int s0 = br.read(br.read(1) ? 8 : 1);
      lengths[s0] = 1;
      if (two) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num = br.read(4) + 4;
      for (int i = 0; i < num; ++i) cl_lengths[kCodeLengthOrder[i]] = br.read(3);
      Code cl;
      if (!build(cl_lengths, 19, cl)) return kBadCode;
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet) return kBadCode;
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          const int slot = len - 16;
          const int repeat = br.read(slot == 0 ? 2 : slot == 1 ? 3 : 7) + (slot == 2 ? 11 : 3);
          if (symbol + repeat > alphabet) return kBadCode;
          for (int k = 0; k < repeat; ++k) lengths[symbol++] = slot == 0 ? prev : 0;
        }
        if (br.eos()) return kTruncated;
      }
    }
    if (br.eos()) return kTruncated;
    return build(lengths.data(), alphabet, code) ? 0 : kBadCode;
  }

  // One entropy-coded image of xsize x ysize (the main image when level0),
  // into out; the main image's transforms are kept for undoing.
  int64_t image(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    if (level0) {
      while (br.read(1)) {
        const int type = br.read(2);
        if (seen & (1u << type)) return kBadCode;
        seen |= 1u << type;
        Transform t{type, 0, xsize, ysize, {}};
        if (type == 0 || type == 1) {
          t.bits = 2 + br.read(3);
          const int64_t r = image(div_round_up(xsize, t.bits), div_round_up(ysize, t.bits), false, t.data);
          if (r) return r;
        } else if (type == 3) {
          const int colors = br.read(8) + 1;
          t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal;
          const int64_t r = image(colors, 1, false, pal);
          if (r) return r;
          t.data.assign(size_t{1} << (8 >> t.bits), 0);  // past the palette: 0
          uint8_t* d = reinterpret_cast<uint8_t*>(t.data.data());
          std::memcpy(d, pal.data(), 4);
          const uint8_t* s = reinterpret_cast<const uint8_t*>(pal.data());
          for (int i = 4; i < 4 * colors; ++i) d[i] = static_cast<uint8_t>(s[i] + d[i - 4]);
          xsize = div_round_up(xsize, t.bits);
        }
        if (br.eos()) return kTruncated;
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) return kBadCode;
    }
    int meta_bits = 0, meta_w = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && br.read(1)) {
      meta_bits = 2 + br.read(3);
      meta_w = div_round_up(xsize, meta_bits);
      const int64_t r = image(meta_w, div_round_up(ysize, meta_bits), false, meta);
      if (r) return r;
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if (static_cast<int>(m) + 1 > groups) groups = static_cast<int>(m) + 1;
      }
    }
    if (br.eos()) return kTruncated;
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    std::vector<Group> tree(groups);
    for (Group& g : tree)
      for (int j = 0; j < 5; ++j) {
        const int64_t r = read_code(alphabets[j], g.codes[j]);
        if (r) return r;
      }
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int64_t total = static_cast<int64_t>(xsize) * ysize;
    bool overrun = level0 && alpha && transforms.size() == 1 && transforms[0].type == 3 && !cache_size;
    for (const Group& g : tree) overrun = overrun && g.codes[1].single && g.codes[2].single && g.codes[3].single;
    out.assign(total, 0);
    uint32_t* px = out.data();
    int64_t i = 0, cached = 0;
    auto insert_cached = [&]() {
      if (cache_size)
        for (; cached < i; ++cached) cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (i < total) {
      const int x = static_cast<int>(i % xsize), y = static_cast<int>(i / xsize);
      const Group& g = tree[meta_bits ? meta[static_cast<int64_t>(y >> meta_bits) * meta_w + (x >> meta_bits)] : 0];
      const int code = g.codes[0].read(br);
      if (code < 256) {
        const uint32_t red = g.codes[1].read(br), blue = g.codes[2].read(br), a = g.codes[3].read(br);
        if (br.eos() && !(overrun && i + 1 == total)) return kTruncated;
        px[i++] = (a << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      } else if (code < 256 + 24) {
        auto prefix_value = [&](int sym) -> int64_t {
          if (sym < 4) return sym + 1;
          const int extra = (sym - 2) >> 1;
          return (static_cast<int64_t>(2 + (sym & 1)) << extra) + br.read(extra) + 1;
        };
        const int64_t length = prefix_value(code - 256);
        const int64_t dist_code = prefix_value(g.codes[4].read(br));
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int plane = kCodeToPlane[dist_code - 1];
          dist = static_cast<int64_t>(plane >> 4) * xsize + (8 - (plane & 0xf));
          if (dist < 1) dist = 1;
        }
        if (br.eos() && !(overrun && i + length >= total)) return kTruncated;
        if (i < dist || total - i < length) return kBadCode;
        for (int64_t k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
      } else if (code < 256 + 24 + cache_size) {
        insert_cached();
        px[i++] = cache[code - 256 - 24];
      } else {
        return kBadCode;
      }
      insert_cached();
    }
    if (br.eos() && !overrun) return kTruncated;
    return 0;
  }
};

}  // namespace

// src: the n bytes of a VP8L bitstream (from its signature byte); argb: width
// x height pixels, 0xAARRGGBB, top row first. Returns 0, kBadCode (a header
// whose signature, size or version bits libwebp refuses, or a bad stream) or
// kTruncated.
namespace {

int64_t decode_vp8l(const uint8_t* src, int64_t n, int64_t width, int64_t height, uint32_t* argb, bool alpha) {
  if (n < 5) return kBadCode;
  Decoder dec(src, n, alpha);
  if (dec.br.read(8) != 0x2f) return kBadCode;
  const int w = dec.br.read(14) + 1, h = dec.br.read(14) + 1;
  dec.br.read(1);  // alpha is used: a hint
  if (dec.br.read(3) != 0 || w != width || h != height) return kBadCode;
  std::vector<uint32_t> px, scratch;
  const int64_t r = dec.image(w, h, true, px);
  if (r) return r;
  for (auto t = dec.transforms.rbegin(); t != dec.transforms.rend(); ++t) inverse(*t, px, scratch);
  std::memcpy(argb, px.data(), sizeof(uint32_t) * static_cast<size_t>(width) * height);
  return 0;
}

}  // namespace

extern "C" int64_t vp8l_decode(const uint8_t* src, int64_t n, int64_t width, int64_t height, uint32_t* argb) {
  return decode_vp8l(src, n, width, height, argb, false);
}

// The same, for a lossless ALPH chunk's stream behind a VP8L header made for
// it (the Decoder's ``alpha``).
extern "C" int64_t vp8l_decode_alpha(const uint8_t* src, int64_t n, int64_t width, int64_t height, uint32_t* argb) {
  return decode_vp8l(src, n, width, height, argb, true);
}
