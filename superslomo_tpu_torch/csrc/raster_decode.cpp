// The byte-stream codecs of the uncompressed and lossless raster formats that
// cv2.imread reads, each as the library inside cv2 decodes it:
//   lzw_decode       TIFF's LZW (MSB-first codes of 9-12 bits, the code width
//                    growing one code early, as libtiff's LZWDecode reads it);
//   gif_lzw_decode   GIF's LZW (LSB-first codes of the minimum code size + 1
//                    to 12 bits, no early change, a table that freezes at 4096
//                    entries until the next clear), as OpenCV's grfmt_gif.cpp
//                    reads it;
//   packbits_decode  TIFF's PackBits (libtiff's PackBitsDecode);
//   bmp_rle_decode   BMP's RLE8 and RLE4 to palette indices, with OpenCV's
//                    grfmt_bmp.cpp rules for the end-of-line, end-of-bitmap
//                    and delta codes (the pixels they skip take index 0);
//   hdr_decode       Radiance HDR scanlines: flat RGBE pixels or new-style
//                    run-length scanlines, as OpenCV's rgbe.cpp reads them.
//
// (cv2 5.0 reads no byte-encoded Sun raster: its header check compares the
// image type, not the encoding, with it; so there is no Sun routine here.)
//
// Host code: the frame readers (data/tiff.py, data/gif.py, data/bmp.py, data/hdr.py) call
// these routines through ctypes, which releases the
// interpreter lock, so the Loader's threads decode frames in parallel. Each
// has a plain Python twin beside its caller. ops/cuda_build.py compiles this
// file with the host C++ compiler at first use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error : int64_t {
  kBadCode = -1,    // an LZW code past the table, or a bad escape
  kTruncated = -2,  // the data ends before the image does
  kOverrun = -3,    // a run past the end of its row (GIF: a string, or data,
                    // past the image's end)
};

}  // namespace

// src: n bytes of one LZW strip or tile; dst: cap bytes. Decodes until dst is
// full, an end-of-information code, or the data's end. Returns the bytes
// written, or kBadCode.
extern "C" int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int c = 0; c < 256; ++c) {
    prefix[c] = -1;
    length[c] = 1;
    suffix[c] = first[c] = static_cast<uint8_t>(c);
  }
  int nbits = 9, free_code = 258, prev = -1;
  uint64_t buf = 0;
  int have = 0;
  int64_t pos = 0, out = 0;
  while (out < cap) {
    while (have < nbits && pos < n) {
      buf = (buf << 8) | src[pos++];
      have += 8;
    }
    if (have < nbits) break;  // the data's end
    const int code = static_cast<int>((buf >> (have - nbits)) & ((1u << nbits) - 1));
    have -= nbits;
    if (code == 257) break;  // end of information
    if (code == 256) {       // clear
      nbits = 9;
      free_code = 258;
      prev = -1;
      continue;
    }
    if (prev < 0) {  // the first code after a clear: a single byte
      if (code > 255) return kBadCode;
      dst[out++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > free_code) return kBadCode;
    if (free_code < 4096) {  // the new entry: prev's string and the first byte of code's (prev's, if code is it)
      prefix[free_code] = prev;
      suffix[free_code] = code < free_code ? first[code] : first[prev];
      first[free_code] = first[prev];
      length[free_code] = length[prev] + 1;
    }
    const int len = length[code];
    int64_t end = out + len;
    int c = code;
    for (int64_t i = end - 1; i >= out; --i) {  // written from its end, clipped to dst
      if (i < cap) dst[i] = suffix[c];
      c = prefix[c];
    }
    out = end < cap ? end : cap;
    if (free_code < 4096 && ++free_code >= (1 << nbits) - 1 && nbits < 12) ++nbits;
    prev = code;
  }
  return out;
}

// src: the n bytes of a GIF image's LZW data (its sub-blocks joined); dst: the
// image's cap palette indices, in the file's row order. min_size: the LZW
// minimum code size, 2-11. As OpenCV's decoder: an end code resets the table as
// a clear code does, and decoding goes on; a string past the image's end is
// kOverrun; once the image is full, the first code that is neither a clear nor
// an end code ends the decode, and must end in the data's last byte (kOverrun
// otherwise). Returns cap, kBadCode (a code past the table, or a first code
// after a clear that is not a literal) or kTruncated (fewer indices than cap).
extern "C" int64_t gif_lzw_decode(const uint8_t* src, int64_t n, int64_t min_size, uint8_t* dst, int64_t cap) {
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  const int clear = 1 << min_size, end = clear + 1;
  for (int c = 0; c < clear; ++c) {
    prefix[c] = -1;
    length[c] = 1;
    suffix[c] = first[c] = static_cast<uint8_t>(c);
  }
  int nbits = static_cast<int>(min_size) + 1, free_code = end + 1, prev = -1;
  uint64_t buf = 0;
  int have = 0;
  int64_t pos = 0, out = 0;
  while (true) {
    while (have < nbits && pos < n) {
      buf |= static_cast<uint64_t>(src[pos++]) << have;
      have += 8;
    }
    if (have < nbits) break;  // the data's end
    const int code = static_cast<int>(buf & ((1u << nbits) - 1));
    buf >>= nbits;
    have -= nbits;
    if (code == clear || code == end) {
      nbits = static_cast<int>(min_size) + 1;
      free_code = end + 1;
      prev = -1;
      continue;
    }
    if (out == cap) return pos == n ? cap : kOverrun;  // the image is full
    if (prev < 0) {  // the first code after a clear: a literal
      if (code > clear) return kBadCode;
      dst[out++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > free_code || (code == free_code && free_code == 4096)) return kBadCode;
    const int c0 = code < free_code ? code : prev;  // the string whose first byte the new entry ends with
    const int len = code < free_code ? length[code] : length[prev] + 1;
    if (out + len > cap) return kOverrun;
    if (free_code < 4096) {
      prefix[free_code] = prev;
      suffix[free_code] = first[c0];
      first[free_code] = first[prev];
      length[free_code] = length[prev] + 1;
    }
    int c = code;
    for (int64_t i = out + len - 1; i >= out; --i) {
      dst[i] = suffix[c];
      c = prefix[c];
    }
    out += len;
    if (free_code < 4096 && ++free_code == (1 << nbits) && nbits < 12) ++nbits;
    prev = code;
  }
  return out == cap ? cap : kTruncated;
}

// src: n bytes of PackBits; dst: cap bytes. Returns the bytes written (a run
// that would pass cap is cut, as libtiff cuts it).
extern "C" int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < cap) {
    const int b = static_cast<int8_t>(src[pos++]);
    if (b >= 0) {  // b + 1 literal bytes
      int64_t k = b + 1;
      if (k > n - pos) k = n - pos;
      if (k > cap - out) k = cap - out;
      std::memcpy(dst + out, src + pos, k);
      pos += b + 1;
      out += k;
    } else if (b != -128) {  // 1 - b copies of the next byte
      if (pos >= n) break;
      int64_t k = 1 - b;
      if (k > cap - out) k = cap - out;
      std::memset(dst + out, src[pos++], k);
      out += k;
    }
  }
  return out;
}

// src: the n bytes from the BMP's pixel offset to its end; idx: width x height
// palette indices in file row order (the caller flips a bottom-up file).
// bits: 8 (RLE8) or 4 (RLE4). Returns 0, kTruncated or kOverrun.
extern "C" int64_t bmp_rle_decode(const uint8_t* src, int64_t n, int64_t width, int64_t height, int64_t bits,
                                  uint8_t* idx) {
  int64_t pos = 0, x = 0, y = 0;
  // k pixels of index 0 from (x, y) on, row after row, as OpenCV's FillUniColor
  // writes them: reaching a row's end moves to the next row's start
  auto skip = [&](int64_t k) {
    do {
      int64_t m = width - x < k ? width - x : k;
      std::memset(idx + y * width + x, 0, m);
      x += m;
      k -= m;
      if (x >= width) {
        x = 0;
        if (++y >= height) break;
      }
    } while (k > 0);
  };
  bool row_ended = false;  // RLE8: the last run reached its row's end
  while (true) {
    if (pos + 2 > n) return kTruncated;
    const int len = src[pos], code = src[pos + 1];
    pos += 2;
    if (len != 0) {  // a run of len pixels
      if (x + len > width) return kOverrun;
      if (bits == 8) {
        const int64_t y0 = y;
        std::memset(idx + y * width + x, code, len);
        x += len;
        if (x >= width) {
          x = 0;
          ++y;
        }
        row_ended = y != y0;
        if (y >= height) break;
      } else {
        for (int i = 0; i < len; ++i) idx[y * width + x + i] = (i & 1) ? (code & 15) : (code >> 4);
        x += len;
      }
    } else if (code > 2) {  // code literal indices, padded to a 16-bit boundary
      if (x + code > width) return kOverrun;
      const int64_t bytes = bits == 8 ? ((code + 1) & ~1) : ((((code + 1) >> 1) + 1) & ~1);
      if (pos + bytes > n) return kTruncated;
      for (int i = 0; i < code; ++i)
        idx[y * width + x + i] = bits == 8 ? src[pos + i] : ((i & 1) ? (src[pos + i / 2] & 15) : (src[pos + i / 2] >> 4));
      pos += bytes;
      x += code;
      row_ended = false;
    } else if (bits == 8) {  // 0: end of row, 1: end of bitmap, 2: delta
      int64_t k = width - x, dy = height - y;
      if (code || !row_ended || k < width) {
        if (code == 2) {
          if (pos + 2 > n) return kTruncated;
          k = src[pos];
          dy = src[pos + 1];
          pos += 2;
        }
        if (code) k += dy * width;
        if (y >= height) break;
        skip(k);
        if (y >= height) break;
      }
      row_ended = false;
      if (y >= height) break;
    } else {  // RLE4: the end of bitmap ends the row only; a delta's dy is read and dropped
      int64_t k = width - x;
      if (code == 2) {
        if (pos + 2 > n) return kTruncated;
        k = src[pos];
        pos += 2;
      }
      skip(k);
      if (y >= height) break;
    }
  }
  return 0;
}

// src: the n bytes after an HDR header; rgbe: width x height RGBE pixels, top
// row first. Widths of 8 to 32767 may be run-length scanlines (2, 2, width;
// then each channel's runs); a scanline that does not start so, and every
// one after it, is read flat, as are the scanlines of other widths. Returns
// the bytes read, kTruncated or kBadCode.
extern "C" int64_t hdr_decode(const uint8_t* src, int64_t n, int64_t width, int64_t height, uint8_t* rgbe) {
  int64_t pos = 0;
  const int64_t total = width * height;
  auto flat = [&](int64_t from) -> int64_t {
    const int64_t bytes = (total - from) * 4;
    if (pos + bytes > n) return kTruncated;
    std::memcpy(rgbe + from * 4, src + pos, bytes);
    return pos + bytes;
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  std::vector<uint8_t> line(4 * width);
  for (int64_t y = 0; y < height; ++y) {
    if (pos + 4 > n) return kTruncated;
    const uint8_t* h = src + pos;
    if (h[0] != 2 || h[1] != 2 || (h[2] & 0x80)) return flat(y * width);
    if (((h[2] << 8) | h[3]) != width) return kBadCode;
    pos += 4;
    for (int c = 0; c < 4; ++c) {
      uint8_t* p = line.data() + c * width;
      uint8_t* end = p + width;
      while (p < end) {
        if (pos + 2 > n) return kTruncated;
        int count = src[pos];
        if (count > 128) {  // a run
          count -= 128;
          if (count > end - p) return kBadCode;
          std::memset(p, src[pos + 1], count);
          pos += 2;
        } else {  // count literal bytes
          if (count == 0 || count > end - p) return kBadCode;
          if (pos + 1 + count > n) return kTruncated;
          std::memcpy(p, src + pos + 1, count);
          pos += 1 + count;
        }
        p += count;
      }
    }
    uint8_t* row = rgbe + y * width * 4;
    for (int64_t x = 0; x < width; ++x)
      for (int c = 0; c < 4; ++c) row[x * 4 + c] = line[c * width + x];
  }
  return pos;
}
