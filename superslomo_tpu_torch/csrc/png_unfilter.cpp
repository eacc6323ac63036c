// The five PNG row filters (None, Sub, Up, Average, Paeth; PNG specification,
// section 9), undone in place over one inflated image.
//
// Host code: the frame decoder (data/png.py) calls it through ctypes, which
// releases the interpreter lock, so the Loader's threads decode frames in
// parallel. Sub, Average and Paeth depend on the byte bpp to the left, which
// numpy cannot vectorise: in Python a Paeth-coded 720p frame takes seconds.
// ops/cuda_build.py compiles this file with the host C++ compiler at first use.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// data: h rows of (1 filter byte + stride bytes), as inflated from the IDATs.
// Each row's bytes are replaced by the unfiltered ones; the filter bytes stay.
// bpp: bytes of one whole pixel. Returns 0, or 1 + the index of the first row
// whose filter byte is not 0-4.
extern "C" int64_t png_unfilter(uint8_t* data, int64_t h, int64_t stride, int64_t bpp) {
  const int64_t pitch = stride + 1;
  for (int64_t r = 0; r < h; ++r) {
    uint8_t* x = data + r * pitch + 1;
    const uint8_t* up = r > 0 ? x - pitch : nullptr;  // the row above, unfiltered; none above row 0
    switch (data[r * pitch]) {
      case 0:
        break;
      case 1:
        for (int64_t i = bpp; i < stride; ++i) x[i] = static_cast<uint8_t>(x[i] + x[i - bpp]);
        break;
      case 2:
        if (up)
          for (int64_t i = 0; i < stride; ++i) x[i] = static_cast<uint8_t>(x[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          x[i] = static_cast<uint8_t>(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? x[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          x[i] = static_cast<uint8_t>(x[i] + paeth(a, b, c));
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}
