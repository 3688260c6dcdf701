// Native PNG scanline un-filtering for the port's PNG reader.
//
// octa_tpu_torch/io/images.py::read_png_scanlines parses a PNG's chunks and
// inflates its IDAT stream with Python's zlib. What is left is undoing the
// five scanline filters, a loop along each line (a byte needs the decoded
// byte bpp to its left) that numpy can only take one anti-diagonal at a
// time. This file does it in one pass. It needs nothing beyond the C++
// standard library, so it builds wherever g++ runs, libpng's headers or
// not. octa_tpu_torch/native/__init__.py builds it with g++ at first use and
// binds it with ctypes; the loader falls back to the numpy un-filter where
// it does not build.
//
// API (C ABI):
//   png_unfilter(rows, h, stride, bpp, out) -> 0 ok / -1 unknown filter type
//     rows: h scanlines of 1 + stride bytes, each led by its filter type
//           (0 none, 1 sub, 2 up, 3 average, 4 paeth)
//     bpp:  bytes a pixel (samples a pixel times bytes a sample)
//     out:  h * stride bytes, the decoded scanlines

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" int png_unfilter(const uint8_t* rows, int64_t h, int64_t stride,
                            int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = rows + y * (stride + 1) + 1;
    const int kind = in[-1];
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y ? cur - stride : nullptr;  // the row above, or 0s
    switch (kind) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          cur[x] = uint8_t(in[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          cur[x] = uint8_t(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          cur[x] = uint8_t(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          cur[x] = uint8_t(in[x] + paeth(a, b, c));
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}
