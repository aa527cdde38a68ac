// The PNG row filters' undo (PNG spec section 9) for unmicst_tpu_torch/
// io/png.py: None, Sub, Up, Average and Paeth.  Average and Paeth need each
// byte's left neighbour once it is itself undone, a loop that runs at
// about 1 MB/s in Python.  png.py's _unfilter_py is the same algorithm:
// the two give the same bytes and refuse the same filter types.
//
// Build: with tiffcodec.cpp and jpegdec.cpp into one library by
//        unmicst_tpu_torch/io/_native.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>

// src: h rows of one filter-type byte and `stride` filtered bytes; dst: h
// rows of `stride` bytes.  Returns 0, or 1 + the first row whose filter
// type is not 0-4.
extern "C" long long unmicst_png_unfilter(const uint8_t* src, long long h,
                                          long long stride, long long bpp,
                                          uint8_t* dst) {
  for (long long y = 0; y < h; ++y) {
    const uint8_t* line = src + y * (stride + 1);
    const int kind = line[0];
    ++line;
    uint8_t* cur = dst + y * stride;
    const uint8_t* up = y ? cur - stride : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (long long i = 0; i < stride; ++i)
          cur[i] = line[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (long long i = 0; i < stride; ++i)
          cur[i] = line[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          cur[i] = line[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = line[i] + pred;
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
