// The two passes of Pillow 12's Resample.c, for unmicst_tpu_torch/io/
// resample.py: one pass along one axis of a [rows, cols, channels] image
// with the coefficients the module computes (int32 22-bit fixed point for
// 8-bit channels, doubles otherwise); and Convert.c's premultiply and its
// inverse around them for LA and RGBA.  The module's pass_py,
// premultiply_py and unpremultiply_py are the same arithmetic in numpy:
// the two give the same values.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC -ffp-contract=off: the double
//        sums must keep Pillow's order and rounding).

#include <cstdint>
#include <vector>

namespace {

const int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(long long v) {
  return v <= 0 ? 0 : (v >= 255 ? 255 : (uint8_t)v);
}

// ROUND_UP's (int) cast as x86-64 does it: out of range (or NaN) is
// INT32_MIN
inline int32_t round_up(double ss) {
  double r = ss >= 0.0 ? ss + 0.5 : ss - 0.5;
  if (!(r > -2147483649.0 && r < 2147483648.0)) return INT32_MIN;
  return (int32_t)r;
}

// The pass kinds: how a sample loads, what sums it, how the sum stores.
struct U8 {  // 8 bits a channel: int32 sums of 22-bit fixed point taps
  typedef uint8_t T;
  typedef int32_t K;
  typedef int32_t Acc;
  static Acc start() { return 1 << (PRECISION_BITS - 1); }
  static int load(const T* p) { return *p; }
  static void store(T* q, Acc ss) { *q = clip8(ss >> PRECISION_BITS); }
};

struct U16 {  // two bytes a sample, read little-endian, summed in double
  typedef uint16_t T;
  typedef double K;
  typedef double Acc;
  static Acc start() { return 0.0; }
  static int load(const T* p) {
    const uint8_t* b = (const uint8_t*)p;
    return b[0] + (b[1] << 8);
  }
  static void store(T* q, Acc ss) {
    int32_t v = round_up(ss);
    uint8_t* b = (uint8_t*)q;
    b[0] = clip8(v % 256);
    b[1] = clip8(v >> 8);
  }
};

struct I32 {
  typedef int32_t T;
  typedef double K;
  typedef double Acc;
  static Acc start() { return 0.0; }
  static int32_t load(const T* p) { return *p; }
  static void store(T* q, Acc ss) { *q = round_up(ss); }
};

struct F32 {
  typedef float T;
  typedef double K;
  typedef double Acc;
  static Acc start() { return 0.0; }
  static float load(const T* p) { return *p; }
  static void store(T* q, Acc ss) { *q = (float)ss; }
};

// ImagingResampleHorizontal_*: dst [rows, out, c] from src rows
// offset .. offset + rows of [h, w, c]
template <typename P>
void horizontal(const typename P::T* src, long long w, long long c,
                const long long* xmin, const long long* xmax,
                const typename P::K* kk, long long ksize, long long out,
                long long offset, long long rows, typename P::T* dst) {
  for (long long y = 0; y < rows; y++) {
    const typename P::T* line = src + (y + offset) * w * c;
    for (long long o = 0; o < out; o++) {
      const typename P::K* k = kk + o * ksize;
      for (long long ch = 0; ch < c; ch++) {
        const typename P::T* p = line + xmin[o] * c + ch;
        typename P::Acc ss = P::start();
        for (long long x = 0; x < xmax[o]; x++) ss += P::load(p + x * c) * k[x];
        P::store(dst + (y * out + o) * c + ch, ss);
      }
    }
  }
}

// ImagingResampleVertical_*: dst [out, w, c] from src [h, w, c], each
// output row's sums taken tap by tap over the whole row (each sample's
// sum keeps the taps' order)
template <typename P>
void vertical(const typename P::T* src, long long w, long long c,
              const long long* ymin, const long long* ymax,
              const typename P::K* kk, long long ksize, long long out,
              typename P::T* dst) {
  long long n = w * c;
  std::vector<typename P::Acc> acc(n);
  for (long long o = 0; o < out; o++) {
    const typename P::K* k = kk + o * ksize;
    for (long long j = 0; j < n; j++) acc[j] = P::start();
    for (long long y = 0; y < ymax[o]; y++) {
      const typename P::T* row = src + (ymin[o] + y) * n;
      typename P::K ky = k[y];
      for (long long j = 0; j < n; j++) acc[j] += P::load(row + j) * ky;
    }
    for (long long j = 0; j < n; j++) P::store(dst + o * n + j, acc[j]);
  }
}

template <typename P>
void run(const void* src, long long w, long long c, int axis,
         const long long* lo, const long long* len, const void* kk,
         long long ksize, long long out, long long offset, long long rows,
         void* dst) {
  typedef typename P::T T;
  typedef typename P::K K;
  if (axis == 1)
    horizontal<P>((const T*)src, w, c, lo, len, (const K*)kk, ksize, out,
                  offset, rows, (T*)dst);
  else
    vertical<P>((const T*)src, w, c, lo, len, (const K*)kk, ksize, out,
                (T*)dst);
}

}  // namespace

extern "C" {

// One pass along axis (1: horizontal, over rows offset .. offset + rows;
// 0: vertical) of src [h, w, c] (kind 0: uint8 channels; 1: uint16
// samples, each read as two bytes little-endian; 2: int32; 3: float32)
// into dst ([rows, out, c] or [out, w, c]).  lo/len (int64 [out]) and kk
// ([out, ksize]: int32 for kind 0, double otherwise) are
// precompute_coeffs' bounds and taps.  Returns 0, or -1 for an unknown
// kind.
long long unmicst_resample_pass(const void* src, long long w, long long c,
                                int kind, int axis, const long long* lo,
                                const long long* len, const void* kk,
                                long long ksize, long long out,
                                long long offset, long long rows, void* dst) {
  switch (kind) {
    case 0:
      run<U8>(src, w, c, axis, lo, len, kk, ksize, out, offset, rows, dst);
      return 0;
    case 1:
      run<U16>(src, w, c, axis, lo, len, kk, ksize, out, offset, rows, dst);
      return 0;
    case 2:
      run<I32>(src, w, c, axis, lo, len, kk, ksize, out, offset, rows, dst);
      return 0;
    case 3:
      run<F32>(src, w, c, axis, lo, len, kk, ksize, out, offset, rows, dst);
      return 0;
  }
  return -1;
}

// In place over n pixels of c uint8 channels, the last alpha: inverse 0
// multiplies each colour by alpha (rgba2rgbA: c * a / 255 with
// MULDIV255's rounding), inverse 1 divides it back (rgbA2rgba:
// 255 * c / a clipped, where a is neither 0 nor 255).
void unmicst_alpha_multiply(uint8_t* px, long long n, long long c,
                            int inverse) {
  for (long long i = 0; i < n; i++, px += c) {
    unsigned a = px[c - 1];
    for (long long k = 0; k < c - 1; k++) {
      if (!inverse) {
        unsigned t = px[k] * a + 128;
        px[k] = (uint8_t)(((t >> 8) + t) >> 8);
      } else if (a != 0 && a != 255) {
        unsigned v = 255u * px[k] / a;
        px[k] = (uint8_t)(v > 255 ? 255 : v);
      }
    }
  }
}

}  // extern "C"
