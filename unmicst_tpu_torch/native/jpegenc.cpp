// Huffman coding of a baseline JPEG scan, for unmicst_tpu_torch/io/
// jpegenc.py: libjpeg's jchuff.c encode_one_block over blocks already in
// scan order.  The colour conversion, the sampling, the forward DCT, the
// quantisation and the markers stay in Python; this is the bit-serial
// loop.  jpegenc.py's encode_blocks_py is the same algorithm in Python:
// the two write the same bytes.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Writer {
  uint8_t* dst;
  long long cap;
  long long n;
  uint64_t acc;
  int nacc;
  bool full;

  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nacc += size;
    while (nacc >= 8) {
      const uint8_t b = (uint8_t)(acc >> (nacc - 8));
      nacc -= 8;
      if (n + 2 > cap) {
        full = true;
        return;
      }
      dst[n++] = b;
      if (b == 0xFF) dst[n++] = 0;
    }
    acc &= (nacc ? ((1ull << nacc) - 1) : 0);
  }
};

inline int nbits(int v) {
  unsigned a = (unsigned)(v < 0 ? -v : v);
  int k = 0;
  while (a) {
    ++k;
    a >>= 1;
  }
  return k;
}

}  // namespace

extern "C" {

// Code n blocks (coef: int16[n][64], natural order, scan order); block i
// belongs to scan component slot[i], whose DC and AC tables are rows
// slot[i] of dc_code/dc_size and ac_code/ac_size (256 entries each).
// Returns the bytes written to dst, or -1 when cap is too small.
long long unmicst_jpeg_huff_encode(const int16_t* coef, const uint8_t* slot,
                                   long long n, const int32_t* dc_code,
                                   const int32_t* dc_size,
                                   const int32_t* ac_code,
                                   const int32_t* ac_size, int nslots,
                                   uint8_t* dst, long long cap) {
  Writer w{dst, cap, 0, 0, 0, false};
  int last[4] = {0, 0, 0, 0};
  for (long long b = 0; b < n && !w.full; ++b) {
    const int16_t* c = coef + b * 64;
    const int t = slot[b];
    if (t >= nslots || t > 3) return -1;
    const int32_t* dco = dc_code + 256 * t;
    const int32_t* dsz = dc_size + 256 * t;
    const int32_t* aco = ac_code + 256 * t;
    const int32_t* asz = ac_size + 256 * t;
    const int diff = c[0] - last[t];
    last[t] = c[0];
    int k = nbits(diff);
    w.put((uint32_t)dco[k], dsz[k]);
    if (k) w.put((uint32_t)(diff < 0 ? diff - 1 : diff), k);
    int run = 0;
    for (int i = 1; i < 64; ++i) {
      const int v = c[kZigzag[i]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        w.put((uint32_t)aco[0xF0], asz[0xF0]);
        run -= 16;
      }
      k = nbits(v);
      const int sym = (run << 4) + k;
      w.put((uint32_t)aco[sym], asz[sym]);
      w.put((uint32_t)(v < 0 ? v - 1 : v), k);
      run = 0;
    }
    if (run) w.put((uint32_t)aco[0], asz[0]);
  }
  if (w.nacc && !w.full) w.put(0x7F, 8 - w.nacc);
  return w.full ? -1 : w.n;
}

}  // extern "C"
