// The QOI ("Quite OK Image") coding as Pillow 12's QoiImagePlugin runs it,
// for unmicst_tpu_torch/io/qoi.py: QoiEncoder.encode and QoiDecoder.decode.
// The module's encode_py and decode_py are the same loops in Python: the
// two give the same bytes, and where the data ends early this decode
// reports it and the Python one raises Pillow's exception.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>
#include <cstring>

namespace {

inline int qoi_hash(const uint8_t* p) {
  return (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
}

inline int delta(int a, int b) {
  int d = (a - b) & 255;
  return d >= 128 ? d - 256 : d;
}

}  // namespace

extern "C" {

// Encode n pixels of `bands` bytes (3 or 4) into dst (cap bytes): the
// chunks and the 8-byte end marker.  Returns the bytes written, or -1
// where cap is too small.
long long unmicst_qoi_encode(const uint8_t* px, long long n, int bands,
                             uint8_t* dst, long long cap) {
  uint8_t seen[64][4];
  memset(seen, 0, sizeof seen);
  uint8_t prev[4] = {0, 0, 0, 255};
  long long o = 0;
  int run = 0;
  for (long long i = 0; i < n; i++) {
    if (cap - o < 6) return -1;
    uint8_t p[4];
    memcpy(p, px + i * bands, bands);
    if (bands == 3) p[3] = 255;
    if (!memcmp(p, prev, 4)) {
      if (++run == 62) {
        dst[o++] = 0xC0 | (run - 1);
        run = 0;
      }
      continue;
    }
    if (run) {
      dst[o++] = 0xC0 | (run - 1);
      run = 0;
    }
    const int h = qoi_hash(p);
    if (!memcmp(seen[h], p, 4)) {
      dst[o++] = h;
    } else {
      memcpy(seen[h], p, 4);
      if (prev[3] == p[3]) {
        const int dr = delta(p[0], prev[0]), dg = delta(p[1], prev[1]),
                  db = delta(p[2], prev[2]);
        if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
          dst[o++] = 0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2);
        } else {
          const int dgr = delta(dr, dg), dgb = delta(db, dg);
          if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb &&
              dgb < 8) {
            dst[o++] = 0x80 | (dg + 32);
            dst[o++] = (dgr + 8) << 4 | (dgb + 8);
          } else {
            dst[o++] = 0xFE;
            memcpy(dst + o, p, 3);
            o += 3;
          }
        }
      } else {
        dst[o++] = 0xFF;
        memcpy(dst + o, p, 4);
        o += 4;
      }
    }
    memcpy(prev, p, 4);
  }
  if (cap - o < 9) return -1;
  if (run) dst[o++] = 0xC0 | (run - 1);
  static const uint8_t kEnd[8] = {0, 0, 0, 0, 0, 0, 0, 1};
  memcpy(dst + o, kEnd, 8);
  return o + 8;
}

// Decode from src[pos] into out (n pixels of `bands` bytes).  Returns 0
// once the image is full, -1 where the data ends first (a chunk cut
// short included).
long long unmicst_qoi_decode(const uint8_t* src, long long len, long long pos,
                             uint8_t* out, long long n, int bands) {
  uint8_t seen[64][4];
  memset(seen, 0, sizeof seen);
  uint8_t prev[4] = {0, 0, 0, 255};
  const long long need = n * bands;
  long long o = 0;
  while (o < need) {
    if (pos >= len) return -1;
    const int b = src[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (len - pos < 3) return -1;
      memcpy(v, src + pos, 3);
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (len - pos < 4) return -1;
      memcpy(v, src + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      memcpy(v, seen[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = prev[0] + ((b >> 4) & 3) - 2;
      v[1] = prev[1] + ((b >> 2) & 3) - 2;
      v[2] = prev[2] + (b & 3) - 2;
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (pos >= len) return -1;
      const int s = src[pos++];
      const int dg = (b & 63) - 32;
      v[0] = prev[0] + dg + ((s >> 4) - 8);
      v[1] = prev[1] + dg;
      v[2] = prev[2] + dg + ((s & 15) - 8);
      v[3] = prev[3];
    } else {
      for (int k = (b & 63) + 1; k > 0 && o < need; k--) {
        memcpy(out + o, prev, bands);
        o += bands;
      }
      continue;
    }
    memcpy(prev, v, 4);
    memcpy(seen[qoi_hash(v)], v, 4);
    memcpy(out + o, v, bands);
    o += bands;
  }
  return 0;
}

}  // extern "C"
