// JPEG 2000 tier 1 and inverse wavelets for unmicst_tpu_torch/io/jpeg2000.py,
// as openjpeg 2.5 decodes them (the pixels PIL returns): the MQ decoder and
// the three coding passes of ITU-T T.800 Annex D with openjpeg's midpoint
// reconstruction, the reversible 5/3 lifting and openjpeg's float32 9/7
// lifting (its constants, its order of operations, 2/K for the high band).
// Built with the other host sources by io/_native.py (g++ -O3, no FMA
// contraction: -ffp-contract=off).  The plain versions are t1_decode_py,
// idwt53_py and idwt97_py in jpeg2000.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12,
                          13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                          25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
                          37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18,
                          20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                          22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                          34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0};

// flag bits of a sample: its 8 neighbours' significance, the signs of the
// 4 direct ones, and its own state
enum : uint32_t {
  N_SIG = 1u << 0, S_SIG = 1u << 1, W_SIG = 1u << 2, E_SIG = 1u << 3,
  NW_SIG = 1u << 4, NE_SIG = 1u << 5, SW_SIG = 1u << 6, SE_SIG = 1u << 7,
  N_NEG = 1u << 8, S_NEG = 1u << 9, W_NEG = 1u << 10, E_NEG = 1u << 11,
  SIG = 1u << 12, VIS = 1u << 13, REF = 1u << 14,
  NEIGHBOURS = 0xFFu
};

uint8_t ZC[4][256];
uint8_t SC_CTX[256], SC_XOR[256];
bool luts_ready = false;

int zc_context(int h, int v, int d, int orient) {
  if (orient == 1) { int t = h; h = v; v = t; }
  if (orient == 3) {
    int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
    return hv >= 2 ? 2 : hv;
  }
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : d >= 1 ? 6 : 5;
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : d;
}

void make_luts() {
  if (luts_ready) return;
  for (int o = 0; o < 4; ++o)
    for (int f = 0; f < 256; ++f) {
      int v = (f & 1) + ((f >> 1) & 1), h = ((f >> 2) & 1) + ((f >> 3) & 1);
      int d = ((f >> 4) & 1) + ((f >> 5) & 1) + ((f >> 6) & 1) + ((f >> 7) & 1);
      ZC[o][f] = (uint8_t)zc_context(h, v, d, o);
    }
  // index: sig N,S,W,E in bits 0-3, their signs in bits 4-7
  for (int f = 0; f < 256; ++f) {
    int vc = 0, hc = 0;
    if (f & 1) vc += (f & 16) ? -1 : 1;
    if (f & 2) vc += (f & 32) ? -1 : 1;
    if (f & 4) hc += (f & 64) ? -1 : 1;
    if (f & 8) hc += (f & 128) ? -1 : 1;
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    int ctx, x;
    if (hc == 1) { ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11; x = 0; }
    else if (hc == 0) { ctx = vc == 0 ? 9 : 10; x = vc == -1; }
    else { ctx = vc == 1 ? 11 : vc == 0 ? 12 : 13; x = 1; }
    SC_CTX[f] = (uint8_t)ctx;
    SC_XOR[f] = (uint8_t)x;
  }
  luts_ready = true;
}

struct Mq {
  const uint8_t* buf;  // the segment and two bytes of 0xFF after it
  int64_t bp;
  uint32_t a, c;
  int ct;
  uint8_t st[19], mps[19];

  void bytein() {
    uint32_t nxt = buf[bp + 1];
    if (buf[bp] == 0xFF) {
      if (nxt > 0x8F) { c += 0xFF00; ct = 8; }
      else { ++bp; c += nxt << 9; ct = 7; }
    } else { ++bp; c += nxt << 8; ct = 8; }
  }
  void init(const uint8_t* b) {
    buf = b; bp = 0;
    c = (uint32_t)buf[0] << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000;
  }
  void reset() {
    std::memset(st, 0, sizeof st); std::memset(mps, 0, sizeof mps);
    st[18] = 46; st[17] = 3; st[0] = 4;
  }
  inline int decode(int cx) {
    int s = st[cx];
    uint32_t qe = QE[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) { d = mps[cx]; st[cx] = NMPS[s]; }
      else { d = 1 - mps[cx]; if (SWITCH[s]) mps[cx] = (uint8_t)d; st[cx] = NLPS[s]; }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) { d = 1 - mps[cx]; if (SWITCH[s]) mps[cx] = (uint8_t)d; st[cx] = NLPS[s]; }
      else { d = mps[cx]; st[cx] = NMPS[s]; }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1; c <<= 1; --ct;
    } while (a < 0x8000);
    return d;
  }
};

struct Block {
  int w, h, W;
  std::vector<uint32_t> f;  // (w + 2) x (h + 2) flags
  std::vector<int32_t> v;   // w x h samples

  void setup(int w_, int h_) {
    w = w_; h = h_; W = w + 2;
    f.assign((size_t)W * (h + 2), 0);
    v.assign((size_t)w * h, 0);
  }
  inline void significant(int64_t i, int64_t k, int neg, int32_t val) {
    uint32_t* p = &f[i];
    p[0] |= SIG;
    p[-W] |= S_SIG | (neg ? S_NEG : 0);
    p[W] |= N_SIG | (neg ? N_NEG : 0);
    p[-1] |= E_SIG | (neg ? E_NEG : 0);
    p[1] |= W_SIG | (neg ? W_NEG : 0);
    p[-W - 1] |= SE_SIG; p[-W + 1] |= SW_SIG;
    p[W - 1] |= NE_SIG; p[W + 1] |= NW_SIG;
    v[k] = neg ? -val : val;
  }
  inline int sign(Mq& mq, uint32_t fl) {
    int idx = (int)((fl & 0xF) | ((fl >> 4) & 0xF0));
    return mq.decode(SC_CTX[idx]) ^ SC_XOR[idx];
  }
};

// one code-block; false where openjpeg refuses its bit-planes
bool decode_block(Block& b, const uint8_t* data, const int64_t* segs,
                  int64_t nsegs, int orient, int64_t numbps,
                  std::vector<uint8_t>& seg_buf) {
  int32_t bp = (int32_t)(uint32_t)numbps;
  if (bp >= 31) return false;
  Mq mq;
  mq.reset();
  const uint8_t* zc = ZC[orient];
  const int w = b.w, h = b.h, W = b.W;
  int passtype = 2;
  for (int64_t s = 0; s < nsegs; ++s) {
    int64_t off = segs[3 * s], len = segs[3 * s + 1], npass = segs[3 * s + 2];
    seg_buf.assign(data + off, data + off + len);
    seg_buf.push_back(0xFF);
    seg_buf.push_back(0xFF);
    mq.init(seg_buf.data());
    for (int64_t pass = 0; pass < npass && bp >= 1; ++pass) {
      const int32_t one = 1 << bp, half = one >> 1, oph = one | half;
      for (int y0 = 0; y0 < h; y0 += 4) {
        const int y1 = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          if (passtype == 0) {
            for (int y = y0; y < y1; ++y) {
              int64_t i = (int64_t)(y + 1) * W + x + 1;
              uint32_t fl = b.f[i];
              if ((fl & SIG) || !(fl & NEIGHBOURS)) continue;
              if (mq.decode(zc[fl & NEIGHBOURS]))
                b.significant(i, (int64_t)y * w + x, b.sign(mq, fl), oph);
              b.f[i] |= VIS;
            }
          } else if (passtype == 1) {
            for (int y = y0; y < y1; ++y) {
              int64_t i = (int64_t)(y + 1) * W + x + 1;
              uint32_t fl = b.f[i];
              if ((fl & (SIG | VIS)) != SIG) continue;
              int cx = (fl & REF) ? 16 : (fl & NEIGHBOURS) ? 15 : 14;
              int32_t& val = b.v[(int64_t)y * w + x];
              val += (mq.decode(cx) ^ (val < 0)) ? half : -half;
              b.f[i] |= REF;
            }
          } else {
            int start = y0;
            if (y1 - y0 == 4) {
              int64_t i = (int64_t)(y0 + 1) * W + x + 1;
              uint32_t any = b.f[i] | b.f[i + W] | b.f[i + 2 * W] |
                             b.f[i + 3 * W];
              if (!(any & (SIG | VIS | NEIGHBOURS))) {
                if (!mq.decode(17)) continue;
                int run = mq.decode(18) << 1;
                run |= mq.decode(18);
                int y = y0 + run;
                int64_t k = (int64_t)(y + 1) * W + x + 1;
                b.significant(k, (int64_t)y * w + x, b.sign(mq, b.f[k]), oph);
                start = y + 1;
              }
            }
            for (int y = start; y < y1; ++y) {
              int64_t i = (int64_t)(y + 1) * W + x + 1;
              uint32_t fl = b.f[i];
              if (fl & (SIG | VIS)) continue;
              if (mq.decode(zc[fl & NEIGHBOURS]))
                b.significant(i, (int64_t)y * w + x, b.sign(mq, fl), oph);
            }
            for (int y = y0; y < y1; ++y)
              b.f[(int64_t)(y + 1) * W + x + 1] &= ~VIS;
          }
        }
      }
      if (++passtype == 3) { passtype = 0; --bp; }
    }
  }
  return true;
}

// in-place inverse lifting of n interleaved samples x[0], x[stride], ...
// (low ones at parity cas), for the rows of a block of `cols` columns when
// stride is the row length (vertical) or 1 column (horizontal, cols = 1)
template <typename T, typename Step>
void lift_pairs(T* x, int64_t n, int64_t stride, int64_t cols, int parity,
                Step step) {
  for (int64_t p = parity; p < n; p += 2) {
    int64_t l = p - 1 >= 0 ? p - 1 : p + 1;
    int64_t r = p + 1 < n ? p + 1 : p - 1;
    T* xp = x + p * stride;
    const T* xl = x + l * stride;
    const T* xr = x + r * stride;
    for (int64_t c = 0; c < cols; ++c) step(xp[c], xl[c], xr[c]);
  }
}

void lift53(int32_t* x, int64_t n, int64_t stride, int64_t cols, int cas) {
  if (n == 1) {
    if (cas)
      for (int64_t c = 0; c < cols; ++c) x[c] /= 2;
    return;
  }
  lift_pairs(x, n, stride, cols, cas, [](int32_t& v, int32_t a, int32_t b) {
    v -= (a + b + 2) >> 2;
  });
  lift_pairs(x, n, stride, cols, 1 - cas, [](int32_t& v, int32_t a, int32_t b) {
    v += (a + b) >> 1;
  });
}

const float ALPHA = 1.586134342f, BETA = 0.052980118f;
const float GAMMA = -0.882911075f, DELTA = -0.443506852f;
const float K = 1.230174105f, TWO_INV_K = 1.625732422f;

void lift97(float* x, int64_t n, int64_t stride, int64_t cols, int cas) {
  int64_t sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  if ((cas == 0 && dn == 0 && sn <= 1) || (cas == 1 && sn == 0 && dn <= 1))
    return;
  for (int64_t p = 0; p < n; ++p) {
    float s = ((p & 1) == cas) ? K : TWO_INV_K;
    float* xp = x + p * stride;
    for (int64_t c = 0; c < cols; ++c) xp[c] = xp[c] * s;
  }
  const float cs[4] = {DELTA, GAMMA, BETA, ALPHA};
  for (int k = 0; k < 4; ++k) {
    const float cc = cs[k];
    lift_pairs(x, n, stride, cols, (k & 1) ? 1 - cas : cas,
               [cc](float& v, float a, float b) { v = v + (a + b) * cc; });
  }
}

// deinterleave -> interleave: the low half then the high half of `n`
// samples to their parities
template <typename T>
void interleave(const T* src, int64_t src_stride, T* dst, int64_t dst_stride,
                int64_t n, int64_t sn, int64_t cols, int cas) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = i < sn ? cas + 2 * i : 1 - cas + 2 * (i - sn);
    std::memcpy(dst + p * dst_stride, src + i * src_stride,
                cols * sizeof(T));
  }
}

template <typename T, typename Lift>
void idwt(T* a, int64_t stride, const int64_t* bounds, int64_t nres,
          Lift lift) {
  std::vector<T> tmp;
  for (int64_t r = 1; r < nres; ++r) {
    const int64_t* lo = bounds + 4 * (r - 1);
    const int64_t* cur = bounds + 4 * r;
    int64_t sw = lo[2] - lo[0], sh = lo[3] - lo[1];
    int64_t rw = cur[2] - cur[0], rh = cur[3] - cur[1];
    if (rw == 0 || rh == 0) continue;
    int casx = (int)(cur[0] & 1), casy = (int)(cur[1] & 1);
    tmp.resize((size_t)rh * (size_t)rw);
    for (int64_t y = 0; y < rh; ++y) {
      T* row = a + y * stride;
      interleave(row, 1, tmp.data(), 1, rw, sw, 1, casx);
      lift(tmp.data(), rw, 1, 1, casx);
      std::memcpy(row, tmp.data(), rw * sizeof(T));
    }
    interleave(a, stride, tmp.data(), rw, rh, sh, rw, casy);
    lift(tmp.data(), rh, rw, rw, casy);
    for (int64_t y = 0; y < rh; ++y)
      std::memcpy(a + y * stride, tmp.data() + y * rw, rw * sizeof(T));
  }
}

}  // namespace

extern "C" {

// Tier 1 of n code-blocks.  blocks[8 * k] = (offset into out, w, h, row
// stride, orientation 0-3, bit-planes, first segment, segments); segs[3 *
// s] = (offset into data, length, coding passes).  0, or -1 where a block
// has 31 or more bit-planes (openjpeg refuses it).
int64_t unmicst_j2k_t1(const uint8_t* data, const int64_t* blocks, int64_t n,
                       const int64_t* segs, int32_t* out) {
  make_luts();
  Block b;
  std::vector<uint8_t> seg_buf;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t* bl = blocks + 8 * k;
    b.setup((int)bl[1], (int)bl[2]);
    if (!decode_block(b, data, segs + 3 * bl[6], bl[7], (int)bl[4], bl[5],
                      seg_buf))
      return -1;
    for (int64_t y = 0; y < bl[2]; ++y)
      std::memcpy(out + bl[0] + y * bl[3], b.v.data() + y * bl[1],
                  bl[1] * sizeof(int32_t));
  }
  return 0;
}

// The inverse wavelet of a tile-component in place: its bands where
// openjpeg keeps them in `a` (row stride `stride`), `bounds` each
// resolution's x0, y0, x1, y1.
void unmicst_j2k_idwt53(int32_t* a, int64_t stride, const int64_t* bounds,
                        int64_t nres) {
  idwt(a, stride, bounds, nres, lift53);
}

void unmicst_j2k_idwt97(float* a, int64_t stride, const int64_t* bounds,
                        int64_t nres) {
  idwt(a, stride, bounds, nres, lift97);
}

}  // extern "C"
