// The block-compressed texture decoders of Pillow 12's BcnDecode.c, for
// unmicst_tpu_torch/io/bcn.py (the DDS and FTEX reads): BC1-BC5 (BC5S
// signed), BC6H (BC6HS signed) and BC7, each block to its 16 pixels of
// four bytes in raster order.  The module's decode_blocks_py is the same
// arithmetic in numpy: the two give the same bytes.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC -ffp-contract=off: BC6H's
//        float multiply is one rounding on every host).

#include <cstdint>
#include <cstring>

namespace {

struct Px {
  int r, g, b, a;
};

inline int get_bit(const uint8_t* s, int bit) {
  return (s[bit >> 3] >> (bit & 7)) & 1;
}

inline int get_bits(const uint8_t* s, int bit, int count) {
  int v = 0;
  for (int j = 0; j < count; j++) v |= get_bit(s, bit + j) << j;
  return v;
}

inline int u16(const uint8_t* s) { return s[0] | (s[1] << 8); }

void bc1_colour(Px* out, const uint8_t* s, bool four) {
  int c0 = u16(s), c1 = u16(s + 2);
  Px p[4];
  for (int k = 0; k < 2; k++) {
    int c = k ? c1 : c0;
    int r = (c >> 11) & 31, g = (c >> 5) & 63, b = c & 31;
    p[k] = {(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2),
            255};
  }
  if (c0 > c1 || four) {
    p[2] = {(2 * p[0].r + p[1].r) / 3, (2 * p[0].g + p[1].g) / 3,
            (2 * p[0].b + p[1].b) / 3, 255};
    p[3] = {(p[0].r + 2 * p[1].r) / 3, (p[0].g + 2 * p[1].g) / 3,
            (p[0].b + 2 * p[1].b) / 3, 255};
  } else {
    p[2] = {(p[0].r + p[1].r) / 2, (p[0].g + p[1].g) / 2,
            (p[0].b + p[1].b) / 2, 255};
    p[3] = {0, 0, 0, 0};
  }
  uint32_t lut = u16(s + 4) | (uint32_t)u16(s + 6) << 16;
  for (int n = 0; n < 16; n++) out[n] = p[(lut >> (2 * n)) & 3];
}

// the interpolated 8-bit block at s into channel o of out
void bc3_alpha(Px* out, const uint8_t* s, int o, bool sign) {
  int a0 = s[0], a1 = s[1];
  if (sign) {
    a0 ^= 128;
    a1 ^= 128;
  }
  int a[8] = {a0, a1};
  if (a0 > a1) {
    for (int k = 0; k < 6; k++) a[2 + k] = ((6 - k) * a0 + (k + 1) * a1) / 7;
  } else {
    for (int k = 0; k < 4; k++) a[2 + k] = ((4 - k) * a0 + (k + 1) * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  for (int half = 0; half < 2; half++) {
    const uint8_t* b = s + 2 + 3 * half;
    int lut = b[0] | (b[1] << 8) | (b[2] << 16);
    for (int n = 0; n < 8; n++) {
      int v = a[(lut >> (3 * n)) & 7] & 255;
      Px& px = out[8 * half + n];
      (o == 0 ? px.r : o == 1 ? px.g : o == 2 ? px.b : px.a) = v;
    }
  }
}

// -- BC7 and BC6H tables (D3D11 functional specification) -------------------

const uint8_t BC7_MODES[8][10] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
const uint16_t P2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t P3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
const uint8_t A2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t A3A[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t A3B[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const int W2[4] = {0, 21, 43, 64};
const int W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int n) { return n == 2 ? W2 : n == 3 ? W3 : W4; }

int subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (P2[partition] >> n);
  if (ns == 3) return 3 & (P3[partition] >> (2 * n));
  return 0;
}

bool anchor(int ns, int partition, int s, int n) {
  if (n == 0) return true;
  if (ns == 2) return n == A2[partition];
  if (ns == 3) return (s == 1 && n == A3A[partition]) ||
                      (s == 2 && n == A3B[partition]);
  return false;
}

inline int expand(int v, int bits) {
  v = (v << (8 - bits)) & 255;
  return v | (v >> bits);
}

void bc7(Px* out, const uint8_t* s) {
  if (!s[0]) {  // no mode bit: opaque black
    for (int n = 0; n < 16; n++) out[n] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(s[0] & (1 << mode))) mode++;
  const uint8_t* m = BC7_MODES[mode];
  int ns = m[0], pb = m[1], rb = m[2], isb = m[3], cb = m[4], ab = m[5];
  int epb = m[6], spb = m[7], ib = m[8], ib2 = m[9];
  int bit = mode + 1;
  int partition = get_bits(s, bit, pb);
  bit += pb;
  int rotation = get_bits(s, bit, rb);
  bit += rb;
  int index_sel = get_bits(s, bit, isb);
  bit += isb;
  int numep = 2 * ns;
  int ep[6][4];
  for (int c = 0; c < 3; c++)
    for (int i = 0; i < numep; i++, bit += cb) ep[i][c] = get_bits(s, bit, cb);
  for (int i = 0; i < numep; i++) {
    ep[i][3] = ab ? get_bits(s, bit, ab) : 255;
    bit += ab;
  }
  int chans = ab ? 4 : 3, cbits = cb, abits = ab;
  if (epb) {
    cbits++;
    if (ab) abits++;
    for (int i = 0; i < numep; i++) {
      int p = get_bit(s, bit++);
      for (int c = 0; c < chans; c++) ep[i][c] = ((ep[i][c] << 1) | p) & 255;
    }
  }
  if (spb) {
    cbits++;
    if (ab) abits++;
    for (int i = 0; i < numep; i += 2) {
      int p = get_bit(s, bit++);
      for (int j = 0; j < 2; j++)
        for (int c = 0; c < chans; c++)
          ep[i + j][c] = ((ep[i + j][c] << 1) | p) & 255;
    }
  }
  for (int i = 0; i < numep; i++) {
    for (int c = 0; c < 3; c++) ep[i][c] = expand(ep[i][c], cbits);
    if (ab) ep[i][3] = expand(ep[i][3], abits);
  }
  const int* cw = weights(ib);
  const int* aw = weights(ab && ib2 ? ib2 : ib);
  int cibit = bit, aibit = bit + 16 * ib - ns;
  for (int n = 0; n < 16; n++) {
    int sub = subset(ns, partition, n);
    int nb = ib - (anchor(ns, partition, sub, n) ? 1 : 0);
    int i0 = get_bits(s, cibit, nb);
    cibit += nb;
    int sc, sa;
    if (ab && ib2) {
      int nb2 = ib2 - (n == 0 ? 1 : 0);
      int i1 = get_bits(s, aibit, nb2);
      aibit += nb2;
      sc = index_sel ? aw[i1] : cw[i0];
      sa = index_sel ? cw[i0] : aw[i1];
    } else {
      sc = sa = cw[i0];
    }
    const int* e0 = ep[2 * sub];
    const int* e1 = ep[2 * sub + 1];
    int v[4];
    for (int c = 0; c < 3; c++)
      v[c] = (((64 - sc) * e0[c] + sc * e1[c] + 32) >> 6) & 255;
    v[3] = (((64 - sa) * e0[3] + sa * e1[3] + 32) >> 6) & 255;
    if (rotation) {
      int t = v[rotation - 1];
      v[rotation - 1] = v[3];
      v[3] = t;
    }
    out[n] = {v[0], v[1], v[2], v[3]};
  }
}

const uint8_t BC6_MODES[14][7] = {
    {2, 1, 5, 10, 5, 5, 5},   {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4},   {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},    {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},    {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8},   {1, 1, 0, 16, 4, 4, 4}};
// each mode's endpoint bits in stream order: word * 16 + bit, the words
// r0, g0, b0, r1, g1, b1, r2, g2, b2, r3, g3, b3
const uint8_t BC6_PACKINGS[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52,
     164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
     80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
     144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20,
     21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48,
     49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160,
     161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98,
     99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112,
     113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112,
     113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82,
     83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145,
     146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112,
     113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146,
     147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112,
     113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82,
     83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145,
     146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164,
     112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81,
     82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133,
     178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51,
     52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163,
     80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101,
     144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85,
     86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85,
     86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85,
     86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12,
     11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46,
     45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

inline int sign_extend(int v, int prec) {
  v &= prec < 16 ? (1 << prec) - 1 : 0xFFFF;
  return (v & (1 << (prec - 1))) ? v - (1 << prec) : v;
}

int unquantize(int v, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << prec) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (prec - 1);
  }
  int x = (int16_t)(uint16_t)(v & 0xFFFF);
  if (prec >= 16) return x;
  bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) {
    x = x >= (1 << (prec - 1)) - 1 ? 0x7FFF
                                    : ((x << 15) + 0x4000) >> (prec - 1);
  }
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (uint32_t)(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

int finalize(int v, bool sign) {
  float f;
  if (sign) {
    f = v < 0 ? half_to_float((uint16_t)(0x8000 | ((-v) * 31 / 32)))
              : half_to_float((uint16_t)(v * 31 / 32));
  } else {
    f = half_to_float((uint16_t)(v * 31 / 64));
  }
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return (int)(uint8_t)(f * 255.0f);
}

void bc6(Px* out, const uint8_t* s, bool sign) {
  int m5 = s[0] & 31, mode, bit = 5;
  if ((m5 & 3) < 2) {
    mode = m5 & 3;
    bit = 2;
  } else if ((m5 & 3) == 2) {
    mode = 2 + (m5 >> 2);
  } else {
    mode = 10 + (m5 >> 2);
  }
  if (mode >= 14) {  // reserved: black
    for (int n = 0; n < 16; n++) out[n] = {0, 0, 0, 0};
    return;
  }
  const uint8_t* m = BC6_MODES[mode];
  int ns = m[0], tr = m[1], pb = m[2], epb = m[3];
  int deltas[3] = {m[4], m[5], m[6]};
  int epbits = ns == 2 ? (mode < 2 ? 75 : 72) : 60;
  int ep[12] = {0};
  for (int i = 0; i < epbits; i++) {
    int d = BC6_PACKINGS[mode][i];
    ep[d >> 4] |= get_bit(s, bit + i) << (d & 15);
  }
  bit += epbits;
  int partition = get_bits(s, bit, pb);
  bit += pb;
  int numep = ns == 2 ? 12 : 6;
  if (sign)
    for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], epb);
  if (sign || tr)
    for (int i = 3; i < numep; i++) ep[i] = sign_extend(ep[i], deltas[i % 3]);
  if (tr)  // the sum is not sign-extended again, as Pillow leaves it
    for (int i = 3; i < numep; i++)
      ep[i] = (ep[i] + ep[i % 3]) & ((1 << epb) - 1);
  int uq[12];
  for (int i = 0; i < numep; i++) uq[i] = unquantize(ep[i], epb, sign);
  int ib = ns == 2 ? 3 : 4;
  const int* w = weights(ib);
  for (int n = 0; n < 16; n++) {
    int sub = subset(ns, partition, n);
    int nb = ib - (anchor(ns, partition, sub, n) ? 1 : 0);
    int i0 = get_bits(s, bit, nb);
    bit += nb;
    int t = w[i0];
    const int* e0 = uq + 6 * sub;
    const int* e1 = e0 + 3;
    int v[3];
    for (int c = 0; c < 3; c++)
      v[c] = finalize((e0[c] * (64 - t) + e1[c] * t) >> 6, sign);
    out[n] = {v[0], v[1], v[2], 0};
  }
}

}  // namespace

extern "C" {

// Decode nblocks blocks of decoder n (1-7; `sign`: BC5S, BC6HS) from src
// into out, 64 bytes a block: its 16 pixels of four bytes in raster order
// (L in the first byte, RGB in the first three).  Returns 0, or -1 for an
// unknown decoder.
long long unmicst_bcn_decode(const uint8_t* src, long long nblocks, int n,
                             int sign, uint8_t* out) {
  static const int size[8] = {0, 8, 16, 16, 8, 16, 16, 16};
  if (n < 1 || n > 7) return -1;
  for (long long k = 0; k < nblocks; k++) {
    const uint8_t* s = src + k * size[n];
    Px px[16];
    memset(px, 0, sizeof px);
    switch (n) {
      case 1:
        bc1_colour(px, s, false);
        break;
      case 2:
        bc1_colour(px, s + 8, true);
        for (int i = 0; i < 16; i++) {
          int v = (s[i >> 1] >> (4 * (i & 1))) & 15;
          px[i].a = v * 17;
        }
        break;
      case 3:
        bc1_colour(px, s + 8, true);
        bc3_alpha(px, s, 3, false);
        break;
      case 4:
        bc3_alpha(px, s, 0, false);
        break;
      case 5:
        bc3_alpha(px, s, 0, sign);
        bc3_alpha(px, s + 8, 1, sign);
        if (sign)
          for (int i = 0; i < 16; i++) px[i].b = 128;
        break;
      case 6:
        bc6(px, s, sign);
        break;
      default:
        bc7(px, s);
    }
    uint8_t* o = out + 64 * k;
    for (int i = 0; i < 16; i++) {
      o[4 * i] = (uint8_t)px[i].r;
      o[4 * i + 1] = (uint8_t)px[i].g;
      o[4 * i + 2] = (uint8_t)px[i].b;
      o[4 * i + 3] = (uint8_t)px[i].a;
    }
  }
  return 0;
}

}  // extern "C"
