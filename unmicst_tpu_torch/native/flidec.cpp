// The FLI/FLC frame decoder of Pillow 12's FliDecode.c, for
// unmicst_tpu_torch/io/fli.py: one frame chunk (0xF1FA) and its subchunks
// onto a P image of xsize x ysize bytes.  The module's decode_py is the
// same loop in Python: the two give the same bytes and the same outcome.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>
#include <cstring>

namespace {

inline int u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

inline int32_t i32(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 |
                   (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24);
}

const long long END = -1, OVERRUN = -2, BROKEN = -3, UNKNOWN = -4;

}  // namespace

extern "C" {

// Decode the frame in buf (bytes long) onto img (ysize rows of xsize
// bytes).  Returns the bytes consumed where the caller must feed more
// (0 or more), -1 at the frame's end, -2 overrun, -3 broken data, -4 an
// unknown chunk.
long long unmicst_fli_decode(const uint8_t* buf, long long bytes, uint8_t* img,
                             long long ysize, long long xsize) {
  if (bytes < 4) return 0;
  long long framesize = (uint32_t)i32(buf);  // unsigned, as Pillow reads it
  if (bytes + bytes % 2 < framesize) return 0;
  if (bytes < 8) return OVERRUN;
  if (u16(buf + 4) != 0xF1FA) return UNKNOWN;
  int chunks = u16(buf + 6);
  const uint8_t* ptr = buf + 16;
  long long left = bytes - 16;
  for (int c = 0; c < chunks; c++) {
    if (left < 10) return OVERRUN;
    const uint8_t* end = ptr + left;
    const uint8_t* d = ptr + 6;
#define OOB(n) \
  if (d + (n) > end) return OVERRUN;
    long long x, y, i;
    switch (u16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        int lines = u16(d);
        d += 2;
        int l;
        for (l = 0, y = 0; l < lines && y < ysize; l++, y++) {
          uint8_t* row = img + y * xsize;
          OOB(2)
          int packets = u16(d);
          d += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) return OVERRUN;
              row = img + y * xsize;
            } else {
              row[xsize - 1] = (uint8_t)packets;
            }
            OOB(2)
            packets = u16(d);
            d += 2;
          }
          int p;
          for (p = 0, x = 0; p < packets; p++) {
            OOB(2)
            x += d[0];
            if (d[1] >= 128) {
              OOB(4)
              i = 256 - d[1];
              if (x + i + i > xsize) break;
              for (long long j = 0; j < i; j++) {
                row[x++] = d[2];
                row[x++] = d[3];
              }
              d += 4;
            } else {
              i = 2 * (long long)d[1];
              if (x + i > xsize) break;
              OOB(2 + i)
              memcpy(row + x, d + 2, i);
              d += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return OVERRUN;
        break;
      }
      case 12: {  // LC
        y = u16(d);
        long long ymax = y + u16(d + 2);
        d += 4;
        for (; y < ymax && y < ysize; y++) {
          uint8_t* row = img + y * xsize;
          OOB(1)
          int packets = *d++;
          int p;
          for (p = 0, x = 0; p < packets; p++, x += i) {
            OOB(2)
            x += d[0];
            if (d[1] & 0x80) {
              i = 256 - d[1];
              if (x + i > xsize) break;
              OOB(3)
              memset(row + x, d[2], i);
              d += 3;
            } else {
              i = d[1];
              if (x + i > xsize) break;
              OOB(2 + i)
              memcpy(row + x, d + 2, i);
              d += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return OVERRUN;
        break;
      }
      case 13:  // BLACK
        memset(img, 0, ysize * xsize);
        break;
      case 15:  // BRUN
        for (y = 0; y < ysize; y++) {
          uint8_t* row = img + y * xsize;
          d += 1;  // the packet count
          for (x = 0; x < xsize; x += i) {
            OOB(2)
            if (d[0] & 0x80) {
              i = 256 - d[0];
              if (x + i > xsize) break;
              OOB(i + 1)
              memcpy(row + x, d + 1, i);
              d += i + 1;
            } else {
              i = d[0];
              if (x + i > xsize) break;
              memset(row + x, d[1], i);
              d += 2;
            }
          }
          if (x != xsize) return OVERRUN;
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / xsize < ysize) return OVERRUN;
        if (d + xsize * ysize > end) return ptr - buf;
        memcpy(img, d, xsize * ysize);
        break;
      default:
        return UNKNOWN;
    }
#undef OOB
    long long advance = i32(ptr);
    if (advance == 0) return BROKEN;
    if (advance < 0 || advance > left) return OVERRUN;
    ptr += advance;
    left -= advance;
  }
  return END;
}

}  // extern "C"
