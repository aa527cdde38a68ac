// The run-length codings of PCX, TGA, SGI, PSD and Sun raster files, for
// unmicst_tpu_torch/io/pcx.py, io/tga.py, io/sgi.py, io/psd.py and
// io/sun.py: the decodes as Pillow's PcxDecode.c, TgaRleDecode.c,
// SgiRleDecode.c, PackDecode.c and SunRleDecode.c run them under
// ImageFile.load, and the encode of PcxEncode.c.  The modules'
// rle_decode_py, rle_encode_py and packbits_rows_py are the same
// algorithms in Python: the two give the same bytes and fail on the same
// inputs.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>
#include <cstring>

namespace {

enum {
  kOk = 0,
  kOverrun = -1,    // Pillow's IMAGING_CODEC_OVERRUN
  kTruncated = -2,  // the data ends before the image
};

}  // namespace

extern "C" {

// PCX: decode from src[pos] (src is the whole file, len bytes) into out,
// rows rows of row bytes.  A byte with its top two bits set is a run of
// its low six bits' count of the next byte, any other a literal; a run
// past the row's end is cut there and noted.  Returns kOk once the last
// row is full, kOverrun where it is full but a run was cut, kTruncated
// where the data ends first.
long long unmicst_pcx_rle_decode(const uint8_t* src, long long len,
                                 long long pos, uint8_t* out, long long rows,
                                 long long row) {
  long long x = 0, y = 0;
  bool overrun = false;
  uint8_t* line = out;
  for (;;) {
    if (pos >= len) return kTruncated;
    const uint8_t c = src[pos];
    if ((c & 0xC0) == 0xC0) {
      if (len - pos < 2) return kTruncated;
      long long n = c & 0x3F;
      if (x + n > row) {
        n = row - x;
        overrun = true;
      }
      memset(line + x, src[pos + 1], n);
      x += n;
      pos += 2;
    } else {
      line[x++] = c;
      pos += 1;
    }
    if (x >= row) {
      x = 0;
      line += row;
      if (++y == rows) return overrun ? kOverrun : kOk;
    }
  }
}

// TGA: decode from src[pos] into out, rows rows of row bytes in file
// order, depth bytes a pixel.  A packet's count is its low seven bits plus
// one pixels; with the top bit set one pixel repeated (past the row's end:
// kOverrun), else that many pixels copied, on across rows.  Returns kOk
// once the last row is full, kTruncated where the data ends first (always
// for depth 0, where no packet moves on).
long long unmicst_tga_rle_decode(const uint8_t* src, long long len,
                                 long long pos, uint8_t* out, long long rows,
                                 long long row, int depth) {
  if (depth <= 0) return kTruncated;
  long long x = 0, y = 0;
  uint8_t* line = out;
  for (;;) {
    if (pos >= len) return kTruncated;
    const uint8_t c = src[pos];
    const long long n = (long long)depth * ((c & 0x7F) + 1);
    if (c & 0x80) {
      if (len - pos < 1 + depth) return kTruncated;
      if (x + n > row) return kOverrun;
      if (depth == 1) {
        memset(line + x, src[pos + 1], n);
      } else {
        for (long long i = 0; i < n; i += depth)
          memcpy(line + x + i, src + pos + 1, depth);
      }
      x += n;
      pos += 1 + depth;
      if (x >= row) {
        x = 0;
        line += row;
        if (++y == rows) return kOk;
      }
      continue;
    }
    if (len - pos < 1 + n) return kTruncated;
    const uint8_t* lit = src + pos + 1;
    pos += 1 + n;
    for (long long k = 0; k < n;) {
      const long long take = n - k < row - x ? n - k : row - x;
      memcpy(line + x, lit + k, take);
      x += take;
      k += take;
      if (x >= row) {
        x = 0;
        line += row;
        if (++y == rows) return kOk;
      }
    }
  }
}

// SGI: decode the file src (len bytes, the 512-byte header first) into out,
// ysize rows, each zsize channels of xsize * bpc bytes, rows in the
// tables' order.  Each row's channel is its own packet run from the start
// table, its length table entry counting packets down: a packet's low
// seven bits are a count (0 ends the row), its top bit a copy of that
// many samples, else one sample repeated.  A row is stored once all its
// channels are decoded, from a buffer kept across rows.  Returns kOk (also
// where a row's count ends on a packet other than an end, which stops the
// decode there) or kOverrun (tables past the file, a start before the
// data, a row past xsize, a read past the file's last byte).
long long unmicst_sgi_rle_decode(const uint8_t* src, long long len,
                                 uint8_t* out, long long ysize,
                                 long long zsize, long long xsize, int bpc) {
  const long long header = 512;
  const long long tablen = ysize * zsize;
  if (len - header < 8 * tablen) return kOverrun;
  const long long last = len - 1;
  const long long width = xsize * bpc;
  uint8_t* buf = new uint8_t[zsize * width]();  // kept across rows
  auto word = [&](long long k) -> long long {
    const uint8_t* p = src + header + 4 * k;
    return ((long long)p[0] << 24) | ((long long)p[1] << 16) |
           ((long long)p[2] << 8) | (long long)p[3];
  };
  long long rc = kOk;
  for (long long y = 0; y < ysize && rc == kOk; ++y) {
    bool stop = false;
    for (long long z = 0; z < zsize; ++z) {
      long long s = word(y + z * ysize);
      long long n = word(tablen + y + z * ysize);
      if (s < header) {
        rc = kOverrun;
        break;
      }
      uint8_t* dst = buf + z * width;
      long long x = 0;
      while (n > 0) {
        if (s + bpc - 1 > last) {
          rc = kOverrun;
          break;
        }
        const uint8_t pixel = src[s + bpc - 1];
        s += bpc;
        if (n == 1 && pixel != 0) {
          stop = true;
          break;
        }
        const long long count = pixel & 0x7F;
        if (!count) break;
        if (x + count > xsize) {
          rc = kOverrun;
          break;
        }
        if (pixel & 0x80) {
          if (s + bpc * count > last) {
            rc = kOverrun;
            break;
          }
          memcpy(dst + bpc * x, src + s, bpc * count);
          s += bpc * count;
        } else {
          if (s + bpc - 1 > last) {
            rc = kOverrun;
            break;
          }
          uint8_t* d = dst + bpc * x;
          if (bpc == 1) {
            memset(d, src[s], count);
          } else {
            const uint8_t hi = src[s], lo = src[s + 1];
            for (long long i = 0; i < count; ++i) {
              d[2 * i] = hi;
              d[2 * i + 1] = lo;
            }
          }
          s += bpc;
        }
        x += count;
        --n;
      }
      if (rc != kOk || stop) break;
    }
    if (rc != kOk || stop) break;
    memcpy(out + y * zsize * width, buf, zsize * width);
  }
  delete[] buf;
  return rc;
}

// PCX: encode h rows of total bytes, planes planes of total / planes bytes
// each, as PcxEncode.c: each plane's row coded on its own in runs of at
// most 63 (a single byte below 0xC0 as itself), then a zero byte where
// the plane's bytes are odd.  Returns the bytes written, or -1 where cap
// is too small.
long long unmicst_pcx_rle_encode(const uint8_t* rows, long long h,
                                 long long total, int planes, uint8_t* dst,
                                 long long cap) {
  const long long per = total / planes;
  const long long pad = per % 2;
  long long o = 0;
  auto flush = [&](uint8_t last, long long count) -> bool {
    if (count == 1 && last < 0xC0) {
      if (o + 1 > cap) return false;
      dst[o++] = last;
    } else if (count) {
      if (o + 2 > cap) return false;
      dst[o++] = (uint8_t)(0xC0 | count);
      dst[o++] = last;
    }
    return true;
  };
  for (long long y = 0; y < h; ++y) {
    for (int p = 0; p < planes; ++p) {
      const uint8_t* seg = rows + y * total + p * per;
      uint8_t last = seg[0];
      long long count = 1;
      for (long long i = 1; i < per; ++i) {
        if (count == 63) {
          if (!flush(last, count)) return -1;
          count = 0;
        }
        if (seg[i] == last) {
          ++count;
          continue;
        }
        if (!flush(last, count)) return -1;
        last = seg[i];
        count = 1;
      }
      if (!flush(last, count)) return -1;
      if (o + pad > cap) return -1;
      for (long long i = 0; i < pad; ++i) dst[o++] = 0;
    }
  }
  return o;
}

// PackBits as PSD channels hold it: decode from src[pos] into out, rows
// rows of row bytes.  A byte n below 0x80 copies the next n + 1 bytes,
// 0x80 does nothing, any other byte repeats the next 257 - n times; the
// bytes of a copy or run past the row's end are dropped, and the row ends
// there.  Returns kOk once the last row is full, kTruncated where the data
// end first; state[0] is the rows written, state[1] the position of the
// first byte not consumed.
long long unmicst_packbits_rows(const uint8_t* src, long long len,
                                long long pos, uint8_t* out, long long rows,
                                long long row, long long* state) {
  long long x = 0, y = 0, rc;
  uint8_t* line = out;
  for (;;) {
    if (pos >= len) { rc = kTruncated; break; }
    const uint8_t c = src[pos];
    long long n;
    if (c & 0x80) {
      if (c == 0x80) { ++pos; continue; }
      if (len - pos < 2) { rc = kTruncated; break; }
      n = 257 - c;
      if (x < row) memset(line + x, src[pos + 1], x + n > row ? row - x : n);
      pos += 2;
    } else {
      n = c + 1;
      if (len - pos < n + 1) { rc = kTruncated; break; }
      if (x < row) memcpy(line + x, src + pos + 1, x + n > row ? row - x : n);
      pos += n + 1;
    }
    x += n;
    if (x >= row) {
      x = 0;
      line += row;
      if (++y >= rows) { rc = kOk; break; }
    }
  }
  state[0] = y;
  state[1] = pos;
  return rc;
}

// Sun raster RLE: decode from src[pos] into out, rows rows of row bytes.
// 0x80 0 is one 0x80, 0x80 n v is n + 1 times v (a run past the row's end
// goes on in the next rows), any other byte itself.  Rows are written in
// place: a row is whole once the decode moves past it.  Returns kOk once
// the last row is full, kTruncated where the data end first; state[1] is
// the position of the first byte not consumed.
long long unmicst_sun_rle_rows(const uint8_t* src, long long len,
                               long long pos, uint8_t* out, long long rows,
                               long long row, long long* state) {
  const long long total = rows * row;
  long long at = 0, rc;
  for (;;) {
    if (pos >= len) { rc = kTruncated; break; }
    const uint8_t c = src[pos];
    long long n = 1;
    uint8_t v = c;
    if (c == 0x80) {
      if (len - pos < 2) { rc = kTruncated; break; }
      if (src[pos + 1] == 0) {
        pos += 2;
      } else {
        if (len - pos < 3) { rc = kTruncated; break; }
        n = (long long)src[pos + 1] + 1;
        v = src[pos + 2];
        pos += 3;
      }
    } else {
      pos += 1;
    }
    if (at + n >= total) {
      memset(out + at, v, total - at);
      rc = kOk;
      break;
    }
    memset(out + at, v, n);
    at += n;
  }
  state[0] = at / row;
  state[1] = pos;
  return rc;
}

}  // extern "C"
