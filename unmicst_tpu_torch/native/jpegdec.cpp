// Entropy decode of one JPEG scan (ITU T.81, Huffman coding), for
// unmicst_tpu_torch/io/jpeg.py: baseline and extended sequential scans,
// one component or several interleaved, and the four progressive kinds (DC
// first and DC refine, interleaved or not; AC first with end-of-band runs
// and AC refine, one component each); and for lossless (SOF3) frames the
// scan's differences (libjpeg-turbo's jdlhuff.c) and their undoing by the
// predictor (jdpred.c, with jdlossls.c's point transform), which is
// sequential along each row.  The marker structure, the tables,
// the block order of the scan's MCUs, the inverse DCT, the upsampling and
// the colour conversion stay in Python; this is the bit-serial loop, which
// runs at about 1 MB/s there.
//
// It follows libjpeg's jdhuff.c / jdphuff.c: coefficients are int16 in
// natural order, the DC predictors (one per component of the scan) and the
// end-of-band run reset at each restart marker, lookahead past the end of
// an interval's data reads zero bits, and bits that a code actually needs
// past that end are an error.  jpeg.py's decode_scan_py is the same
// algorithm in Python: the two give the same coefficients and fail on the
// same inputs.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>
#include <cstring>

namespace {

const int kNaturalOrder[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum {
  kErrEnds = -1,     // entropy-coded data ends before a code it needs
  kErrCode = -2,     // a bit pattern that is no code of the table
  kErrRestart = -3,  // a restart marker missing, out of order or stray
  kErrTable = -4,    // a Huffman table the decode needs is missing
  kErrStream = -5,   // the stream ends with no marker after the scan
};

const int kLookBits = 9;

struct Huff {
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer
  int32_t maxcode[18];            // largest code of each length, -1 none
  int32_t valoff[17];             // values index of a length's first code
  uint8_t vals[256];
};

// Canonical codes from BITS (16 counts) and HUFFVAL; Python has checked
// that they fit their lengths.
void build(const uint8_t* bits, const uint8_t* vals, Huff& h) {
  std::memset(h.look, 0, sizeof(h.look));
  int32_t code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valoff[len] = k - code;
    for (int i = 0; i < bits[len - 1]; ++i) {
      uint8_t sym = vals[k];
      h.vals[k] = sym;
      if (len <= kLookBits) {
        int shift = kLookBits - len;
        for (int j = 0; j < (1 << shift); ++j)
          h.look[(code << shift) | j] = (uint16_t)((len << 8) | sym);
      }
      ++code;
      ++k;
    }
    h.maxcode[len] = bits[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
}

struct Reader {
  const uint8_t* src;
  long long len;
  long long pos;  // next byte to load; at a marker it stays on its 0xFF
  uint64_t buf;   // the low nbits bits are real, unread data
  int nbits;
  bool stop;  // reached a marker or the end of the stream

  void fill() {
    while (nbits <= 56 && !stop) {
      if (pos >= len) {
        stop = true;
        break;
      }
      uint8_t b = src[pos];
      if (b == 0xFF) {
        if (pos + 1 >= len || src[pos + 1] != 0x00) {
          stop = true;
          break;
        }
        pos += 2;
      } else {
        pos += 1;
      }
      buf = (buf << 8) | b;
      nbits += 8;
    }
  }
  // the next k (<= 16) bits, zeros past the real data
  uint32_t peek(int k) {
    if (nbits < k) fill();
    if (nbits >= k) return (uint32_t)(buf >> (nbits - k)) & ((1u << k) - 1);
    return (uint32_t)(buf << (k - nbits)) & ((1u << k) - 1);
  }
  // take k real bits; false when they are not there
  bool take(int k, uint32_t* v) {
    if (k == 0) {
      *v = 0;
      return true;
    }
    uint32_t x = peek(k);
    if (k > nbits) return false;
    nbits -= k;
    *v = x;
    return true;
  }
  // the symbol of the next code; -1 past the data, -2 no such code
  int symbol(const Huff& h) {
    uint32_t v = peek(16);
    int len, sym;
    uint16_t e = h.look[v >> (16 - kLookBits)];
    if (e) {
      len = e >> 8;
      sym = e & 0xFF;
    } else {
      len = kLookBits + 1;
      while (len <= 16 && (int32_t)(v >> (16 - len)) > h.maxcode[len]) ++len;
      if (len > 16) return kErrCode;
      sym = h.vals[h.valoff[len] + (int32_t)(v >> (16 - len))];
    }
    if (len > nbits) return kErrEnds;
    nbits -= len;
    return sym;
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

// The offset of the 0xFF of the next marker at or after pos (stuffed and
// fill bytes skipped, extraneous data skipped as libjpeg does); -1 none.
long long next_marker(const uint8_t* src, long long len, long long pos) {
  for (;;) {
    while (pos < len && src[pos] != 0xFF) ++pos;
    if (pos + 1 >= len) return -1;
    if (src[pos + 1] == 0x00)
      pos += 2;
    else if (src[pos + 1] == 0xFF)
      pos += 1;
    else
      return pos;
  }
}

}  // namespace

extern "C" {

// Decode one scan starting at src[pos] into coef (int16, natural order,
// updated in place).  The scan visits nblocks blocks: block i is
// coef[order[i] * 64 ..] and belongs to the scan's component slot[i]
// (0-3), per_mcu blocks to an MCU.  dc_bits/dc_vals and ac_bits/ac_vals
// hold four tables each (BITS: 16 counts, HUFFVAL: 256 bytes a slot);
// bit s of dc_mask / ac_mask says that slot s has one.  restart_interval
// counts MCUs.  Returns the offset of the marker after the scan, or a
// negative error code (k* above).
long long unmicst_jpeg_scan(const uint8_t* src, long long len, long long pos,
                            int16_t* coef, const int64_t* order,
                            const uint8_t* slot, long long nblocks,
                            long long per_mcu, const uint8_t* dc_bits,
                            const uint8_t* dc_vals, const uint8_t* ac_bits,
                            const uint8_t* ac_vals, int dc_mask, int ac_mask,
                            int ss, int se, int ah, int al, int progressive,
                            long long restart_interval) {
  static thread_local Huff dc[4], ac[4];
  const bool seq = !progressive;
  const bool dc_first = ss == 0 && ah == 0;
  for (int t = 0; t < 4; ++t) {
    if ((dc_mask >> t) & 1) build(dc_bits + 16 * t, dc_vals + 256 * t, dc[t]);
    if ((ac_mask >> t) & 1) build(ac_bits + 16 * t, ac_vals + 256 * t, ac[t]);
  }
  const bool need_dc = seq || dc_first, need_ac = seq || ss > 0;
  for (long long b = 0; b < nblocks; ++b) {
    const int t = slot[b];
    if (t > 3 || (need_dc && !((dc_mask >> t) & 1)) ||
        (need_ac && !((ac_mask >> t) & 1)))
      return kErrTable;
  }
  const int p1 = 1 << al, m1 = (int)(~0u << al);
  const long long ri = restart_interval > 0 ? restart_interval * per_mcu
                                            : nblocks;
  Reader rd{src, len, pos, 0, 0, false};
  uint32_t v;
  for (long long start = 0; start < nblocks; start += ri) {
    int32_t last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const long long stop = start + ri < nblocks ? start + ri : nblocks;
    for (long long b = start; b < stop; ++b) {
      int16_t* c = coef + order[b] * 64;
      const int t = slot[b];
      if (seq || dc_first) {
        int s = rd.symbol(dc[t]);
        if (s < 0) return s;
        if (s) {
          if (!rd.take(s, &v)) return kErrEnds;
          s = extend(v, s);
        }
        last_dc[t] = (int32_t)((uint32_t)last_dc[t] + (uint32_t)s);
        c[0] = (int16_t)((uint32_t)last_dc[t] << al);
        if (!seq) continue;
        for (int k = 1; k < 64; ++k) {
          int rs = rd.symbol(ac[t]);
          if (rs < 0) return rs;
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (!rd.take(s, &v)) return kErrEnds;
            c[kNaturalOrder[k]] = (int16_t)extend(v, s);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0) {  // DC refine
        if (!rd.take(1, &v)) return kErrEnds;
        if (v) c[0] = (int16_t)(c[0] | p1);
      } else if (ah == 0) {  // AC first
        if (eobrun > 0) {
          --eobrun;
          continue;
        }
        for (int k = ss; k <= se; ++k) {
          int rs = rd.symbol(ac[t]);
          if (rs < 0) return rs;
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (!rd.take(s, &v)) return kErrEnds;
            c[kNaturalOrder[k]] =
                (int16_t)((uint32_t)extend(v, s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) {
              if (!rd.take(r, &v)) return kErrEnds;
              eobrun += (int)v;
            }
            --eobrun;
            break;
          }
        }
      } else {  // AC refine
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            int rs = rd.symbol(ac[t]);
            if (rs < 0) return rs;
            int r = rs >> 4, s = rs & 15;
            if (s) {
              if (!rd.take(1, &v)) return kErrEnds;
              s = v ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) {
                if (!rd.take(r, &v)) return kErrEnds;
                eobrun += (int)v;
              }
              break;
            }
            do {
              int16_t* t = c + kNaturalOrder[k];
              if (*t != 0) {
                if (!rd.take(1, &v)) return kErrEnds;
                if (v && (*t & p1) == 0)
                  *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) c[kNaturalOrder[k]] = (int16_t)s;
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t* t = c + kNaturalOrder[k];
            if (*t != 0) {
              if (!rd.take(1, &v)) return kErrEnds;
              if (v && (*t & p1) == 0)
                *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
            }
          }
          --eobrun;
        }
      }
    }
    // the interval's padding bits go; the next marker follows its data
    long long at = next_marker(src, len, rd.pos);
    if (at < 0) return kErrStream;
    const int m = src[at + 1];
    if (stop < nblocks) {
      if (m != 0xD0 + (int)((start / ri) % 8)) return kErrRestart;
      at += 2;
    } else if (m >= 0xD0 && m <= 0xD7) {
      return kErrRestart;
    }
    rd = Reader{src, len, at, 0, 0, false};
    pos = at;
  }
  return pos;
}

// Decode one lossless scan starting at src[pos] into diffs (int32, ns
// planes of h x w, each MCU one sample of each of the ns scan components):
// a difference category (0-16) from the component slot's table, then its
// bits (16 means 32768, with none).  dc_bits/dc_vals hold four tables (by
// slot), bit s of dc_mask says slot s has one.  restart_interval counts
// MCUs.  Returns the offset of the marker after the scan, or a negative
// error code (k* above).
long long unmicst_jpeg_lossless_scan(const uint8_t* src, long long len,
                                     long long pos, int32_t* diffs, int ns,
                                     long long h, long long w,
                                     const uint8_t* dc_bits,
                                     const uint8_t* dc_vals, int dc_mask,
                                     long long restart_interval) {
  static thread_local Huff dc[4];
  if (ns < 1 || ns > 4) return kErrTable;
  for (int t = 0; t < ns; ++t) {
    if (!((dc_mask >> t) & 1)) return kErrTable;
    build(dc_bits + 16 * t, dc_vals + 256 * t, dc[t]);
  }
  const long long n = h * w;
  const long long ri = restart_interval > 0 ? restart_interval : n;
  Reader rd{src, len, pos, 0, 0, false};
  uint32_t v;
  for (long long start = 0; start < n; start += ri) {
    const long long stop = start + ri < n ? start + ri : n;
    for (long long i = start; i < stop; ++i) {
      for (int k = 0; k < ns; ++k) {
        int s = rd.symbol(dc[k]);
        if (s < 0) return s;
        int d = 0;
        if (s == 16) {
          d = 32768;
        } else if (s) {
          if (!rd.take(s, &v)) return kErrEnds;
          d = extend(v, s);
        }
        diffs[k * n + i] = d;
      }
    }
    long long at = next_marker(src, len, rd.pos);
    if (at < 0) return kErrStream;
    const int m = src[at + 1];
    if (stop < n) {
      if (m != 0xD0 + (int)((start / ri) % 8)) return kErrRestart;
      at += 2;
    } else if (m >= 0xD0 && m <= 0xD7) {
      return kErrRestart;
    }
    rd = Reader{src, len, at, 0, 0, false};
    pos = at;
  }
  return pos;
}

// Undo one component's differences (h x w int32) into 8-bit samples: the
// first row, and the first after each restart_rows rows, predicted from
// the left (its first sample from 2**(7 - pt)); every other row's first
// sample from above and the rest by the predictor (1-7), modulo 2**16;
// then each sample << pt, stored in a byte.
void unmicst_jpeg_undifference(const int32_t* diff, uint8_t* out,
                               long long h, long long w, int predictor,
                               int pt, long long restart_rows) {
  uint32_t* prev = new uint32_t[w];
  uint32_t* row = new uint32_t[w];
  for (long long r = 0; r < h; ++r) {
    const int32_t* d = diff + r * w;
    if (r == 0 || (restart_rows > 0 && r % restart_rows == 0)) {
      int32_t ra = (d[0] + (1 << (7 - pt))) & 0xFFFF;
      row[0] = (uint32_t)ra;
      for (long long x = 1; x < w; ++x) {
        ra = (d[x] + ra) & 0xFFFF;
        row[x] = (uint32_t)ra;
      }
    } else {
      int32_t rb = (int32_t)prev[0], rc;
      int32_t ra = (d[0] + rb) & 0xFFFF;
      row[0] = (uint32_t)ra;
      for (long long x = 1; x < w; ++x) {
        rc = rb;
        rb = (int32_t)prev[x];
        int32_t p;
        switch (predictor) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        ra = (d[x] + p) & 0xFFFF;
        row[x] = (uint32_t)ra;
      }
    }
    uint8_t* o = out + r * w;
    for (long long x = 0; x < w; ++x) o[x] = (uint8_t)(row[x] << pt);
    uint32_t* t = prev;
    prev = row;
    row = t;
  }
  delete[] prev;
  delete[] row;
}

}  // extern "C"
