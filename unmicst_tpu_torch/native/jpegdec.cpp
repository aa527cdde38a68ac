// Entropy decode of one JPEG scan (ITU T.81, Huffman coding), for
// unmicst_tpu_torch/io/jpeg.py: baseline and extended sequential scans,
// one component or several interleaved, and the four progressive kinds (DC
// first and DC refine, interleaved or not; AC first with end-of-band runs
// and AC refine, one component each); the same scans arithmetic coded
// (SOF9 / SOF10, libjpeg-turbo's jdarith.c: unmicst_jpeg_arith_scan,
// whose plain version is jpeg.py's arith_scan_py); and for lossless (SOF3)
// frames the
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
  kErrFeed = -6,     // an arithmetic scan reads at or past its limit
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

// jaricom.c's Table D.2: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7
// | Next_Index_LPS; the last entry is the fixed bin's.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder state over one scan (see jpeg.py's _QMDecoder): at a
// marker it feeds zeros and leaves the marker unread; no byte at or past
// limit is read (fail is set instead, and the scan then returns kErrFeed,
// or kErrEnds where limit is the stream's end).
struct QM {
  const uint8_t* src;
  long long limit;
  long long pos;
  int unread;  // the code of a marker reached and not yet taken, or 0
  int64_t c;
  int64_t a;
  int ct;
  bool fail;

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  int byte() {
    if (pos >= limit) {
      fail = true;
      return 0;
    }
    return src[pos++];
  }
  void next_marker() {
    for (;;) {
      int b = byte();
      while (b != 0xFF && !fail) b = byte();
      b = byte();
      while (b == 0xFF && !fail) b = byte();
      if (fail) return;
      if (b) {
        unread = b;
        return;
      }
    }
  }
  // read_restart_marker expecting RSTn, with jpeg_resync_to_restart
  void restart(int n) {
    if (!unread) next_marker();
    while (!fail && unread != 0xD0 + n) {
      const int m = unread;
      if (m >= 0xD0 && m <= 0xD7) {
        const int d = (m - 0xD0 - n + 16) % 8;
        if (d == 1 || d == 2) break;
        if (d == 6 || d == 7) {
          next_marker();
          continue;
        }
      } else if (m >= 0xC0) {
        break;
      } else {
        next_marker();
        continue;
      }
      unread = 0;
      break;
    }
    if (unread == 0xD0 + n) unread = 0;
    reset();
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int b = 0;
        if (!unread) {
          b = byte();
          if (b == 0xFF) {
            b = byte();
            while (b == 0xFF && !fail) b = byte();
            if (b == 0) {
              b = 0xFF;
            } else {
              unread = b;
              b = 0;
            }
          }
          if (fail) return 0;
        }
        c = (c << 8) | b;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const uint32_t t = kAritab[sv & 0x7F];
    const int nl = t & 0xFF, nm = (t >> 8) & 0xFF;
    const int64_t qe = t >> 16;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// Figures F.23-F.24 from bin st (past the sign): the magnitude category
// (its first decision already taken where first, as for DC), then its
// bits; false on a magnitude overflow (jdarith.c's ct = -1).
bool arith_value(QM& q, uint8_t* stats, int i, int sign, bool first,
                 int kbins, int* out) {
  int m = q.decode(stats + i);
  if (m) {
    if (first || q.decode(stats + i)) {
      if (!first) m <<= 1;
      i = kbins;
      while (q.decode(stats + i)) {
        if ((m <<= 1) == 0x8000) return false;
        ++i;
      }
    }
  }
  int v = m;
  i += 14;
  while (m >>= 1)
    if (q.decode(stats + i)) v |= m;
  *out = sign ? -(v + 1) : v + 1;
  return true;
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

// Decode one arithmetic-coded scan starting at src[pos] into coef (int16,
// natural order, updated in place), visiting the blocks as
// unmicst_jpeg_scan does.  dc_tbl / ac_tbl give each scan slot's
// conditioning table (0-15; statistics are shared by slots naming the same
// one), lows / ups / kxs its DC L and U and its AC Kx (four entries each;
// a slot the scan lacks names a table the scan's own slots reset anyway).  No byte at or past
// limit is read.  Returns the offset of the marker after the scan, or
// when the decode needs a byte at or past limit kErrFeed (limit is short of
// the stream's end: a read's) or kErrEnds (it is the stream's end).
long long unmicst_jpeg_arith_scan(const uint8_t* src, long long len,
                                  long long pos, long long limit,
                                  int16_t* coef, const int64_t* order,
                                  const uint8_t* slot, long long nblocks,
                                  long long per_mcu, const uint8_t* dc_tbl,
                                  const uint8_t* ac_tbl, const uint8_t* lows,
                                  const uint8_t* ups, const uint8_t* kxs,
                                  int ss, int se, int ah, int al,
                                  int progressive, long long restart_interval) {
  static thread_local uint8_t dc_stats[16][64], ac_stats[16][256];
  if (limit > len) limit = len;
  const long long past = limit < len ? kErrFeed : kErrEnds;
  for (long long b = 0; b < nblocks; ++b)
    if (slot[b] > 3) return kErrTable;
  const bool prog = progressive != 0;
  const bool dc_first = ss == 0 && ah == 0;
  const bool uses_dc = !prog || dc_first, uses_ac = !prog || ss > 0;
  int lo[4], up[4];
  for (int t = 0; t < 4; ++t) {
    lo[t] = (1 << (lows[t] & 15)) >> 1;
    up[t] = (1 << (ups[t] & 15)) >> 1;
  }
  int32_t last_dc[4];
  int ctx[4];
  uint8_t fixed = 113;
  auto reset_stats = [&]() {
    for (int t = 0; t < 4; ++t) {
      if (uses_dc) std::memset(dc_stats[dc_tbl[t] & 15], 0, 64);
      if (uses_ac) std::memset(ac_stats[ac_tbl[t] & 15], 0, 256);
      last_dc[t] = 0;
      ctx[t] = 0;
    }
  };
  reset_stats();
  QM q{src, limit, pos, 0, 0, 0, -16, false};
  const int p1 = 1 << al, m1 = (int)(~0u << al);
  const long long ri = restart_interval > 0 ? restart_interval : 0;
  long long togo = ri;
  int rst = 0;
  const long long nmcus = nblocks / per_mcu;
  for (long long mcu = 0; mcu < nmcus; ++mcu) {
    if (ri) {
      if (togo == 0) {
        q.restart(rst);
        if (q.fail) return past;
        rst = (rst + 1) & 7;
        reset_stats();
        togo = ri;
      }
      --togo;
    }
    if (q.ct == -1) continue;
    bool give_up = false;
    for (long long b = mcu * per_mcu; b < (mcu + 1) * per_mcu && !give_up;
         ++b) {
      int16_t* c = coef + order[b] * 64;
      const int t = slot[b];
      if (uses_dc) {
        uint8_t* st = dc_stats[dc_tbl[t] & 15];
        const int s0 = ctx[t];
        if (q.decode(st + s0) == 0) {
          ctx[t] = 0;
        } else {
          const int sign = q.decode(st + s0 + 1);
          int v;
          if (!arith_value(q, st, s0 + 2 + sign, sign, true, 20, &v)) {
            give_up = true;
            break;
          }
          int m = (v < 0 ? -v : v) - 1, top = 0;
          while (m) {
            top = m;
            m &= m - 1;
          }
          ctx[t] = top < lo[t] ? 0 : (top > up[t] ? 12 : 4) + 4 * sign;
          last_dc[t] = (int32_t)(((uint32_t)last_dc[t] + (uint32_t)v) &
                                 0xFFFF);
        }
        c[0] = (int16_t)((uint32_t)last_dc[t] << al);
        if (prog) continue;
      } else if (ss == 0) {  // DC refine
        if (q.decode(&fixed)) c[0] = (int16_t)(c[0] | p1);
        continue;
      }
      if (!prog || ah == 0) {  // sequential AC, or AC first
        uint8_t* st = ac_stats[ac_tbl[t] & 15];
        const int end = prog ? se : 63;
        for (int k = prog ? ss : 1; k <= end; ++k) {
          int i = 3 * (k - 1);
          if (q.decode(st + i)) break;
          while (q.decode(st + i + 1) == 0) {
            i += 3;
            if (++k > end) {
              give_up = true;
              break;
            }
          }
          if (give_up) break;
          const int sign = q.decode(&fixed);
          int v;
          if (!arith_value(q, st, i + 2, sign, false,
                           k <= kxs[t] ? 189 : 217, &v)) {
            give_up = true;
            break;
          }
          c[kNaturalOrder[k]] = (int16_t)((uint32_t)v << al);
        }
      } else {  // AC refine
        uint8_t* st = ac_stats[ac_tbl[t] & 15];
        int kex = se;
        while (kex > 0 && c[kNaturalOrder[kex]] == 0) --kex;
        for (int k = ss; k <= se; ++k) {
          int i = 3 * (k - 1);
          if (k > kex && q.decode(st + i)) break;
          for (;;) {
            int16_t* x = c + kNaturalOrder[k];
            if (*x) {
              if (q.decode(st + i + 2))
                *x = (int16_t)(*x + (*x < 0 ? m1 : p1));
              break;
            }
            if (q.decode(st + i + 1)) {
              *x = (int16_t)(q.decode(&fixed) ? m1 : p1);
              break;
            }
            i += 3;
            if (++k > se) {
              give_up = true;
              break;
            }
          }
          if (give_up) break;
        }
      }
    }
    if (q.fail) return past;
    if (give_up) q.ct = -1;
  }
  if (q.fail) return past;
  if (q.unread) return q.pos - 2;
  const long long at = next_marker(src, len, q.pos);
  return at < 0 ? kErrStream : at;
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
