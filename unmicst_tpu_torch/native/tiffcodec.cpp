// Native TIFF segment codecs for the slide-IO path of unmicst_tpu_torch.
//
// The reference delegates TIFF decode to libtiff via tifffile/skimage; the
// port's pure-Python reader (unmicst_tpu_torch/io/tiff.py) handles the
// formats, but Python-level LZW decode is slow for multi-GB slides.  This
// C++ library provides the hot loops (TIFF-flavor LZW with early change,
// PackBits, inflate, horizontal-predictor undo, one-call strip decode and
// two deflate encoders) behind a C ABI consumed via ctypes
// (unmicst_tpu_torch/io/_native.py), no pybind11 dependency.  It is the
// port's own copy of native/tiffcodec.cpp, with the same ABI, plus the
// floating-point predictor's undo (unmicst_fp_predictor_undo).
//
// Build: unmicst_tpu_torch/io/_native.py compiles it with the host's g++
//        at first use (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

extern "C" {

// Returns number of bytes written to dst, or -1 on corrupt stream /
// insufficient dst capacity.  The _ex variants additionally report an
// OVERRUN flag: 1 when the dst capacity was reached while the stream
// demonstrably encoded more output — mid-chunk truncation, or an exact
// fill followed by more data chunks (trailing no-op/EOI/zero-bit
// padding stays 0).  The plain decoders keep the libtiff/PIL
// accept-and-truncate posture; the flag makes writer padding
// distinguishable from an over-long (possibly corrupt) final strip,
// best-effort for exotic LZW early-change encoders.
long long unmicst_lzw_decode_ex(const uint8_t* src, long long src_len,
                                uint8_t* dst, long long dst_cap,
                                int* overrun) {
  if (overrun) *overrun = 0;
  // TIFF LZW: 9..12-bit MSB-first codes, clear=256, EOI=257, early change.
  struct Entry {
    int32_t prev;   // previous entry index, -1 for root
    uint8_t byte;   // last byte
    uint8_t first;  // first byte of the chain (O(1) KwK / new-entry)
    int32_t len;    // total length
  };
  std::vector<Entry> table(4096);
  auto reset = [&]() {
    for (int i = 0; i < 256; ++i)
      table[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
  };
  reset();
  int next_code = 258;
  int nbits = 9;

  long long out = 0;
  long long bitpos = 0;
  const long long maxbit = src_len * 8;
  int prev_code = -1;

  auto emit = [&](int code) -> long long {
    // write the chain directly into dst, back to front (no temp copy)
    long long n = table[code].len;
    if (out + n > dst_cap) {
      // chain crosses the buffer end: keep its head and stop at full —
      // libtiff semantics for writer-padded final strips (the declared
      // geometry, not the stream, bounds the output).  Cold path; an
      // entry chain is at most one byte per table add since the last
      // clear, so < 4096.
      uint8_t tmp[4096];
      if (n > (long long)sizeof(tmp)) return -1;
      long long i = n;
      int c = code;
      while (c >= 0) {
        tmp[--i] = table[c].byte;
        c = table[c].prev;
      }
      std::memcpy(dst + out, tmp, (size_t)(dst_cap - out));
      out = dst_cap;
      if (overrun) *overrun = 1;  // mid-chain truncation: always over-long
      return n;
    }
    long long i = out + n;
    int c = code;
    while (c >= 0) {
      dst[--i] = table[c].byte;
      c = table[c].prev;
    }
    out += n;
    return n;
  };

  while (bitpos + nbits <= maxbit) {
    long long byte0 = bitpos >> 3;
    uint32_t window;
    if (byte0 + 4 <= src_len) {  // hot path: one unaligned load
      uint32_t raw;
      __builtin_memcpy(&raw, src + byte0, 4);
      window = __builtin_bswap32(raw);
    } else {
      window = 0;
      for (int k = 0; k < 4; ++k) {
        window <<= 8;
        if (byte0 + k < src_len) window |= src[byte0 + k];
      }
    }
    int shift = 32 - (int)(bitpos & 7) - nbits;
    int code = (window >> shift) & ((1 << nbits) - 1);
    bitpos += nbits;

    if (code == 256) {  // clear
      reset();
      next_code = 258;
      nbits = 9;
      prev_code = -1;
      continue;
    }
    if (code == 257) break;  // EOI

    if (prev_code < 0) {
      if (code >= 256) return -1;
      if (emit(code) < 0) return -1;
      prev_code = code;
    } else {
      if (code < next_code) {
        // known code: new entry = prev + first byte of code's chain
        if (next_code < 4096) {
          table[next_code] = {prev_code, table[code].first,
                              table[prev_code].first,
                              table[prev_code].len + 1};
          ++next_code;
        }
        if (emit(code) < 0) return -1;
      } else if (code == next_code) {
        // KwK case: entry = prev + first byte of prev's chain
        if (next_code >= 4096) return -1;
        table[next_code] = {prev_code, table[prev_code].first,
                            table[prev_code].first,
                            table[prev_code].len + 1};
        ++next_code;
        if (emit(code) < 0) return -1;
      } else {
        return -1;  // corrupt
      }
      prev_code = code;
    }
    // output full: done.  Reading on would demand the EOI at the
    // spec-exact width, but encoders with the classic early-change
    // off-by-one at the final code exist in the wild (found by fuzz;
    // PIL/libtiff accept such files by stopping exactly here).
    if (out == dst_cap) break;
    // early change (TIFF spec 6.0)
    if (next_code >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  if (overrun && !*overrun && out == dst_cap) {
    // exact fill: peek whether real data follows.  EOI at the current
    // width (or one narrower — the in-the-wild early-change off-by-one)
    // or nothing but zero padding bits is a clean termination.
    bool more = false;
    for (int w : {nbits, nbits - 1}) {
      if (bitpos + w > maxbit) continue;
      long long b0 = bitpos >> 3;
      uint32_t win = 0;
      for (int k = 0; k < 4; ++k) {
        win <<= 8;
        if (b0 + k < src_len) win |= src[b0 + k];
      }
      int c = (int)((win >> (32 - (int)(bitpos & 7) - w)) & ((1u << w) - 1));
      if (c == 257) { more = false; break; }
      more = true;  // a non-EOI code fits: provisionally over-long...
    }
    if (more) {
      // ...unless every remaining bit is zero (byte padding)
      bool nonzero = false;
      for (long long b = bitpos; b < maxbit && !nonzero; ++b)
        nonzero = (src[b >> 3] >> (7 - (b & 7))) & 1;
      more = nonzero;
    }
    if (more) *overrun = 1;
  }
  return out;
}

long long unmicst_lzw_decode(const uint8_t* src, long long src_len,
                             uint8_t* dst, long long dst_cap) {
  return unmicst_lzw_decode_ex(src, src_len, dst, dst_cap, nullptr);
}

long long unmicst_packbits_decode_ex(const uint8_t* src, long long src_len,
                                     uint8_t* dst, long long dst_cap,
                                     int* overrun) {
  if (overrun) *overrun = 0;
  long long i = 0, out = 0;
  while (i < src_len) {
    uint8_t h = src[i++];
    if (h < 128) {
      long long n = h + 1;
      if (i + n > src_len) return -1;
      if (out + n > dst_cap) {  // writer-padded strip: truncate + stop
        std::memcpy(dst + out, src + i, (size_t)(dst_cap - out));
        if (overrun) *overrun = 1;  // mid-literal truncation
        return dst_cap;
      }
      std::memcpy(dst + out, src + i, (size_t)n);
      i += n;
      out += n;
    } else if (h > 128) {
      long long n = 257 - h;
      if (i >= src_len) return -1;
      if (out + n > dst_cap) {  // writer-padded strip: truncate + stop
        std::memset(dst + out, src[i], (size_t)(dst_cap - out));
        if (overrun) *overrun = 1;  // mid-run truncation
        return dst_cap;
      }
      std::memset(dst + out, src[i], (size_t)n);
      ++i;
      out += n;
    }  // h == 128: no-op
    if (out == dst_cap) {  // declared geometry reached: done
      if (overrun) {
        // exact fill: anything but no-op (128) padding after this
        // point encodes more output
        for (long long k = i; k < src_len; ++k)
          if (src[k] != 128) { *overrun = 1; break; }
      }
      return out;
    }
  }
  return out;
}

long long unmicst_packbits_decode(const uint8_t* src, long long src_len,
                                  uint8_t* dst, long long dst_cap) {
  return unmicst_packbits_decode_ex(src, src_len, dst, dst_cap, nullptr);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// zlib-wrapped DEFLATE decode (RFC 1950/1951), written from the RFCs.
//
// Two-level Huffman tables (zlib/libdeflate-style): a 2^root-entry root
// table that stays L1-resident (root <= 10 -> <= 4 KB) resolves every
// code of length <= root in one load; rarer longer codes indirect
// through per-prefix subtables.  Table entries are PACKED: a literal
// entry embeds its byte value, a length/distance entry embeds the base
// value and extra-bit count, so the hot loop computes
// value = base + extra from one bit window with no side-table loads or
// symbol-range branches, and consumes code + extra bits in one shift.
// The fast loop emits up to 3 literals per 64-bit refill.  Measured on
// the codec-bench strips (scripts/codec_bench.py): ~1.25x the unpacked
// v1 tables on literal-heavy uint16 planes, ~1.35x on match-heavy
// probability maps; the SSE2 adler32 below is ~4-7x the scalar loop
// (SSE2 is x86-64 baseline so the build stays portable; other arches
// compile the scalar fallback).
// ---------------------------------------------------------------------------

namespace {


struct BitReader {
  const uint8_t* src;
  long long len;
  long long pos = 0;
  uint64_t bits = 0;
  int nbits = 0;

  inline void refill() {
    if (nbits < 0) return;  // corrupt-stream overconsumption guard
    if (pos + 8 <= len) {
      uint64_t w;
      __builtin_memcpy(&w, src + pos, 8);
      bits |= w << nbits;
      pos += (63 - nbits) >> 3;
      nbits |= 56;
    } else {
      while (nbits <= 56 && pos < len) {
        bits |= (uint64_t)src[pos++] << nbits;
        nbits += 8;
      }
    }
  }
  inline bool take(int n, uint32_t* out) {
    if (nbits < n) refill();
    if (nbits < n) return false;
    *out = (uint32_t)(bits & ((1u << n) - 1));
    bits >>= n;
    nbits -= n;
    return true;
  }
  inline void consume(int n) {
    bits >>= n;
    nbits -= n;
  }
  inline void align_byte() {
    int drop = nbits & 7;
    bits >>= drop;
    nbits -= drop;
  }
};

// Packed entry (uint32):
//   bit31 SUB   : root-only pointer; bits 8..27 = subtable offset,
//                 bits 0..4 = subtable index width
//   bit30 LIT   : literal; bits 8..15 = byte value, bits 0..4 = code len
//   bit29 EOB   : end-of-block; bits 0..4 = code len
//   else length/distance: bits 16..28 = base, bits 8..12 = extra-bit
//                 count, bits 0..4 = code len.  0 = invalid.
enum : uint32_t { kSub = 1u << 31, kLit = 1u << 30, kEob = 1u << 29 };

struct Huff {
  std::vector<uint32_t> table;
  int root = 0;

  // sym_entry(sym) returns the flag/payload part (everything except the
  // low-5-bit code length, which build() fills in).
  template <class F>
  bool build(const uint8_t* lens, int n, int root_pref, F sym_entry) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) count[lens[i]]++;
    int max_len = 0, codes = 0;
    for (int l = 1; l <= 15; ++l)
      if (count[l]) { max_len = l; codes += count[l]; }
    if (codes == 0) {
      root = 1;
      table.assign(2, 0);
      return true;
    }
    long long kraft = 0;
    for (int l = 1; l <= 15; ++l) kraft += (long long)count[l] << (15 - l);
    if (kraft > (1ll << 15)) return false;
    if (kraft < (1ll << 15) && codes > 1) return false;
    root = max_len < root_pref ? max_len : root_pref;
    uint32_t root_size = 1u << root;

    uint32_t next[16] = {0};
    uint32_t code = 0;
    for (int l = 1; l <= 15; ++l) {
      code = (code + count[l - 1]) << 1;
      next[l] = code;
    }
    uint32_t first[16];
    std::memcpy(first, next, sizeof(first));

    uint8_t sub_bits[1u << 11] = {0};
    size_t total = root_size;
    if (max_len > root) {
      for (int sym = 0; sym < n; ++sym) {
        int l = lens[sym];
        if (l <= root) continue;
        uint32_t c = first[l]++;
        uint32_t rev = 0;
        for (int k = 0; k < l; ++k) rev |= ((c >> k) & 1u) << (l - 1 - k);
        uint32_t slot = rev & (root_size - 1);
        if (l - root > sub_bits[slot]) sub_bits[slot] = (uint8_t)(l - root);
      }
      for (uint32_t s = 0; s < root_size; ++s)
        if (sub_bits[s]) total += (size_t)1 << sub_bits[s];
    }
    table.assign(total, 0);

    size_t off = root_size;
    uint32_t sub_off[1u << 11];
    for (uint32_t s = 0; s < root_size; ++s) {
      if (max_len > root && sub_bits[s]) {
        sub_off[s] = (uint32_t)off;
        table[s] = kSub | ((uint32_t)off << 8) | sub_bits[s];
        off += (size_t)1 << sub_bits[s];
      }
    }

    for (int sym = 0; sym < n; ++sym) {
      int l = lens[sym];
      if (!l) continue;
      uint32_t c = next[l]++;
      uint32_t rev = 0;
      for (int k = 0; k < l; ++k) rev |= ((c >> k) & 1u) << (l - 1 - k);
      uint32_t entry = sym_entry(sym) | (uint32_t)l;
      if (l <= root) {
        for (uint32_t idx = rev; idx < root_size; idx += 1u << l)
          table[idx] = entry;
      } else {
        uint32_t slot = rev & (root_size - 1);
        uint32_t high = rev >> root;
        uint32_t sb = sub_bits[slot];
        for (uint32_t idx = high; idx < (1u << sb); idx += 1u << (l - root))
          table[sub_off[slot] + idx] = entry;
      }
    }
    return true;
  }

  // safe decode: returns the resolved entry (never kSub), 0 on invalid,
  // consuming nothing on truncation (caller checks *ok).
  inline uint32_t decode(BitReader& br, bool* ok) const {
    if (br.nbits < 15) br.refill();
    uint32_t e = table[br.bits & ((1u << root) - 1)];
    if (e & kSub)
      e = table[((e >> 8) & 0xfffffu) +
                ((br.bits >> root) & ((1u << (e & 31u)) - 1))];
    int l = (int)(e & 31u);
    if (e == 0 || l > br.nbits) { *ok = false; return 0; }
    br.consume(l);
    *ok = true;
    return e;
  }
};

// RFC 1951 base/extra tables, shared by the decoder's packed-entry
// builders and the encoder below.
static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,
                                      13, 15, 17, 19, 23, 27, 31, 35, 43,
                                      51, 59, 67, 83, 99, 115, 131, 163,
                                      195, 227, 258};
static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                      4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t kDistBase[30] = {1,    2,    3,     4,     5,    7,
                                       9,    13,   17,    25,    33,   49,
                                       65,   97,   129,   193,   257,  385,
                                       513,  769,  1025,  1537,  2049, 3073,
                                       4097, 6145, 8193,  12289, 16385,
                                       24577};
static const uint8_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                       4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// Entry payload builders.
inline uint32_t litlen_entry(int sym) {
  if (sym < 256) return kLit | ((uint32_t)sym << 8);
  if (sym == 256) return kEob;
  // 286/287 may legally carry a code length (the fixed table defines 288
  // codes) but are invalid in data: zero payload leaves base == 0, which
  // the decode loops reject (a real length symbol's base is >= 3)
  if (sym > 285) return 0u;
  return ((uint32_t)kLenBase[sym - 257] << 16) |
         ((uint32_t)kLenExtra[sym - 257] << 8);
}

inline uint32_t dist_entry(int sym) {
  if (sym > 29) return 0u;  // 30/31: header-legal, data-invalid
  return ((uint32_t)kDistBase[sym] << 16) | ((uint32_t)kDistExtra[sym] << 8);
}

static const uint8_t kCLPerm[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                    11, 4,  12, 3, 13, 2, 14, 1, 15};

#ifdef __SSE2__
// SSE2 adler32 (SSE2 is x86-64 baseline, so this stays portable across
// x86-64 hosts; other arches take the scalar path below).  Per 16-byte
// block starting at accumulator a0:
//   a' = a0 + S          with S = sum p[j]          (psadbw vs zero)
//   b' = b + 16*a0 + W   with W = sum (16-j)*p[j]   (unpack + pmaddwd)
uint32_t adler32(const uint8_t* p, long long n) {
  uint32_t a = 1, b = 0;
  const __m128i zero = _mm_setzero_si128();
  const __m128i wlo =
      _mm_setr_epi16(16, 15, 14, 13, 12, 11, 10, 9);
  const __m128i whi = _mm_setr_epi16(8, 7, 6, 5, 4, 3, 2, 1);
  while (n > 0) {
    long long chunk = n > 5552 ? 5552 : n;
    long long k16 = chunk & ~(long long)15;
    long long K = k16 >> 4;
    // telescoped block form over K blocks starting at accumulator a0:
    //   a' = a0 + sum_k S_k
    //   b' = b + 16*K*a0 + 16*sum_k (K-1-k)*S_k + sum_k W_k
    // where S_k = byte sum of block k (psadbw) and W_k = its in-block
    // weighted sum (unpack + pmaddwd).  v_s2 += v_s1 per block realizes
    // the (K-1-k) weights without any per-block lane extraction.
    __m128i v_s1 = zero;  // running S sums (two u64 lanes from psadbw)
    __m128i v_s2 = zero;  // sum over blocks of the running S (u64 lanes)
    __m128i vw = zero;    // sum of W terms (four i32 lanes)
    for (long long i = 0; i < k16; i += 16) {
      __m128i x = _mm_loadu_si128((const __m128i*)(p + i));
      v_s2 = _mm_add_epi64(v_s2, v_s1);
      v_s1 = _mm_add_epi64(v_s1, _mm_sad_epu8(x, zero));
      __m128i lo = _mm_unpacklo_epi8(x, zero);
      __m128i hi = _mm_unpackhi_epi8(x, zero);
      vw = _mm_add_epi32(vw, _mm_madd_epi16(lo, wlo));
      vw = _mm_add_epi32(vw, _mm_madd_epi16(hi, whi));
    }
    uint64_t s_total = (uint64_t)_mm_cvtsi128_si64(v_s1) +
                       (uint64_t)_mm_cvtsi128_si64(_mm_srli_si128(v_s1, 8));
    uint64_t s2_total = (uint64_t)_mm_cvtsi128_si64(v_s2) +
                        (uint64_t)_mm_cvtsi128_si64(_mm_srli_si128(v_s2, 8));
    __m128i t = _mm_add_epi32(vw, _mm_srli_si128(vw, 8));
    t = _mm_add_epi32(t, _mm_srli_si128(t, 4));
    uint64_t bb = (uint64_t)b + ((uint64_t)K << 4) * a + (s2_total << 4) +
                  (uint32_t)_mm_cvtsi128_si32(t);
    a += (uint32_t)s_total;
    for (long long i = k16; i < chunk; ++i) {
      a += p[i];
      bb += a;
    }
    a %= 65521;
    b = (uint32_t)(bb % 65521);
    p += chunk;
    n -= chunk;
  }
  return (b << 16) | a;
}
#else
uint32_t adler32(const uint8_t* p, long long n) {
  uint32_t a = 1, b = 0;
  while (n > 0) {
    long long chunk = n > 5552 ? 5552 : n;
    for (long long i = 0; i < chunk; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    p += chunk;
    n -= chunk;
  }
  return (b << 16) | a;
}
#endif

}  // namespace

extern "C" long long unmicst_inflate(const uint8_t* src, long long src_len, uint8_t* dst,
                  long long dst_cap) {
  if (src_len < 6) return -1;
  uint8_t cmf = src[0], flg = src[1];
  if ((cmf & 0x0f) != 8 || (flg & 0x20) || ((cmf * 256u + flg) % 31) != 0)
    return -1;

  BitReader br{src + 2, src_len - 2 - 4};
  long long out = 0;
  Huff litlen, dist;
  std::vector<uint8_t> lens(288 + 32);

  for (;;) {
    uint32_t bfinal, btype;
    if (!br.take(1, &bfinal) || !br.take(2, &btype)) return -1;

    if (btype == 0) {  // stored
      br.align_byte();
      long long p = br.pos - br.nbits / 8;
      if (p + 4 > br.len) return -1;
      uint32_t n = src[2 + p] | ((uint32_t)src[2 + p + 1] << 8);
      uint32_t nn = src[2 + p + 2] | ((uint32_t)src[2 + p + 3] << 8);
      if ((n ^ nn) != 0xffff) return -1;
      p += 4;
      if (p + n > br.len || out + n > dst_cap) return -1;
      std::memcpy(dst + out, src + 2 + p, n);
      out += n;
      br.pos = p + n;
      br.bits = 0;
      br.nbits = 0;
    } else if (btype == 1 || btype == 2) {
      if (btype == 1) {  // fixed tables
        for (int i = 0; i < 288; ++i)
          lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        if (!litlen.build(lens.data(), 288, 10, litlen_entry)) return -1;
        for (int i = 0; i < 32; ++i) lens[i] = 5;
        if (!dist.build(lens.data(), 32, 8, dist_entry)) return -1;
      } else {  // dynamic
        uint32_t hlit, hdist, hclen;
        if (!br.take(5, &hlit) || !br.take(5, &hdist) || !br.take(4, &hclen))
          return -1;
        int nlit = (int)hlit + 257, ndist = (int)hdist + 1,
            ncl = (int)hclen + 4;
        if (nlit > 286 || ndist > 30) return -1;
        uint8_t cl_lens[19] = {0};
        for (int i = 0; i < ncl; ++i) {
          uint32_t v;
          if (!br.take(3, &v)) return -1;
          cl_lens[kCLPerm[i]] = (uint8_t)v;
        }
        Huff cl;
        // code-length alphabet: payload = symbol in the LIT value slot
        if (!cl.build(cl_lens, 19, 7,
                      [](int s) { return kLit | ((uint32_t)s << 8); }))
          return -1;
        int total = nlit + ndist, i = 0;
        while (i < total) {
          bool ok;
          uint32_t e = cl.decode(br, &ok);
          if (!ok) return -1;
          int sym = (int)((e >> 8) & 0xff);
          if (sym < 16) {
            lens[i++] = (uint8_t)sym;
          } else if (sym == 16) {
            uint32_t rep;
            if (i == 0 || !br.take(2, &rep)) return -1;
            uint8_t prev = lens[i - 1];
            for (uint32_t k = 0; k < rep + 3; ++k) {
              if (i >= total) return -1;
              lens[i++] = prev;
            }
          } else {
            uint32_t rep;
            int base = sym == 17 ? 3 : 11;
            if (!br.take(sym == 17 ? 3 : 7, &rep)) return -1;
            for (uint32_t k = 0; k < rep + base; ++k) {
              if (i >= total) return -1;
              lens[i++] = 0;
            }
          }
        }
        if (lens[256] == 0) return -1;
        if (!litlen.build(lens.data(), nlit, 10, litlen_entry)) return -1;
        if (!dist.build(lens.data() + nlit, ndist, 8, dist_entry)) return -1;
      }

      const uint32_t* LT = litlen.table.data();
      const uint32_t lmask = (1u << litlen.root) - 1;
      const int lroot = litlen.root;
      const uint32_t* DT = dist.table.data();
      const uint32_t dmask = (1u << dist.root) - 1;
      const int droot = dist.root;

      // --- fast loop.  Bit budget per refill (>=56 bits): up to two
      // literals (2x15) + a third code (15) + its length extras (5) =
      // 50; the match path refills again before the distance code
      // (15 + 13 extras = 28).
      bool eob = false;
      // dst slack: max match 258 + up to 15 bytes of 16-wide overcopy
      while (out + 274 <= dst_cap && br.pos + 8 <= br.len) {
        br.refill();
        uint32_t e = LT[br.bits & lmask];
        if (e & kLit) {
          dst[out++] = (uint8_t)(e >> 8);
          br.consume(e & 31u);
          e = LT[br.bits & lmask];
          if (e & kLit) {
            dst[out++] = (uint8_t)(e >> 8);
            br.consume(e & 31u);
            e = LT[br.bits & lmask];
            if (e & kLit) {
              dst[out++] = (uint8_t)(e >> 8);
              br.consume(e & 31u);
              continue;
            }
          }
        }
        if (e & kSub) {
          e = LT[((e >> 8) & 0xfffffu) +
                 ((br.bits >> lroot) & ((1u << (e & 31u)) - 1))];
          if (e & kLit) {
            dst[out++] = (uint8_t)(e >> 8);
            br.consume(e & 31u);
            continue;
          }
        }
        if (e & kEob) {
          br.consume(e & 31u);
          eob = true;
          break;
        }
        uint32_t base = e >> 16;
        if (base == 0) return -1;  // invalid code (incl. syms 286/287)
        int cl = (int)(e & 31u), ec = (int)((e >> 8) & 31u);
        long long length = base + ((br.bits >> cl) & ((1u << ec) - 1));
        br.consume(cl + ec);

        br.refill();
        uint32_t de = DT[br.bits & dmask];
        if (de & kSub)
          de = DT[((de >> 8) & 0xfffffu) +
                  ((br.bits >> droot) & ((1u << (de & 31u)) - 1))];
        uint32_t dbase = de >> 16;
        if (dbase == 0) return -1;
        cl = (int)(de & 31u);
        ec = (int)((de >> 8) & 31u);
        long long d = dbase + ((br.bits >> cl) & ((1u << ec) - 1));
        br.consume(cl + ec);
        if (d > out) return -1;

        uint8_t* p = dst + out;
        const uint8_t* q = p - d;
        if (d >= length) {
          std::memcpy(p, q, (size_t)length);
        } else if (d == 1) {
          std::memset(p, q[0], (size_t)length);
        } else if (d >= 16) {
          long long k = 0;  // overcopy of <= 15 bytes is inside the slack
          while (k < length) {
            __builtin_memcpy(p + k, q + k, 16);
            k += 16;
          }
        } else if (d >= 8) {
          long long k = 0;
          while (k < length) {
            __builtin_memcpy(p + k, q + k, 8);
            k += 8;
          }
        } else {
          for (long long k = 0; k < length; ++k) p[k] = q[k];
        }
        out += length;
      }

      if (!eob) {
        for (;;) {  // safe tail
          bool ok;
          uint32_t e = litlen.decode(br, &ok);
          if (!ok) return -1;
          if (e & kLit) {
            if (out >= dst_cap) return -1;
            dst[out++] = (uint8_t)(e >> 8);
            continue;
          }
          if (e & kEob) break;
          uint32_t base = e >> 16;
          if (base == 0) return -1;
          int ec = (int)((e >> 8) & 31u);
          uint32_t extra = 0;
          if (ec && !br.take(ec, &extra)) return -1;
          long long length = base + extra;
          uint32_t de = dist.decode(br, &ok);
          if (!ok) return -1;
          uint32_t dbase = de >> 16;
          if (dbase == 0) return -1;
          ec = (int)((de >> 8) & 31u);
          extra = 0;
          if (ec && !br.take(ec, &extra)) return -1;
          long long d = dbase + extra;
          if (d > out || out + length > dst_cap) return -1;
          uint8_t* p = dst + out;
          const uint8_t* q = p - d;
          for (long long k = 0; k < length; ++k) p[k] = q[k];
          out += length;
        }
      }
    } else {
      return -1;
    }
    if (bfinal) break;
  }

  br.align_byte();
  long long tail = 2 + br.pos - br.nbits / 8;
  if (tail + 4 > src_len) return -1;
  uint32_t want = ((uint32_t)src[tail] << 24) |
                  ((uint32_t)src[tail + 1] << 16) |
                  ((uint32_t)src[tail + 2] << 8) | src[tail + 3];
  if (adler32(dst, out) != want) return -1;
  return out;
}


// Undo TIFF horizontal differencing predictor in place.
// rows x cols samples of `itemsize` bytes (1 or 2), little-endian.
extern "C" void unmicst_predictor_undo(uint8_t* data, long long rows,
                                       long long cols, int itemsize) {
  if (itemsize == 1) {
    for (long long r = 0; r < rows; ++r) {
      uint8_t* p = data + r * cols;
      for (long long c = 1; c < cols; ++c) p[c] = (uint8_t)(p[c] + p[c - 1]);
    }
  } else if (itemsize == 2) {
    for (long long r = 0; r < rows; ++r) {
      uint16_t* p = (uint16_t*)(data + r * cols * 2);
      for (long long c = 1; c < cols; ++c) p[c] = (uint16_t)(p[c] + p[c - 1]);
    }
  }
}


// Undo TIFF's floating-point predictor (predictor 3, TIFF Technote 3) in
// place: each of `rows` rows holds `cols` samples of `itemsize` bytes as
// byte planes, most significant first, byte-wise differenced along the
// row.  The row is summed back, then its planes are interleaved into
// native-order samples (libtiff's fpAcc).
extern "C" void unmicst_fp_predictor_undo(uint8_t* data, long long rows,
                                          long long cols, int itemsize) {
  const long long n = cols * itemsize;
  std::vector<uint8_t> tmp((size_t)n);
  const uint16_t probe = 1;
  const bool little = *(const uint8_t*)&probe == 1;
  for (long long r = 0; r < rows; ++r) {
    uint8_t* p = data + r * n;
    uint8_t acc = 0;
    for (long long i = 0; i < n; ++i)
      tmp[(size_t)i] = acc = (uint8_t)(acc + p[i]);
    for (int b = 0; b < itemsize; ++b) {
      const uint8_t* plane = tmp.data() + (long long)b * cols;
      const int at = little ? itemsize - 1 - b : b;  // plane b: byte b of
      for (long long c = 0; c < cols; ++c)             // the big-endian value
        p[c * itemsize + at] = plane[c];
    }
  }
}


// Batched strip decode: every compressed strip of a page in ONE native
// call, written straight into the destination plane — no per-strip
// Python crossing, landing buffer, or assembly copy.  `src` holds the
// file span covering all strips; src_off/src_len are strip extents
// within it, dst_off/dst_len the (ascending) output extents.  codec:
// 8 = zlib DEFLATE, 5 = TIFF LZW, 32773 = PackBits (TIFF tag values).
// Each mid-strip decodes with the REST of the plane as capacity, so the
// inflate fast loop keeps its full-slack path to the end of the strip
// (a corrupt over-long strip is caught by the exact-length check before
// anything downstream of it is trusted).  Returns 0, or -(i+1) where i
// is the first strip that failed to decode to exactly dst_len[i].
extern "C" long long unmicst_decode_strips(
    const uint8_t* src, const long long* src_off, const long long* src_len,
    const long long* dst_off, const long long* dst_len, long long n,
    long long codec, uint8_t* dst, long long dst_cap) {
  for (long long i = 0; i < n; ++i) {
    if (dst_off[i] < 0 || dst_len[i] < 0 || dst_off[i] > dst_cap ||
        src_off[i] < 0 || src_len[i] < 0)
      return -(i + 1);
    long long got;
    const uint8_t* s = src + src_off[i];
    uint8_t* d = dst + dst_off[i];
    long long cap = dst_cap - dst_off[i];
    if (codec == 8)
      got = unmicst_inflate(s, src_len[i], d, cap);
    else if (codec == 5)
      got = unmicst_lzw_decode(s, src_len[i], d, cap);
    else if (codec == 32773)
      got = unmicst_packbits_decode(s, src_len[i], d, cap);
    else
      return -(i + 1);
    if (got != dst_len[i]) return -(i + 1);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CCITT bilevel decode (TIFF compressions 2, 3 and 4; ITU T.4 and T.6) of
// one strip or tile: the native side of unmicst_tpu_torch/io/ccitt.py,
// which holds the same algorithm in Python and documents it.  Rows come
// out packed MSB first, each padded to a byte, a set bit per black pixel.
// The decode is strict where libtiff's tif_fax3.c conceals: no code, an
// EOL or extension code within a row, a row of the wrong length, or data
// that ends before the last row fails.

namespace ccitt {

const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kWhiteMakeup[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackMakeup[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeup[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};
// the 2D modes, valued as a1 - b1 + 3 for vertical modes, then H and P
const char* const kModes[9] = {"0000010", "000010", "010",  "1",   "011",
                               "000011",  "0000011", "001", "0001"};
const int kHoriz = 7, kPass = 8;
const int kRunBits = 13, kModeBits = 7;

// A lookup table of `nbits`-bit prefixes: (code length << 16) | value,
// 0 where no code starts.
struct Lut {
  std::vector<uint32_t> e;
  explicit Lut(int nbits) : e((size_t)1 << nbits, 0) {}
  void add(const char* code, int value, int nbits) {
    int len = (int)strlen(code);
    uint32_t v = 0;
    for (int i = 0; i < len; ++i) v = (v << 1) | (uint32_t)(code[i] - '0');
    const uint32_t base = v << (nbits - len), n = 1u << (nbits - len);
    for (uint32_t s = 0; s < n; ++s)
      e[base | s] = ((uint32_t)len << 16) | (uint32_t)value;
  }
};

struct Tables {
  Lut white{kRunBits}, black{kRunBits}, modes{kModeBits};
  Tables() {
    for (int i = 0; i < 64; ++i) {
      white.add(kWhiteTerm[i], i, kRunBits);
      black.add(kBlackTerm[i], i, kRunBits);
    }
    for (int i = 0; i < 27; ++i) {
      white.add(kWhiteMakeup[i], 64 * (i + 1), kRunBits);
      black.add(kBlackMakeup[i], 64 * (i + 1), kRunBits);
    }
    for (int i = 0; i < 13; ++i) {
      white.add(kExtMakeup[i], 1792 + 64 * i, kRunBits);
      black.add(kExtMakeup[i], 1792 + 64 * i, kRunBits);
    }
    for (int i = 0; i < 9; ++i) modes.add(kModes[i], i, kModeBits);
  }
};

const Tables& tables() {
  static const Tables t;  // thread-safe initialisation (C++11)
  return t;
}

enum CcittFail { kEof = 1, kNoCode = 2, kLength = 3, kVertical = 4 };

struct BitReader {
  std::vector<uint8_t> buf;  // the data, then 4 zero bytes
  long long nbits, pos = 0;
  BitReader(const uint8_t* src, long long n)
      : buf((size_t)n + 4, 0), nbits(n * 8) {
    if (n > 0) memcpy(buf.data(), src, (size_t)n);
  }
  uint32_t peek(int k) const {  // k <= 24 bits, zeros past the end
    const uint8_t* p = buf.data() + (pos >> 3);
    uint32_t w = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                 ((uint32_t)p[2] << 8) | p[3];
    return (w << (pos & 7)) >> (32 - k);
  }
  int bit() const { return (buf[(size_t)(pos >> 3)] >> (7 - (pos & 7))) & 1; }
  // the next code of `lut`; its value, or -kEof / -kNoCode
  int code(const Lut& lut, int k) {  // k: the table's prefix bits
    const uint32_t e = lut.e[peek(k)];
    if (e == 0) return pos + k > nbits ? -kEof : -kNoCode;
    const int len = (int)(e >> 16);
    if (pos + len > nbits) return -kEof;
    pos += len;
    return (int)(e & 0xFFFF);
  }
  int run(int colour) {  // make-up codes, then a terminating code
    const Lut& lut = colour ? tables().black : tables().white;
    int total = 0;
    for (;;) {
      const int n = code(lut, kRunBits);
      if (n < 0) return n;
      total += n;
      if (n < 64) return total;
    }
  }
  int sync_eol() {  // libtiff's SYNC_EOL: 11 zero bits, zeros, then the 1
    int zeros = 0;
    while (zeros < 11) {
      if (pos >= nbits) return -kEof;
      zeros = bit() ? 0 : zeros + 1;
      ++pos;
    }
    for (;;) {
      if (pos >= nbits) return -kEof;
      const int b = bit();
      ++pos;
      if (b) return 0;
    }
  }
};

int row_1d(BitReader& rd, long long width, std::vector<long long>& ch) {
  ch.clear();
  long long a0 = 0;
  int colour = 0;
  while (a0 < width) {
    const int n = rd.run(colour);
    if (n < 0) return n;
    a0 += n;
    ch.push_back(a0);
    colour ^= 1;
  }
  return a0 == width ? 0 : -kLength;
}

// `ref`: the row above's changing elements, then `width` three times
int row_2d(BitReader& rd, long long width, const std::vector<long long>& ref,
           std::vector<long long>& ch) {
  ch.clear();
  long long a0 = -1;
  int colour = 0;
  size_t j = 0;
  while (a0 < width) {
    while (ref[j] <= a0) ++j;  // a0 never decreases
    size_t i = j;
    if ((int)(i & 1) != colour) ++i;
    const long long b1 = ref[i], b2 = ref[i + 1];
    const int mode = rd.code(tables().modes, kModeBits);
    if (mode < 0) return mode;
    if (mode == kPass) {
      a0 = b2;
    } else if (mode == kHoriz) {
      const int r1 = rd.run(colour);
      if (r1 < 0) return r1;
      const int r2 = rd.run(colour ^ 1);
      if (r2 < 0) return r2;
      const long long a1 = (a0 < 0 ? 0 : a0) + r1;
      a0 = a1 + r2;
      ch.push_back(a1);
      ch.push_back(a0);
    } else {
      const long long a1 = b1 + mode - 3;
      if (a1 < (a0 < 0 ? 0 : a0) || a1 > width) return -kVertical;
      ch.push_back(a1);
      a0 = a1;
      colour ^= 1;
    }
  }
  return a0 == width ? 0 : -kLength;
}

// the row's changing elements as the row below reads them (zero-length
// runs cancelled, the row's end dropped), then `width` three times
void reference(const std::vector<long long>& ch, long long width,
               std::vector<long long>& ref) {
  ref.clear();
  for (long long x : ch) {
    if (x >= width) break;
    if (!ref.empty() && ref.back() == x)
      ref.pop_back();
    else
      ref.push_back(x);
  }
  ref.insert(ref.end(), 3, width);
}

void set_bits(uint8_t* row, long long a, long long b) {  // [a, b) to 1
  while (a < b && (a & 7)) {
    row[a >> 3] |= (uint8_t)(0x80 >> (a & 7));
    ++a;
  }
  if (b - a >= 8) {
    memset(row + (a >> 3), 0xFF, (size_t)((b - a) >> 3));
    a += (b - a) & ~7LL;
  }
  while (a < b) {
    row[a >> 3] |= (uint8_t)(0x80 >> (a & 7));
    ++a;
  }
}

}  // namespace ccitt

// Decode `rows` rows of `width` pixels from one CCITT-coded strip or tile
// into dst (rows x ceil(width / 8) bytes, zeroed here).  compression: the
// TIFF tag's value (2 Modified Huffman, 3 T.4, 4 T.6); options: the
// page's T4Options (bit 0: 2D rows).  Returns 0, or -(kind) with *err_row
// set to the
// row that failed (kind 1: data ends, 2: no code, 3: a row of the wrong
// length, 4: a vertical mode outside the row; 5: bad arguments).
extern "C" long long unmicst_ccitt_decode(const uint8_t* src, long long n,
                                          uint8_t* dst, long long width,
                                          long long rows, int compression,
                                          int options,
                                          long long* err_row) {
  using namespace ccitt;
  *err_row = 0;
  if (width <= 0 || rows < 0 || n < 0 ||
      (compression != 2 && compression != 3 && compression != 4))
    return -5;
  const long long stride = (width + 7) >> 3;
  memset(dst, 0, (size_t)(stride * rows));
  ccitt::BitReader rd(src, n);
  std::vector<long long> ch, ref;
  reference(ch, width, ref);  // an all-white row above the first
  for (long long r = 0; r < rows; ++r) {
    *err_row = r;
    int rc;
    if (compression == 2) {
      rc = row_1d(rd, width, ch);
      rd.pos = (rd.pos + 7) & ~7LL;
    } else if (compression == 4) {
      rc = row_2d(rd, width, ref, ch);
    } else {
      rc = rd.sync_eol();
      if (rc == 0) {
        bool one_d = true;
        if (options & 1) {
          if (rd.pos >= rd.nbits) return -kEof;
          one_d = rd.bit() != 0;
          ++rd.pos;
        }
        rc = one_d ? row_1d(rd, width, ch) : row_2d(rd, width, ref, ch);
      }
    }
    if (rc < 0) return rc;
    reference(ch, width, ref);
    uint8_t* row = dst + r * stride;
    const size_t m = ref.size() - 3;
    for (size_t k = 0; k < m; k += 2)
      set_bits(row, ref[k], k + 1 < m ? ref[k + 1] : width);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CCITT Group 4 encode (ITU T.6) of one strip, as libtiff 4.7's Fax4Encode
// writes it (tif_fax3.c Fax3Encode2DRow, putspan, Fax4PostEncode): the
// native side of unmicst_tpu_torch/io/ccitt.py encode_g4, whose
// encode_g4_py is the same algorithm in Python.

namespace g4 {

struct Code {
  uint32_t bits;
  int len;
};

Code code_of(const char* s) {
  Code c{0, (int)strlen(s)};
  for (int i = 0; i < c.len; ++i)
    c.bits = (c.bits << 1) | (uint32_t)(s[i] - '0');
  return c;
}

struct Codes {
  Code term[2][64], makeup[2][41];  // makeup[colour][run / 64], 1..40
  Code horiz, pass, v[7];           // v[b1 - a1 + 3]
  Codes() {
    for (int i = 0; i < 64; ++i) {
      term[0][i] = code_of(ccitt::kWhiteTerm[i]);
      term[1][i] = code_of(ccitt::kBlackTerm[i]);
    }
    for (int i = 0; i < 27; ++i) {
      makeup[0][i + 1] = code_of(ccitt::kWhiteMakeup[i]);
      makeup[1][i + 1] = code_of(ccitt::kBlackMakeup[i]);
    }
    for (int i = 0; i < 13; ++i)
      makeup[0][28 + i] = makeup[1][28 + i] = code_of(ccitt::kExtMakeup[i]);
    horiz = code_of("001");
    pass = code_of("0001");
    const char* vs[7] = {"0000011", "000011", "011", "1",
                         "010",     "000010", "0000010"};
    for (int i = 0; i < 7; ++i) v[i] = code_of(vs[i]);
  }
};

const Codes& codes() {
  static const Codes c;
  return c;
}

struct BitWriter {
  uint8_t* dst;
  long long cap, n = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool overflow = false;
  void put(Code c) {
    acc = (acc << c.len) | c.bits;
    nacc += c.len;
    while (nacc >= 8) {
      nacc -= 8;
      if (n < cap)
        dst[n++] = (uint8_t)(acc >> nacc);
      else
        overflow = true;
    }
  }
  void flush() {
    if (nacc > 0) put(Code{0, 8 - nacc});
  }
};

inline int pixel(const uint8_t* row, long long i) {
  return (row[i >> 3] >> (7 - (i & 7))) & 1;
}

// libtiff's finddiff: bs past the run of `colour` starting there, at most
// to be (whole bytes skipped at a time)
long long finddiff(const uint8_t* row, long long bs, long long be,
                   int colour) {
  const uint8_t all = colour ? 0xFF : 0x00;
  long long i = bs;
  while (i < be) {
    if ((i & 7) == 0 && i + 8 <= be && row[i >> 3] == all) {
      i += 8;
      continue;
    }
    if (pixel(row, i) != colour) break;
    ++i;
  }
  return i;
}

inline long long finddiff2(const uint8_t* row, long long bs, long long be,
                           int colour) {
  return bs < be ? finddiff(row, bs, be, colour) : be;
}

void putspan(BitWriter& w, long long span, int colour) {
  const Codes& c = codes();
  while (span >= 2624) {
    w.put(c.makeup[colour][40]);
    span -= 2560;
  }
  if (span >= 64) {
    w.put(c.makeup[colour][span >> 6]);
    span &= 63;
  }
  w.put(c.term[colour][span]);
}

void encode_row(BitWriter& w, const uint8_t* bp, const uint8_t* rp,
                long long bits) {
  const Codes& c = codes();
  long long a0 = 0;
  long long a1 = pixel(bp, 0) != 0 ? 0 : finddiff(bp, 0, bits, 0);
  long long b1 = pixel(rp, 0) != 0 ? 0 : finddiff(rp, 0, bits, 0);
  for (;;) {
    long long b2 = b1 < bits ? finddiff(rp, b1, bits, pixel(rp, b1)) : bits;
    if (b2 >= a1) {
      long long d = b1 - a1;
      if (!(-3 <= d && d <= 3)) {  // horizontal mode
        long long a2 = a1 < bits ? finddiff(bp, a1, bits, pixel(bp, a1))
                                 : bits;
        w.put(c.horiz);
        int first = (a0 + a1 == 0 || pixel(bp, a0) == 0) ? 0 : 1;
        putspan(w, a1 - a0, first);
        putspan(w, a2 - a1, first ^ 1);
        a0 = a2;
      } else {  // vertical mode
        w.put(c.v[d + 3]);
        a0 = a1;
      }
    } else {  // pass mode
      w.put(c.pass);
      a0 = b2;
    }
    if (a0 >= bits) break;
    int colour = pixel(bp, a0);
    a1 = finddiff(bp, a0, bits, colour);
    b1 = finddiff(rp, a0, bits, !colour);
    b1 = finddiff(rp, b1, bits, colour);
  }
}

}  // namespace g4

// Encode `rows` rows of `width` pixels (src: rows x ceil(width / 8)
// bytes, packed MSB first, a set bit black) as one Group 4 strip into
// dst (at most cap bytes).  Returns the bytes written, -1 where cap is too
// small, -2 for bad arguments.
extern "C" long long unmicst_g4_encode(const uint8_t* src, long long width,
                                       long long rows, uint8_t* dst,
                                       long long cap) {
  if (width <= 0 || rows < 0 || cap < 0) return -2;
  const long long stride = (width + 7) >> 3;
  std::vector<uint8_t> white((size_t)stride, 0);
  g4::BitWriter w{dst, cap};
  const uint8_t* ref = white.data();
  for (long long r = 0; r < rows; ++r) {
    const uint8_t* row = src + r * stride;
    g4::encode_row(w, row, ref, width);
    ref = row;
  }
  const g4::Code eol{1, 12};
  w.put(eol);
  w.put(eol);
  w.flush();
  return w.overflow ? -1 : w.n;
}

// ---------------------------------------------------------------------------
// Fast zlib-wrapped DEFLATE encoder (RFC 1950/1951), written from the RFCs.
//
// Greedy single-probe hash matching (4-byte hash, 32K heads; inside a
// match only its two end positions are re-inserted, so long runs cost
// O(1) per 258-byte match) + per-block dynamic Huffman with an exact
// {dynamic, static, stored} cost choice per 128 KB block.  Length-limit
// via bit-length counts (each move lowers the Kraft sum by exactly one
// 2^-limit unit, so emitted codes are exactly complete — inflate rejects
// incomplete litlen sets).  Measured vs zlib on this host
// (scripts/codec_bench.py payloads): 2.3x zlib-3 on real probability
// maps at 1.7% worse ratio, 4-5x on high-entropy uint16 planes at
// BETTER ratio, >2x on runs/text.  Killed variants (measured, all worse
// on speed and no better on ratio): 2-slot hash buckets, 1-step lazy
// matching, dense in-match insertion, 16-64 KB blocks.
// ---------------------------------------------------------------------------

namespace {

// length (3..258) -> length symbol - 257
struct LenLut {
  uint8_t sym[259];
  LenLut() {
    for (int s = 0; s < 29; ++s) {
      int hi = s == 28 ? 258 : kLenBase[s + 1] - 1;
      for (int l = kLenBase[s]; l <= hi && l <= 258; ++l) sym[l] = (uint8_t)s;
    }
  }
};
const LenLut kLenLut;

// dist (1..32768) -> dist symbol: direct for 1..256, bucketed above
struct DistLut {
  uint8_t small[257];
  uint8_t big[129];  // index (dist - 1) >> 8, holds the bucket's MAX sym
  DistLut() {
    for (int s = 0; s < 30; ++s) {
      int hi = s == 29 ? 32768 : kDistBase[s + 1] - 1;
      for (int d = kDistBase[s]; d <= hi && d <= 256; ++d)
        small[d] = (uint8_t)s;
    }
    for (int i = 0; i <= 128; ++i) big[i] = 0;
    for (int s = 0; s < 30; ++s) {
      int lo = kDistBase[s], hi = s == 29 ? 32768 : kDistBase[s + 1] - 1;
      for (int d = lo > 257 ? lo : 257; d <= hi; ++d) {
        int idx = (d - 1) >> 8;
        if (big[idx] < s) big[idx] = (uint8_t)s;
      }
    }
  }
};
const DistLut kDistLut;

inline int dist_sym(int d) {
  if (d <= 256) return kDistLut.small[d];
  int s = kDistLut.big[(d - 1) >> 8];
  while (kDistBase[s] > d) --s;  // bucket straddles at most two symbols
  return s;
}

struct BitWriter {
  uint8_t* dst;
  long long cap;
  long long pos = 0;
  uint64_t buf = 0;
  int nbits = 0;
  bool fail = false;

  inline void put(uint32_t bits, int n) {  // n <= 32, LSB-first
    buf |= (uint64_t)bits << nbits;
    nbits += n;
    if (nbits >= 32) {
      if (pos + 4 > cap) {
        fail = true;
        nbits &= 31;
        buf >>= 32;
        return;
      }
      uint32_t w = (uint32_t)buf;
      __builtin_memcpy(dst + pos, &w, 4);
      pos += 4;
      buf >>= 32;
      nbits -= 32;
    }
  }
  inline void align_byte() {
    int pad = (8 - (nbits & 7)) & 7;
    if (pad) put(0, pad);
    while (nbits >= 8) {
      if (pos >= cap) {
        fail = true;
        return;
      }
      dst[pos++] = (uint8_t)buf;
      buf >>= 8;
      nbits -= 8;
    }
  }
};

// Length-limited canonical Huffman code lengths from freq[]; returns the
// number of used symbols.  Optimal Huffman depths via the sorted
// two-queue construction, then limit enforcement on the bit-length
// counts (zlib gen_bitlen-style): each move turns a leaf at the deepest
// depth < limit into an internal node adopting one symbol parked at the
// limit, lowering the Kraft sum by exactly one 2^-limit unit — the
// result is EXACTLY complete.
static int build_lengths(const uint32_t* freq, int n, int limit,
                         uint8_t* lens) {
  struct Node {
    uint64_t f;
    int sym;
  };
  std::vector<Node> heap;
  heap.reserve(n);
  for (int i = 0; i < n; ++i) {
    lens[i] = 0;
    if (freq[i]) heap.push_back({freq[i], i});
  }
  int used = (int)heap.size();
  if (used == 0) return 0;
  if (used == 1) {
    lens[heap[0].sym] = 1;
    return 1;
  }
  // shell sort ascending by freq (n <= 286)
  for (int gap = used / 2; gap > 0; gap /= 2)
    for (int i = gap; i < used; ++i) {
      Node t = heap[i];
      int j = i;
      for (; j >= gap && heap[j - gap].f > t.f; j -= gap)
        heap[j] = heap[j - gap];
      heap[j] = t;
    }
  // two-queue Huffman; child c: >= 0 leaf index, < 0 internal ~c
  int m = used;
  std::vector<uint64_t> intf(m);
  std::vector<int> pa(m), pb(m);
  int li = 0, ii = 0, nint = 0;
  auto take = [&](uint64_t* f, int* c) {
    if (li < m && (ii >= nint || heap[li].f <= intf[ii])) {
      *f = heap[li].f;
      *c = li;
      ++li;
    } else {
      *f = intf[ii];
      *c = ~ii;
      ++ii;
    }
  };
  while ((m - li) + (nint - ii) >= 2) {
    uint64_t f1, f2;
    int c1, c2;
    take(&f1, &c1);
    take(&f2, &c2);
    pa[nint] = c1;
    pb[nint] = c2;
    intf[nint++] = f1 + f2;
  }
  std::vector<uint8_t> idepth(nint);
  std::vector<uint8_t> sdepth(used);
  idepth[nint - 1] = 0;
  for (int i = nint - 1; i >= 0; --i) {
    uint8_t cd = (uint8_t)(idepth[i] + 1);
    if (pa[i] >= 0) sdepth[pa[i]] = cd; else idepth[~pa[i]] = cd;
    if (pb[i] >= 0) sdepth[pb[i]] = cd; else idepth[~pb[i]] = cd;
  }
  int count[16] = {0};
  for (int i = 0; i < used; ++i)
    count[sdepth[i] > limit ? limit : sdepth[i]]++;
  long long D = -(1ll << limit);
  for (int l = 1; l <= limit; ++l) D += (long long)count[l] << (limit - l);
  while (D > 0) {
    int bits = limit - 1;
    while (bits > 0 && count[bits] == 0) --bits;
    if (bits == 0 || count[limit] == 0) break;  // unreachable: n <= 2^limit
    count[bits]--;
    count[bits + 1] += 2;
    count[limit]--;
    --D;
  }
  // heap is freq-ascending: walk it backwards so the most frequent
  // symbols get the shortest lengths
  int idx = used - 1;
  for (int l = 1; l <= limit; ++l)
    for (int c = 0; c < count[l]; ++c) lens[heap[idx--].sym] = (uint8_t)l;
  return used;
}

// canonical codes (bit-reversed for the LSB-first stream) from lengths
static void enc_build_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int count[16] = {0};
  for (int i = 0; i < n; ++i) count[lens[i]]++;
  count[0] = 0;
  uint32_t next[16] = {0}, code = 0;
  for (int l = 1; l <= 15; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i) {
    int l = lens[i];
    if (!l) {
      codes[i] = 0;
      continue;
    }
    uint32_t c = next[l]++;
    uint32_t rev = 0;
    for (int k = 0; k < l; ++k) rev |= ((c >> k) & 1u) << (l - 1 - k);
    codes[i] = (uint16_t)rev;
  }
}

// token: literal = byte value; match = (1u<<31) | (len << 16) | dist
struct BlockCtx {
  std::vector<uint32_t> tokens;
  uint32_t lfreq[286];
  uint32_t dfreq[30];
  void reset() {
    tokens.clear();
    std::memset(lfreq, 0, sizeof(lfreq));
    std::memset(dfreq, 0, sizeof(dfreq));
  }
};

struct FixedCodes {
  uint8_t llen[288];
  uint16_t lcode[288];
  uint8_t dlen[30];
  uint16_t dcode[30];
  FixedCodes() {
    for (int i = 0; i < 288; ++i)
      llen[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    enc_build_codes(llen, 288, lcode);
    for (int i = 0; i < 30; ++i) dlen[i] = 5;
    enc_build_codes(dlen, 30, dcode);
  }
};
const FixedCodes kFixed;

static uint64_t body_cost(const BlockCtx& b, const uint8_t* llen,
                          const uint8_t* dlen) {
  uint64_t bits = 0;
  for (int s = 0; s < 286; ++s)
    if (b.lfreq[s])
      bits += (uint64_t)(llen[s] + (s >= 257 ? kLenExtra[s - 257] : 0)) *
              b.lfreq[s];
  for (int s = 0; s < 30; ++s)
    if (b.dfreq[s]) bits += (uint64_t)(dlen[s] + kDistExtra[s]) * b.dfreq[s];
  return bits;
}

// RFC 1951 3.2.7 run-length coding of the code-length sequence
struct ClStream {
  uint8_t syms[286 + 30];
  uint8_t extra[286 + 30];
  int n = 0;
  uint32_t freq[19];
  void build(const uint8_t* lens, int total) {
    std::memset(freq, 0, sizeof(freq));
    n = 0;
    int i = 0;
    while (i < total) {
      uint8_t v = lens[i];
      int run = 1;
      while (i + run < total && lens[i + run] == v) ++run;
      if (v == 0) {
        while (run >= 11) {
          int r = run > 138 ? 138 : run;
          syms[n] = 18;
          extra[n++] = (uint8_t)(r - 11);
          freq[18]++;
          run -= r;
          i += r;
        }
        while (run >= 3) {
          int r = run > 10 ? 10 : run;
          syms[n] = 17;
          extra[n++] = (uint8_t)(r - 3);
          freq[17]++;
          run -= r;
          i += r;
        }
        while (run > 0) {
          syms[n] = 0;
          extra[n++] = 0;
          freq[0]++;
          --run;
          ++i;
        }
      } else {
        syms[n] = v;
        extra[n++] = 0;
        freq[v]++;
        --run;
        ++i;
        while (run >= 3) {
          int r = run > 6 ? 6 : run;
          syms[n] = 16;
          extra[n++] = (uint8_t)(r - 3);
          freq[16]++;
          run -= r;
          i += r;
        }
        while (run > 0) {
          syms[n] = v;
          extra[n++] = 0;
          freq[v]++;
          --run;
          ++i;
        }
      }
    }
  }
};

// emit one block, choosing the cheapest of stored/static/dynamic
static void emit_block(BitWriter& bw, BlockCtx& b, const uint8_t* raw,
                       long long raw_len, bool final_block) {
  uint8_t llen[286], dlen[30];
  uint16_t lcode[286], dcode[30];
  b.lfreq[256]++;  // EOB
  build_lengths(b.lfreq, 286, 15, llen);
  int dused = build_lengths(b.dfreq, 30, 15, dlen);
  if (dused == 0) dlen[0] = 1;  // HDIST >= 1: 1-bit dummy, never emitted
  int nlit = 286;
  while (nlit > 257 && llen[nlit - 1] == 0) --nlit;
  int ndist = 30;
  while (ndist > 1 && dlen[ndist - 1] == 0) --ndist;
  uint8_t all[286 + 30];
  std::memcpy(all, llen, nlit);
  std::memcpy(all + nlit, dlen, ndist);
  ClStream cl;
  cl.build(all, nlit + ndist);
  uint8_t cl_len[19];
  uint16_t cl_code[19];
  build_lengths(cl.freq, 19, 7, cl_len);
  enc_build_codes(cl_len, 19, cl_code);
  int ncl = 19;
  while (ncl > 4 && cl_len[kCLPerm[ncl - 1]] == 0) --ncl;
  uint64_t hdr_bits = 5 + 5 + 4 + 3ull * ncl;
  for (int i = 0; i < cl.n; ++i) {
    int s = cl.syms[i];
    hdr_bits += cl_len[s] + (s == 16 ? 2 : s == 17 ? 3 : s == 18 ? 7 : 0);
  }
  enc_build_codes(llen, nlit, lcode);
  enc_build_codes(dlen, ndist, dcode);
  uint64_t dyn_bits = 3 + hdr_bits + body_cost(b, llen, dlen);
  uint64_t fix_bits = 3 + body_cost(b, kFixed.llen, kFixed.dlen);
  uint64_t sto_bits =
      (uint64_t)(raw_len / 65535 + 1) * 40 + 8 * (uint64_t)raw_len + 3;
  b.lfreq[256]--;

  if (sto_bits < dyn_bits && sto_bits < fix_bits) {
    long long off = 0;
    do {  // stored chunks (<= 65535 each); only the last carries bfinal
      long long chunk = raw_len - off > 65535 ? 65535 : raw_len - off;
      bw.put((final_block && off + chunk == raw_len) ? 1 : 0, 1);
      bw.put(0, 2);
      bw.align_byte();
      if (bw.fail || bw.pos + 4 + chunk > bw.cap) {
        bw.fail = true;
        return;
      }
      uint16_t len16 = (uint16_t)chunk;
      uint16_t nlen = (uint16_t)~len16;
      std::memcpy(bw.dst + bw.pos, &len16, 2);
      std::memcpy(bw.dst + bw.pos + 2, &nlen, 2);
      std::memcpy(bw.dst + bw.pos + 4, raw + off, (size_t)chunk);
      bw.pos += 4 + chunk;
      off += chunk;
    } while (off < raw_len);
    return;
  }

  const uint8_t *Ll, *Dl;
  const uint16_t *Lc, *Dc;
  bw.put(final_block ? 1 : 0, 1);
  if (fix_bits <= dyn_bits) {
    bw.put(1, 2);
    Ll = kFixed.llen;
    Lc = kFixed.lcode;
    Dl = kFixed.dlen;
    Dc = kFixed.dcode;
  } else {
    bw.put(2, 2);
    bw.put((uint32_t)(nlit - 257), 5);
    bw.put((uint32_t)(ndist - 1), 5);
    bw.put((uint32_t)(ncl - 4), 4);
    for (int i = 0; i < ncl; ++i) bw.put(cl_len[kCLPerm[i]], 3);
    for (int i = 0; i < cl.n; ++i) {
      int s = cl.syms[i];
      bw.put(cl_code[s], cl_len[s]);
      if (s == 16)
        bw.put(cl.extra[i], 2);
      else if (s == 17)
        bw.put(cl.extra[i], 3);
      else if (s == 18)
        bw.put(cl.extra[i], 7);
    }
    Ll = llen;
    Lc = lcode;
    Dl = dlen;
    Dc = dcode;
  }
  for (uint32_t t : b.tokens) {
    if (!(t & 0x80000000u)) {
      bw.put(Lc[t], Ll[t]);
    } else {
      int len = (int)((t >> 16) & 0x1ff);
      int d = (int)(t & 0xffff);
      int ls = kLenLut.sym[len];
      bw.put(Lc[257 + ls], Ll[257 + ls]);
      if (kLenExtra[ls]) bw.put((uint32_t)(len - kLenBase[ls]), kLenExtra[ls]);
      int ds = dist_sym(d);
      bw.put(Dc[ds], Dl[ds]);
      if (kDistExtra[ds])
        bw.put((uint32_t)(d - kDistBase[ds]), kDistExtra[ds]);
    }
    if (bw.fail) return;
  }
  bw.put(Lc[256], Ll[256]);  // EOB
}

constexpr long long kEncBlockIn = 128ll << 10;  // input bytes per block
constexpr int kEncHashBits = 15;

}  // namespace

// Compress n bytes into a zlib stream (RFC 1950).  Returns the
// compressed size, or -1 when dst_cap is insufficient (callers size
// dst >= n + n/64 + 1024; stored blocks bound the true worst case at
// n + 5*ceil(n/65535) + 15 or so).
// Chain-search DEFLATE encoder (zlib deflate_slow shape): head + prev
// hash chains over the 32K window, lazy one-step match deferral, and
// the good/lazy/nice/chain heuristics.  Same token/block emitter as the
// greedy encoder.  Slower than the greedy path but reaches zlib-6-class
// ratios on smooth/low-entropy planes where greedy single-probe leaves
// 15-20% on the table; callers pick it for levels >= 4 (see
// unmicst_tpu/io/tiff.py::_encode_deflate).
extern "C" long long unmicst_deflate_chain(const uint8_t* src, long long n,
                                           uint8_t* dst, long long dst_cap,
                                           long long max_chain,
                                           long long nice_len,
                                           long long good_len,
                                           long long max_lazy) {
  if (n < 0 || dst_cap < 16) return -1;
  dst[0] = 0x78;
  dst[1] = 0x9c;
  BitWriter bw{dst + 2, dst_cap - 2 - 4};

  std::vector<int64_t> head((size_t)1 << kEncHashBits);
  for (auto& h : head) h = -(1ll << 40);
  std::vector<int64_t> prevtab((size_t)32768, -(1ll << 40));
  BlockCtx blk;
  blk.reset();

  auto hash4 = [&](long long j) -> uint32_t {
    uint32_t v;
    __builtin_memcpy(&v, src + j, 4);
    return (v * 0x9E3779B1u) >> (32 - kEncHashBits);
  };
  // chain walk FIRST, insert after: position j's slot (j & 32767) aliases
  // j - 32768, whose link must stay readable while j's chain is walked
  auto insert = [&](long long j) {
    uint32_t h = hash4(j);
    prevtab[j & 32767] = head[h];
    head[h] = j;
  };
  auto longest_at = [&](long long j, long long chain, int* out_dist) -> int {
    long long max_len = n - j;
    if (max_len > 258) max_len = 258;
    if (max_len < 4) return 0;
    long long limit = j - 32768;
    long long cand = head[hash4(j)];
    uint32_t here;
    __builtin_memcpy(&here, src + j, 4);
    int best = 0;
    long long bestpos = -1;
    for (long long c = 0; c < chain && cand >= 0 && cand >= limit; ++c) {
      // a longer match must extend the current best AND share the start
      if (best == 0 || src[cand + best] == src[j + best]) {
        uint32_t there;
        __builtin_memcpy(&there, src + cand, 4);
        if (there == here) {
          int len = 4;
          while (len < max_len && src[cand + len] == src[j + len]) ++len;
          if (len > best) {
            best = len;
            bestpos = cand;
            if (len >= nice_len || len >= max_len) break;
          }
        }
      }
      cand = prevtab[cand & 32767];
    }
    *out_dist = (int)(j - bestpos);
    return best;
  };

  long long i = 0, block_start = 0;
  const long long last_hashable = n - 4;
  int prev_len = 0, prev_dist = 0;
  bool have_lit = false;  // pending token decision at position i-1
  while (i < n) {
    if (prev_len < 4 && i - block_start >= kEncBlockIn + 1) {
      // safe flush point: the only pending state is a plain literal
      if (have_lit) {
        blk.tokens.push_back(src[i - 1]);
        blk.lfreq[src[i - 1]]++;
        have_lit = false;
        prev_len = 0;
      }
      emit_block(bw, blk, src + block_start, i - block_start, false);
      if (bw.fail) return -1;
      blk.reset();
      block_start = i;
    }
    int len = 0, dist = 0;
    if (i <= last_hashable) {
      if (prev_len < max_lazy) {
        long long chain = prev_len >= good_len ? max_chain >> 2 : max_chain;
        len = longest_at(i, chain, &dist);
      }
      insert(i);
    }
    if (prev_len >= 4 && len <= prev_len) {
      // the match starting at i-1 wins over anything at i
      blk.tokens.push_back(0x80000000u | ((uint32_t)prev_len << 16) |
                           (uint32_t)prev_dist);
      blk.lfreq[257 + kLenLut.sym[prev_len]]++;
      blk.dfreq[dist_sym(prev_dist)]++;
      long long end = i - 1 + prev_len;  // first position after the match
      for (long long j = i + 1; j < end && j <= last_hashable; ++j)
        insert(j);
      i = end;
      prev_len = 0;
      have_lit = false;
    } else {
      if (have_lit) {
        blk.tokens.push_back(src[i - 1]);
        blk.lfreq[src[i - 1]]++;
      }
      prev_len = len;
      prev_dist = dist;
      have_lit = true;
      ++i;
    }
  }
  if (have_lit) {
    blk.tokens.push_back(src[n - 1]);
    blk.lfreq[src[n - 1]]++;
  }
  emit_block(bw, blk, src + block_start, i - block_start, true);
  bw.align_byte();
  if (bw.fail) return -1;
  long long out = 2 + bw.pos;
  if (out + 4 > dst_cap) return -1;
  uint32_t ad = adler32(src, n);
  dst[out] = (uint8_t)(ad >> 24);
  dst[out + 1] = (uint8_t)(ad >> 16);
  dst[out + 2] = (uint8_t)(ad >> 8);
  dst[out + 3] = (uint8_t)ad;
  return out + 4;
}

extern "C" long long unmicst_deflate(const uint8_t* src, long long n,
                                     uint8_t* dst, long long dst_cap) {
  if (n < 0 || dst_cap < 16) return -1;
  dst[0] = 0x78;  // CM=8, CINFO=7
  dst[1] = 0x9c;  // FLEVEL default, FCHECK makes the header % 31 == 0
  BitWriter bw{dst + 2, dst_cap - 2 - 4};

  std::vector<int64_t> head((size_t)1 << kEncHashBits);
  for (auto& h : head) h = -(1ll << 40);
  BlockCtx blk;
  blk.reset();

  auto hash4 = [&](long long i) -> uint32_t {
    uint32_t v;
    __builtin_memcpy(&v, src + i, 4);
    return (v * 0x9E3779B1u) >> (32 - kEncHashBits);
  };

  long long i = 0, block_start = 0;
  const long long last_hashable = n - 4;
  while (i < n) {
    if (i - block_start >= kEncBlockIn) {
      emit_block(bw, blk, src + block_start, i - block_start, false);
      if (bw.fail) return -1;
      blk.reset();
      block_start = i;
    }
    if (i > last_hashable) {
      blk.tokens.push_back(src[i]);
      blk.lfreq[src[i]]++;
      ++i;
      continue;
    }
    uint32_t h = hash4(i);
    long long cand = head[h];
    head[h] = i;
    long long d = i - cand;
    uint32_t here;
    __builtin_memcpy(&here, src + i, 4);
    uint32_t there = 0;
    if (d <= 32768 && cand >= 0) __builtin_memcpy(&there, src + cand, 4);
    if (d <= 32768 && cand >= 0 && here == there) {
      long long max_len = n - i > 258 ? 258 : n - i;
      long long len = 4;
      while (len < max_len && src[cand + len] == src[i + len]) ++len;
      blk.tokens.push_back(0x80000000u | ((uint32_t)len << 16) | (uint32_t)d);
      blk.lfreq[257 + kLenLut.sym[len]]++;
      blk.dfreq[dist_sym((int)d)]++;
      long long end = i + len;
      // sparse insert: the match's end positions keep future runs
      // findable at O(1) per match
      if (end - 2 > i && end - 2 <= last_hashable)
        head[hash4(end - 2)] = end - 2;
      if (end - 1 > i && end - 1 <= last_hashable)
        head[hash4(end - 1)] = end - 1;
      i = end;
    } else {
      blk.tokens.push_back(src[i]);
      blk.lfreq[src[i]]++;
      ++i;
    }
  }
  emit_block(bw, blk, src + block_start, i - block_start, true);
  bw.align_byte();
  if (bw.fail) return -1;
  long long out = 2 + bw.pos;
  if (out + 4 > dst_cap) return -1;
  uint32_t ad = adler32(src, n);
  dst[out] = (uint8_t)(ad >> 24);
  dst[out + 1] = (uint8_t)(ad >> 16);
  dst[out + 2] = (uint8_t)(ad >> 8);
  dst[out + 3] = (uint8_t)ad;
  return out + 4;
}
