// GIF's LZW, for unmicst_tpu_torch/io/gif.py: the decode of one frame as
// Pillow's GifDecode.c runs it under ImageFile.load, and the encode of
// Pillow's GifEncode.c.  gif.py's lzw_decode_py and lzw_encode_py are the
// same algorithms in Python: the two give the same pixels and bytes, and
// fail on the same inputs.
//
// GIF's variant of LZW: codes are packed LSB first, a frame names its
// minimum code size (bits), the clear code is 1 << bits and the end code
// the next, codes are bits + 1 wide after each clear and one wider once
// the code 2**width - 1 is in the table (no early change), and the table
// stops growing at 4096 entries.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <cstdint>
#include <cstring>

namespace {

const int kTable = 4096;
enum {
  kBroken = -2,      // a code not yet defined (Pillow: "decoding error")
  kConfig = -8,      // a minimum code size above 12
  kTruncated = -20,  // the file ends before the frame's last pixel
};

}  // namespace

extern "C" {

// Decode the frame whose data sub-blocks start at src[pos] (src is the
// whole file, len bytes) into out: ysize rows of xsize bytes, stride bytes
// apart, skipping pixels equal to transparency (-1: none).  interlace
// selects the four-pass row order.  chunk is what PIL's ImageFile reads at
// a time: a sub-block is read only once whole in what has been read, and
// an end code before the last pixel is passed over while the file holds
// more.  Returns 0 once the last pixel is written, else a negative k*.
long long unmicst_gif_lzw_decode(const uint8_t* src, long long len,
                                 long long pos, int bits, uint8_t* out,
                                 long long stride, long long xsize,
                                 long long ysize, int interlace,
                                 int transparency, long long chunk) {
  if (bits > 12 || bits < 0) return kConfig;
  static thread_local uint16_t link[kTable];
  static thread_local uint8_t suffix[kTable];
  uint8_t stack[kTable + 1];
  const int clear = 1 << bits, end = clear + 1;
  long long step = interlace ? 8 : 1;
  int ipass = interlace ? 1 : 0;
  long long x = 0, y = 0;
  uint8_t* row = out;
  long long loaded = pos + chunk < len ? pos + chunk : len;
  long long ptr = pos;
  int blocksize = 0;
  uint32_t bitbuf = 0;
  int bitcount = 0;
  int state = 1, nxt = 0, codesize = 0, codemask = 0;
  int lastcode = 0, lastdata = 0;
  for (;;) {
    if (state == 1) {
      nxt = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuf |= (uint32_t)src[ptr++] << bitcount;
        --blocksize;
        bitcount += 8;
        continue;
      }
      while (ptr >= loaded || ptr + 1 + src[ptr] > loaded) {
        if (loaded >= len) return kTruncated;
        loaded = loaded + chunk < len ? loaded + chunk : len;
      }
      blocksize = src[ptr++];
    }
    int c = (int)(bitbuf & (uint32_t)codemask);
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {
      if (loaded >= len) return kTruncated;
      loaded = loaded + chunk < len ? loaded + chunk : len;
      continue;
    }
    int n;  // the string's bytes, first at stack[top]
    int top = kTable;
    if (state == 2) {
      if (c > clear) return kBroken;
      lastdata = lastcode = c;
      state = 3;
      stack[--top] = (uint8_t)c;
    } else {
      const int thiscode = c;
      if (c > nxt) return kBroken;
      if (c == nxt) {
        stack[--top] = (uint8_t)lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (c >= kTable) return kBroken;
        stack[--top] = suffix[c];
        c = link[c];
      }
      lastdata = c;
      if (nxt < kTable) {
        suffix[nxt] = (uint8_t)c;
        link[nxt] = (uint16_t)lastcode;
        if (nxt == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++nxt;
      }
      lastcode = thiscode;
      stack[--top] = (uint8_t)c;
    }
    n = kTable - top;
    for (int i = 0; i < n; ++i) {
      const uint8_t v = stack[top + i];
      if (v != transparency) row[x] = v;
      if (++x >= xsize) {
        x = 0;
        y += step;
        while (y >= ysize) {
          if (ipass == 1) {
            y = 4;
            ipass = 2;
          } else if (ipass == 2) {
            step = 4;
            y = 2;
            ipass = 3;
          } else if (ipass == 3) {
            step = 2;
            y = 1;
            ipass = 0;
          } else {
            return 0;
          }
        }
        row = out + y * stride;
      }
    }
  }
}

// Pillow's encoder over n pixels at src: a clear code, greedy longest
// matches looked up in its hash table, a clear in place of the 4097th
// entry, the last match and the end code, packed LSB first into dst.
// Returns the bytes written, or -1 when cap is too small.
long long unmicst_gif_lzw_encode(const uint8_t* src, long long n, int bits,
                                 uint8_t* dst, long long cap) {
  const int kHash = 8192;  // TABLE_SIZE, a power of two
  static thread_local uint32_t codes[kHash];
  const uint32_t clear = 1u << bits, end = clear + 1;
  uint32_t nxt = 0, maxcode = 0, width = 0;
  long long o = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool full = false;
  auto reset = [&]() {
    nxt = end + 1;
    maxcode = 2 * clear - 1;
    width = bits + 1;
    std::memset(codes, 0, sizeof(codes));
  };
  auto put = [&](uint32_t code) {
    acc |= (uint64_t)code << nacc;
    nacc += (int)width;
    while (nacc >= 8) {
      if (o >= cap) {
        full = true;
        return;
      }
      dst[o++] = (uint8_t)acc;
      acc >>= 8;
      nacc -= 8;
    }
  };
  reset();
  put(clear);
  if (n > 0) {
    uint32_t head = src[0];
    for (long long i = 1; i < n && !full; ++i) {
      const uint32_t tail = src[i];
      const uint32_t key = (head << 8) | tail;
      int probe = (int)(((head ^ (tail << 6)) * 31) & (kHash - 1));
      bool found = false;
      while (codes[probe]) {
        if ((codes[probe] & 0xFFFFF) == key) {
          head = codes[probe] >> 20;
          found = true;
          break;
        }
        probe -= (int)((tail << 2) | 1);
        if (probe < 0) probe += kHash;
      }
      if (found) continue;
      put(head);
      if (nxt < (uint32_t)kTable) {
        codes[probe] = (nxt << 20) | key;
        if (nxt > maxcode) {
          maxcode = maxcode * 2 + 1;
          ++width;
        }
        ++nxt;
      } else {
        put(clear);
        reset();
      }
      head = tail;
    }
    put(head);
  }
  put(end);
  if (nacc > 0) {
    if (o >= cap) full = true;
    else dst[o++] = (uint8_t)acc;
  }
  return full ? -1 : o;
}

}  // extern "C"
