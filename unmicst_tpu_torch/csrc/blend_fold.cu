// K2: overlap-add of window-weighted tiles, in gather form.
//
// Replaces the TPU kernel exhibits/pallas/blend.py::blend_fold_pallas
// (_blend_kernel), which walked the tiles in order on the sequential TPU grid
// and read-modify-wrote each tile's window of the canvas.  On the GPU the
// blocks run in no order, so the sum is turned around: each output pixel
// reads the <= 2 x 2 tiles that cover it (the tiler guarantees
// sub >= 2*margin, so a pixel row lies in at most two tile rows, and likewise
// for columns).  No atomics, a deterministic result, and no alignment limit
// on the stride (the limit that kept the Pallas kernel off the TPU).  Tiles
// are addressed through element strides, so the kernel reads the
// [npr, npc, P, P, K] layout of the Pallas contract and K1's [T, K, P, P]
// output alike, without a copy.
//
// Two entry points, one source:
//  (a) blend_fold_f32: out[r, c, k] = sum over covering tiles of
//      tile[k, y, x] * window[y, x] on the padded canvas [H', W', K]
//      (the Pallas contract, tiler.fold(tiles * window));
//  (b) blend_fold_region: the tail of every path that folds K1-weighted
//      tiles, over one rectangle [r0, r0 + H) x [c0, c0 + W) of the tile
//      canvas.  Tiles arrive already weighted by K1.  Per pixel it sums the
//      covering tiles of a class subset and, with a window, the blend count
//      (the window times optional per-tile-row and per-tile-column masks),
//      adds an optional addend (a neighbour's fold tail, for the first
//      add_cols canvas columns), and stores one of:
//        mode 0/1: p = sum / max(count, 1e-12) as float32 or as
//                  uint8(255 * p) truncated (the JAX `.astype(jnp.uint8)`),
//                  output [Kc, H, W];
//        mode 2:   the raw sums (and the count, with a window), output
//                  [H, W, Kc (+1)] float32 -- the fold without its epilogue.
//      The whole slide is the rectangle at (margin, margin) of size H x W
//      with no masks; a halo band is mode 2 over the padded band canvas;
//      a streamed stripe is its finished rows with its row mask.
// Sums pair up as the JAX fold's shifted adds do: (rows of the upper tile +
// rows of the lower tile) per tile column, then the two columns.
//
// Bound: device memory.  Every covering tile element is read once and every
// output byte written once, with a few adds per element; the window (64 KB,
// reused by every block) and the masks stay in the read-only cache, so the
// count costs no device-memory traffic.  The design of (b) keeps bytes in
// flight for HBM at any region origin and width.  Each thread owns one
// canvas-aligned quad, columns 4q .. 4q + 3 of one row (absolute canvas
// columns, q from c0 / 4 to (c0 + W - 1) / 4, one grid row a region row):
// with sub and patch multiples of 4 such a quad never straddles a tile
// column, so its four columns share their covering tiles at 16-byte aligned
// offsets.  The thread reads each covering tile row as one 16-byte vector
// through the read-only path without allocating in L1 (each tile element is
// read once), and issues every tile load of its quad, for all classes,
// before the first add (the tile pointer is __restrict__, so nothing orders
// the loads after a store).  Window, masks and addend are indexed by canvas
// column, and sums pair up as on the scalar lanes, so the two give the same
// bits.  The thread stores the quad's columns that lie in the region,
// canvas column c at output column c - c0: one uchar4 (uint8) or float4
// (float32) per class, or the quad's contiguous raw values as float4s, when
// all four do and the output address is aligned for it; else one element
// at a time (an origin off a multiple of 4, a ragged width, the region's
// first and last quads).  Stores realigned to the output inside the warp
// (__shfl_down_sync, 31 storing lanes a warp) and a one-dimensional grid
// over all the region's quads were timed against this and lost or tied
// (PERF.md): the uint8 maps are an eighth of the bytes.  The class
// subset travels in the kernel's arguments by value, so a launch needs no
// copy to the card and no synchronisation.  The wrapper's launch plan
// (kernels/blend_fold.py fold_launch) takes the vector path where the tile
// layout allows it (unit x stride, the other strides, sub and patch
// multiples of 4, 16-byte aligned tiles and window), whatever the region's
// origin and width; other layouts (such as the [npr, npc, P, P, K] view, x
// stride K) run the scalar lanes of the same kernel, one output column a
// thread with 4-byte loads through the strides.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

constexpr int kMaxClasses = 8;
constexpr int kVec = 4;  // canvas columns per thread on the vector path
constexpr int kBx = 32, kBy = 8;

// the class subset of a region launch, passed to the kernel by value
struct Classes {
  int n;
  int idx[kMaxClasses];
};

namespace {

struct Tiles {
  long long si, sj, sk, sy, sx;  // element strides of tile row, tile col, class, y, x
  int npr, npc, patch, sub;
};

// The <= 2 tiles covering canvas coordinate r along one axis: (hi, y_hi)
// always exists; lo = -1 when only one tile covers r.
struct Cover {
  int hi, y_hi, lo, y_lo;
};

__device__ __forceinline__ Cover cover(int r, int sub, int n, int patch) {
  Cover c;
  c.hi = min(r / sub, n - 1);
  c.y_hi = r - c.hi * sub;
  c.lo = c.hi - 1;
  c.y_lo = r - c.lo * sub;
  if (c.lo < 0 || c.y_lo >= patch) c.lo = -1;
  return c;
}

__device__ __forceinline__ float tile_at(const float* base, const Tiles& t,
                                         int i, int j, int k, int y, int x) {
  return base[i * t.si + j * t.sj + k * t.sk + y * t.sy + x * t.sx];
}

// Sum over the covering tiles of f(i, j, y, x), paired as the JAX fold.
template <typename F>
__device__ __forceinline__ float gather(const Cover& rc, const Cover& cc,
                                        F f) {
  float hi = f(rc.hi, cc.hi, rc.y_hi, cc.y_hi);
  if (rc.lo >= 0) hi += f(rc.lo, cc.hi, rc.y_lo, cc.y_hi);
  if (cc.lo < 0) return hi;
  float lo = f(rc.hi, cc.lo, rc.y_hi, cc.y_lo);
  if (rc.lo >= 0) lo += f(rc.lo, cc.lo, rc.y_lo, cc.y_lo);
  return hi + lo;
}

__global__ void fold_weighted(const float* __restrict__ tiles, Tiles t,
                              const float* __restrict__ window,
                              float* __restrict__ out, int K, int H2, int W2) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H2 || c >= W2) return;
  const Cover rc = cover(r, t.sub, t.npr, t.patch);
  const Cover cc = cover(c, t.sub, t.npc, t.patch);
  float* dst = out + ((long long)r * W2 + c) * K;
  for (int k = 0; k < K; ++k) {
    dst[k] = gather(rc, cc, [&](int i, int j, int y, int x) {
      return tile_at(tiles, t, i, j, k, y, x) * window[y * t.patch + x];
    });
  }
}

// uint8(255 * p), truncated toward zero like numpy/XLA's float->uint8
__device__ __forceinline__ unsigned char to_u8(float p) {
  float q = fminf(fmaxf(p * 255.0f, 0.0f), 255.0f);
  return (unsigned char)q;
}

// The rectangle of the tile canvas a region entry computes, its optional
// masks and addend.
struct Region {
  const float* rmask;   // [npr] per tile row, or null (all 1)
  const float* cmask;   // [npc] per tile column, or null (all 1)
  const float* addend;  // [H, add_cols, Kc + 1] by canvas column, or null
  int add_cols;
  int r0, c0, H, W;
};

enum Mode { kF32 = 0, kU8 = 1, kRaw = 2 };

// One output column w of row h, scalar loads through the strides: any
// layout, any alignment.
template <int NC>
__device__ __forceinline__ void fold_lane(const float* __restrict__ tiles,
                                          const Tiles& t,
                                          const float* __restrict__ window,
                                          const Classes& cls, const Region& g,
                                          void* __restrict__ out, int mode,
                                          int h, int w) {
  const int c = g.c0 + w;
  const Cover rc = cover(g.r0 + h, t.sub, t.npr, t.patch);
  const Cover cc = cover(c, t.sub, t.npc, t.patch);
  float count = 0.0f;
  if (window) {
    count = gather(rc, cc, [&](int i, int j, int y, int x) {
      float v = window[y * t.patch + x];
      if (g.rmask) v *= g.rmask[i];
      if (g.cmask) v *= g.cmask[j];
      return v;
    });
  }
  const float* add = nullptr;
  if (g.addend && c < g.add_cols) {
    add = g.addend + ((long long)h * g.add_cols + c) * (NC + 1);
    count += add[NC];
  }
  const long long plane = (long long)g.H * g.W;
  const long long o = (long long)h * g.W + w;
  const int stride = NC + (window ? 1 : 0);
#pragma unroll
  for (int kc = 0; kc < NC; ++kc) {
    const int k = cls.idx[kc];
    float v = gather(rc, cc, [&](int i, int j, int y, int x) {
      return tile_at(tiles, t, i, j, k, y, x);
    });
    if (add) v += add[kc];
    if (mode == kRaw) {
      static_cast<float*>(out)[o * stride + kc] = v;
    } else if (mode == kU8) {
      static_cast<unsigned char*>(out)[kc * plane + o] =
          to_u8(v / fmaxf(count, 1e-12f));
    } else {
      static_cast<float*>(out)[kc * plane + o] = v / fmaxf(count, 1e-12f);
    }
  }
  if (mode == kRaw && window) static_cast<float*>(out)[o * stride + NC] = count;
}

// 16 bytes through the read-only path, not allocated in L1 (read once)
__device__ __forceinline__ float4 ld_once(const float* p) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

// The four columns of one quad from its <= 4 covering tile rows (00 the
// (hi, hi) tile, 10 (lo, hi), 01 (hi, lo), 11 (lo, lo)), paired as gather.
__device__ __forceinline__ void pair_sum(const float4 (&a)[4], bool rl,
                                         bool cl, float* s) {
  const float* v00 = &a[0].x;
  const float* v10 = &a[1].x;
  const float* v01 = &a[2].x;
  const float* v11 = &a[3].x;
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    float hi = v00[u];
    if (rl) hi += v10[u];
    if (cl) {
      float lo = v01[u];
      if (rl) lo += v11[u];
      hi += lo;
    }
    s[u] = hi;
  }
}

// The quad's raw values, S per column (the NC sums, then the count when
// S > NC), for its columns u0 .. u1 - 1 in the region, output column o + u
// of the [H, W, S] output: the contiguous S float4s of a whole quad at an
// aligned address, else one value at a time.
template <int NC, int S>
__device__ __forceinline__ void store_raw(float* out, long long o,
                                          const float (&s)[NC][kVec],
                                          const float* cnt, int u0, int u1) {
  float flat[kVec * S];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) flat[u * S + kc] = s[kc][u];
    if constexpr (S > NC) flat[u * S + NC] = cnt[u];
  }
  if (u0 == 0 && u1 == kVec) {
    float* dst = out + o * S;
    if (((uintptr_t)dst & 15) == 0) {
#pragma unroll
      for (int q = 0; q < kVec * S; q += 4)
        *reinterpret_cast<float4*>(dst + q) =
            make_float4(flat[q], flat[q + 1], flat[q + 2], flat[q + 3]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < kVec * S; ++q)
    if (q / S >= u0 && q / S < u1) out[o * S + q] = flat[q];
}

// Canvas quad q (columns c = 4q .. 4q + 3) of row h on the vector path: the
// launch plan guarantees x stride 1, 16-byte aligned tile and window rows,
// and sub and patch multiples of 4, so the four columns share their
// covering tiles.  Those of its columns that lie in the region are stored,
// canvas column c + u at output column c + u - c0.
template <int NC>
__device__ __forceinline__ void fold_quad(const float* __restrict__ tiles,
                                          const Tiles& t,
                                          const float* __restrict__ window,
                                          const Classes& cls, const Region& g,
                                          void* __restrict__ out, int mode,
                                          int h, int q) {
  const int c = kVec * q;
  const Cover rc = cover(g.r0 + h, t.sub, t.npr, t.patch);
  const Cover cc = cover(c, t.sub, t.npc, t.patch);
  const bool rl = rc.lo >= 0, cl = cc.lo >= 0;
  const long long e00 = rc.hi * t.si + cc.hi * t.sj + rc.y_hi * t.sy + cc.y_hi;
  const long long e10 = rc.lo * t.si + cc.hi * t.sj + rc.y_lo * t.sy + cc.y_hi;
  const long long e01 = rc.hi * t.si + cc.lo * t.sj + rc.y_hi * t.sy + cc.y_lo;
  const long long e11 = rc.lo * t.si + cc.lo * t.sj + rc.y_lo * t.sy + cc.y_lo;
  float s[NC][kVec];
  // every tile load of the quad before the first add, four classes at a
  // time (one group on the main path: K <= 3)
#pragma unroll
  for (int g0 = 0; g0 < NC; g0 += 4) {
    float4 a[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g0 + q >= NC) break;
      const float* p = tiles + cls.idx[g0 + q] * t.sk;
      a[q][0] = ld_once(p + e00);
      if (rl) a[q][1] = ld_once(p + e10);
      if (cl) a[q][2] = ld_once(p + e01);
      if (rl && cl) a[q][3] = ld_once(p + e11);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (g0 + q >= NC) break;
      pair_sum(a[q], rl, cl, s[g0 + q]);
    }
  }
  float cnt[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (window) {
    const int P = t.patch;
    float4 a[4];
    a[0] = __ldg(reinterpret_cast<const float4*>(window + rc.y_hi * P + cc.y_hi));
    if (rl) a[1] = __ldg(reinterpret_cast<const float4*>(window + rc.y_lo * P + cc.y_hi));
    if (cl) a[2] = __ldg(reinterpret_cast<const float4*>(window + rc.y_hi * P + cc.y_lo));
    if (rl && cl)
      a[3] = __ldg(reinterpret_cast<const float4*>(window + rc.y_lo * P + cc.y_lo));
    // window * rmask[i] * cmask[j] per covering tile, in the lane's order
    const float rm[2] = {g.rmask ? __ldg(g.rmask + rc.hi) : 1.0f,
                         g.rmask && rl ? __ldg(g.rmask + rc.lo) : 1.0f};
    const float cm[2] = {g.cmask ? __ldg(g.cmask + cc.hi) : 1.0f,
                         g.cmask && cl ? __ldg(g.cmask + cc.lo) : 1.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* v = &a[q].x;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        if (g.rmask) v[u] *= rm[q & 1];
        if (g.cmask) v[u] *= cm[q >> 1];
      }
    }
    pair_sum(a, rl, cl, cnt);
  }
  if (g.addend && c < g.add_cols) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if (c + u >= g.add_cols) break;
      const float* add = g.addend + ((long long)h * g.add_cols + c + u) * (NC + 1);
      cnt[u] += add[NC];
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) s[kc][u] += add[kc];
    }
  }
  // the quad's columns in the region, u0 .. u1 - 1 (all four but at a row
  // end), and the output element of its column c in row h
  const int u0 = max(g.c0 - c, 0), u1 = min(g.c0 + g.W - c, kVec);
  const bool whole = u0 == 0 && u1 == kVec;
  const long long plane = (long long)g.H * g.W;
  const long long o = (long long)h * g.W + (c - g.c0);
  if (mode == kRaw) {
    float* dst = static_cast<float*>(out);
    if (window)
      store_raw<NC, NC + 1>(dst, o, s, cnt, u0, u1);
    else
      store_raw<NC, NC>(dst, o, s, cnt, u0, u1);
    return;
  }
#pragma unroll
  for (int kc = 0; kc < NC; ++kc) {
    float p[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) p[u] = s[kc][u] / fmaxf(cnt[u], 1e-12f);
    const long long e = kc * plane + o;
    if (mode == kU8) {
      unsigned char* dst = static_cast<unsigned char*>(out);
      const uchar4 b = make_uchar4(to_u8(p[0]), to_u8(p[1]), to_u8(p[2]),
                                   to_u8(p[3]));
      if (whole && ((uintptr_t)(dst + e) & 3) == 0) {
        *reinterpret_cast<uchar4*>(dst + e) = b;
      } else {
        const unsigned char v[kVec] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          if (u >= u0 && u < u1) dst[e + u] = v[u];
      }
    } else {
      float* dst = static_cast<float*>(out);
      if (whole && ((uintptr_t)(dst + e) & 15) == 0) {
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(p[0], p[1], p[2], p[3]);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          if (u >= u0 && u < u1) dst[e + u] = p[u];
      }
    }
  }
}

// cols == kVec: the vector path, thread x of a row the canvas quad
// c0 / 4 + x; cols == 1: the scalar lanes, thread x the output column x.
template <int NC>
__global__ void __launch_bounds__(kBx * kBy)
    fold_region(const float* __restrict__ tiles, Tiles t,
                const float* __restrict__ window, const Classes cls, Region g,
                void* __restrict__ out, int mode, int cols) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= g.H) return;
  if (cols == kVec) {
    const int q = g.c0 / kVec + x;
    if (kVec * q < g.c0 + g.W)
      fold_quad<NC>(tiles, t, window, cls, g, out, mode, h, q);
    return;
  }
  if (x < g.W) fold_lane<NC>(tiles, t, window, cls, g, out, mode, h, x);
}

template <int NC>
void launch_region(dim3 grid, cudaStream_t s, const float* tiles,
                   const Tiles& t, const float* window, const Classes& cls,
                   const Region& g, void* out, int mode, int cols) {
  fold_region<NC><<<grid, dim3(kBx, kBy), 0, s>>>(tiles, t, window, cls, g,
                                                  out, mode, cols);
}

Tiles make_tiles(long long si, long long sj, long long sk, long long sy,
                 long long sx, int npr, int npc, int patch, int sub) {
  Tiles t;
  t.si = si; t.sj = sj; t.sk = sk; t.sy = sy; t.sx = sx;
  t.npr = npr; t.npc = npc; t.patch = patch; t.sub = sub;
  return t;
}

bool bad_geometry(int npr, int npc, int patch, int sub) {
  return npr < 1 || npc < 1 || sub < 1 || patch <= sub || 2 * sub < patch;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// (a) tiles (strided) x window -> out [H', W', K] float32, with
// H' = npr*sub + (patch - sub), W' = npc*sub + (patch - sub).
extern "C" int blend_fold_f32(const float* tiles, long long si, long long sj,
                              long long sk, long long sy, long long sx,
                              const float* window, float* out, int npr,
                              int npc, int patch, int sub, int K,
                              void* stream) {
  if (bad_geometry(npr, npc, patch, sub) || K < 1) return (int)cudaErrorInvalidValue;
  const int H2 = npr * sub + (patch - sub), W2 = npc * sub + (patch - sub);
  Tiles t = make_tiles(si, sj, sk, sy, sx, npr, npc, patch, sub);
  fold_weighted<<<dim3((W2 + kBx - 1) / kBx, (H2 + kBy - 1) / kBy),
                  dim3(kBx, kBy), 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, t, window, out, K, H2, W2);
  return (int)cudaGetLastError();
}

// (b) K1-weighted tiles (strided) -> the rectangle (r0, c0, H, W) of the
// tile canvas.  mode 0: float32 maps [n, H, W]; 1: uint8(255 * p) maps;
// 2: raw float32 sums [H, W, n (+1 count with a window)], n the classes'
// count.  classes: a host table, copied into the launch's arguments.
// window may be null only in mode 2.  cols (kVec or 1) and the grid come
// from the wrapper's launch plan (its x covers the region's canvas quads on
// the vector path, its columns on the scalar lanes); the vector path's
// layout is checked here.
// The launch goes to `stream` on `device`.
extern "C" int blend_fold_region(const float* tiles, long long si,
                                 long long sj, long long sk, long long sy,
                                 long long sx, const float* window,
                                 const Classes* classes, const float* rmask,
                                 const float* cmask, const float* addend,
                                 int add_cols, int r0, int c0, int H, int W,
                                 void* out, int mode, int npr, int npc,
                                 int patch, int sub, int cols, int grid_x,
                                 int grid_y, int device, void* stream) {
  if (bad_geometry(npr, npc, patch, sub) || !classes || classes->n < 1 ||
      classes->n > kMaxClasses || H < 1 || W < 1 || r0 < 0 || c0 < 0 ||
      r0 + H > npr * sub + (patch - sub) ||
      c0 + W > npc * sub + (patch - sub) || mode < 0 || mode > 2 ||
      (mode != 2 && !window) || (addend && add_cols < 1))
    return (int)cudaErrorInvalidValue;
  if (cols != 1 && cols != kVec) return (int)cudaErrorInvalidValue;
  const int across = cols == 1 ? W : (c0 + W - 1) / kVec - c0 / kVec + 1;
  if (grid_x < 1 || grid_y < 1 || grid_y > 65535 ||
      (long long)grid_x * kBx < across || (long long)grid_y * kBy < H)
    return (int)cudaErrorInvalidConfiguration;
  if (cols == kVec &&
      (sx != 1 || si % kVec || sj % kVec || sk % kVec || sy % kVec ||
       sub % kVec || patch % kVec || !aligned16(tiles) ||
       (window && !aligned16(window))))
    return (int)cudaErrorMisalignedAddress;
  Tiles t = make_tiles(si, sj, sk, sy, sx, npr, npc, patch, sub);
  Region g;
  g.rmask = rmask; g.cmask = cmask; g.addend = addend;
  g.add_cols = addend ? add_cols : 0;
  g.r0 = r0; g.c0 = c0; g.H = H; g.W = W;
  const Classes cls = *classes;
  const dim3 grid(grid_x, grid_y);
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cls.n) {
    case 1: launch_region<1>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    case 2: launch_region<2>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    case 3: launch_region<3>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    case 4: launch_region<4>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    case 5: launch_region<5>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    case 6: launch_region<6>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    case 7: launch_region<7>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
    default: launch_region<8>(grid, s, tiles, t, window, cls, g, out, mode, cols); break;
  }
  return (int)cudaGetLastError();
}
