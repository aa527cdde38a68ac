// K2: overlap-add of window-weighted tiles, in gather form.
//
// Replaces the TPU kernel exhibits/pallas/blend.py::blend_fold_pallas
// (_blend_kernel), which walked the tiles in order on the sequential TPU grid
// and read-modify-wrote each tile's window of the canvas.  On the GPU the
// blocks run in no order, so the sum is turned around: one thread owns one
// output pixel and reads the <= 2 x 2 tiles that cover it (the tiler
// guarantees sub >= 2*margin, so a pixel row lies in at most two tile rows,
// and likewise for columns).  No atomics, a deterministic result, and no
// alignment limit on the stride (the limit that kept the Pallas kernel off
// the TPU).  Tiles are addressed through element strides, so the kernel reads
// the [npr, npc, P, P, K] layout of the Pallas contract and K1's
// [T, K, P, P] output alike, without a copy.
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
// Bound: device memory.  Every tile element is read once and every output
// written once, with a few adds per element.  Neighbouring threads own
// neighbouring output columns and so read neighbouring tile addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Tiles {
  const float* base;
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

__device__ __forceinline__ float tile_at(const Tiles& t, int i, int j, int k,
                                         int y, int x) {
  return t.base[i * t.si + j * t.sj + k * t.sk + y * t.sy + x * t.sx];
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

__global__ void fold_weighted(Tiles t, const float* __restrict__ window,
                              float* __restrict__ out, int K, int H2, int W2) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H2 || c >= W2) return;
  const Cover rc = cover(r, t.sub, t.npr, t.patch);
  const Cover cc = cover(c, t.sub, t.npc, t.patch);
  float* dst = out + ((long long)r * W2 + c) * K;
  for (int k = 0; k < K; ++k) {
    dst[k] = gather(rc, cc, [&](int i, int j, int y, int x) {
      return tile_at(t, i, j, k, y, x) * window[y * t.patch + x];
    });
  }
}

template <typename OutT>
__device__ __forceinline__ OutT store(float p);

template <>
__device__ __forceinline__ float store<float>(float p) { return p; }

template <>
__device__ __forceinline__ unsigned char store<unsigned char>(float p) {
  // uint8(255 * p), truncated toward zero like numpy/XLA's float->uint8
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

template <typename OutT, bool kRaw>
__global__ void fold_region(Tiles t, const float* __restrict__ window,
                            const int* __restrict__ classes, int n_cls,
                            Region g, OutT* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= g.H || w >= g.W) return;
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
    add = g.addend + ((long long)h * g.add_cols + c) * (n_cls + 1);
    count += add[n_cls];
  }
  const long long plane = (long long)g.H * g.W;
  const long long o = (long long)h * g.W + w;
  const int stride = n_cls + (window ? 1 : 0);
  for (int kc = 0; kc < n_cls; ++kc) {
    const int k = classes[kc];
    float v = gather(rc, cc, [&](int i, int j, int y, int x) {
      return tile_at(t, i, j, k, y, x);
    });
    if (add) v += add[kc];
    if constexpr (kRaw) {
      out[o * stride + kc] = v;
    } else {
      out[kc * plane + o] = store<OutT>(v / fmaxf(count, 1e-12f));
    }
  }
  if constexpr (kRaw) {
    if (window) out[o * stride + n_cls] = count;
  }
}

constexpr int kBx = 32, kBy = 8;

dim3 grid_for(int rows, int cols) {
  return dim3((cols + kBx - 1) / kBx, (rows + kBy - 1) / kBy);
}

Tiles make_tiles(const float* base, long long si, long long sj, long long sk,
                 long long sy, long long sx, int npr, int npc, int patch,
                 int sub) {
  Tiles t;
  t.base = base;
  t.si = si; t.sj = sj; t.sk = sk; t.sy = sy; t.sx = sx;
  t.npr = npr; t.npc = npc; t.patch = patch; t.sub = sub;
  return t;
}

bool bad_geometry(int npr, int npc, int patch, int sub) {
  return npr < 1 || npc < 1 || sub < 1 || patch <= sub || 2 * sub < patch;
}

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
  Tiles t = make_tiles(tiles, si, sj, sk, sy, sx, npr, npc, patch, sub);
  fold_weighted<<<grid_for(H2, W2), dim3(kBx, kBy), 0,
                  static_cast<cudaStream_t>(stream)>>>(t, window, out, K, H2,
                                                       W2);
  return (int)cudaGetLastError();
}

// (b) K1-weighted tiles (strided) -> the rectangle (r0, c0, H, W) of the
// tile canvas.  mode 0: float32 maps [n_cls, H, W]; 1: uint8(255 * p) maps;
// 2: raw float32 sums [H, W, n_cls (+1 count with a window)].  classes:
// device int32 [n_cls].  window may be null only in mode 2.
extern "C" int blend_fold_region(const float* tiles, long long si,
                                 long long sj, long long sk, long long sy,
                                 long long sx, const float* window,
                                 const int* classes, int n_cls,
                                 const float* rmask, const float* cmask,
                                 const float* addend, int add_cols, int r0,
                                 int c0, int H, int W, void* out, int mode,
                                 int npr, int npc, int patch, int sub,
                                 void* stream) {
  if (bad_geometry(npr, npc, patch, sub) || n_cls < 1 || H < 1 || W < 1 ||
      r0 < 0 || c0 < 0 || r0 + H > npr * sub + (patch - sub) ||
      c0 + W > npc * sub + (patch - sub) || mode < 0 || mode > 2 ||
      (mode != 2 && !window) || (addend && add_cols < 1))
    return (int)cudaErrorInvalidValue;
  Tiles t = make_tiles(tiles, si, sj, sk, sy, sx, npr, npc, patch, sub);
  Region g;
  g.rmask = rmask; g.cmask = cmask; g.addend = addend;
  g.add_cols = addend ? add_cols : 0;
  g.r0 = r0; g.c0 = c0; g.H = H; g.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(H, W), block(kBx, kBy);
  if (mode == 1) {
    fold_region<unsigned char, false><<<grid, block, 0, s>>>(
        t, window, classes, n_cls, g, static_cast<unsigned char*>(out));
  } else if (mode == 0) {
    fold_region<float, false><<<grid, block, 0, s>>>(
        t, window, classes, n_cls, g, static_cast<float*>(out));
  } else {
    fold_region<float, true><<<grid, block, 0, s>>>(
        t, window, classes, n_cls, g, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
