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
//  (b) blend_fold_epilogue: the main path's tail.  Tiles arrive already
//      weighted by K1; the kernel also sums the blend count from the window
//      over the real tiles, divides, crops the margin, keeps a class subset
//      and stores either float32 or uint8(255 * p) truncated, the JAX
//      `.astype(jnp.uint8)`.  Output [Kc, H, W].
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

template <typename OutT>
__global__ void fold_epilogue(Tiles t, const float* __restrict__ window,
                              const int* __restrict__ classes, int n_cls,
                              OutT* __restrict__ out, int margin, int H,
                              int W) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= H || w >= W) return;
  const Cover rc = cover(h + margin, t.sub, t.npr, t.patch);
  const Cover cc = cover(w + margin, t.sub, t.npc, t.patch);
  const float count = gather(rc, cc, [&](int, int, int y, int x) {
    return window[y * t.patch + x];
  });
  const long long plane = (long long)H * W;
  const long long o = (long long)h * W + w;
  for (int kc = 0; kc < n_cls; ++kc) {
    const int k = classes[kc];
    const float v = gather(rc, cc, [&](int i, int j, int y, int x) {
      return tile_at(t, i, j, k, y, x);
    });
    out[kc * plane + o] = store<OutT>(v / count);
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

// (b) K1-weighted tiles (strided) -> out [n_cls, H, W], float32 when
// out_u8 == 0, else uint8(255 * p).  classes: device int32 [n_cls].
extern "C" int blend_fold_epilogue(const float* tiles, long long si,
                                   long long sj, long long sk, long long sy,
                                   long long sx, const float* window,
                                   const int* classes, int n_cls, void* out,
                                   int out_u8, int npr, int npc, int patch,
                                   int sub, int H, int W, void* stream) {
  if (bad_geometry(npr, npc, patch, sub) || n_cls < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int margin = (patch - sub) / 2;
  Tiles t = make_tiles(tiles, si, sj, sk, sy, sx, npr, npc, patch, sub);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_u8) {
    fold_epilogue<unsigned char><<<grid_for(H, W), dim3(kBx, kBy), 0, s>>>(
        t, window, classes, n_cls, static_cast<unsigned char*>(out), margin,
        H, W);
  } else {
    fold_epilogue<float><<<grid_for(H, W), dim3(kBx, kBy), 0, s>>>(
        t, window, classes, n_cls, static_cast<float*>(out), margin, H, W);
  }
  return (int)cudaGetLastError();
}
