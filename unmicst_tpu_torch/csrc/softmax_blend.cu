// K1: softmax over classes x blend window x phantom-tile mask.
//
// Replaces the TPU kernel exhibits/pallas/fused_tail.py::softmax_blend_weights
// (_tail_kernel): out[t,k,y,x] = softmax_k(logits[t,:,y,x]) * (window[y,x] * mask[t])
// on [T, K, P, P] float32, class-leading -- the layout the NCHW UNet emits.
//
// Bound: device memory.  Each logit is read once and each result written once
// (2 * T*K*P*P*4 bytes; the P*P window and the T mask are small and stay in
// cache) against about ten flops per element, far below the card's
// operations-per-byte ratio.  Design: one thread owns four consecutive pixels
// of one tile and holds all K of their logits in registers (16-byte loads and
// stores, neighbouring threads on neighbouring addresses), so max, exp, sum,
// normalise and the two multiplies never go back to memory.  So P*P is a
// multiple of four and the pointers are 16-byte aligned (the wrapper checks
// both; every UNet tile side is a multiple of 2^n_layers), and K <= 3, the
// class count of every model.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxClasses = 3;
constexpr int kThreads = 256;

// softmax over K values, then * w: the arithmetic order of _tail_kernel
// (e = exp(x - max); p = e / sum(e); p * w).
template <int K>
__device__ __forceinline__ void softmax_weight(float (&x)[K], float w) {
  float m = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, x[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = expf(x[k] - m);
    s += x[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = x[k] / s * w;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
softmax_blend_vec4(const float4* __restrict__ logits,
                   const float4* __restrict__ window,
                   const float* __restrict__ mask, float4* __restrict__ out,
                   long long n_vec, int pp4) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  long long t = i / pp4;
  int p = (int)(i - t * pp4);
  long long base = t * K * pp4 + p;
  float4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = logits[base + (long long)k * pp4];
  const float4 win = window[p];
  const float mt = mask[t];
  const float w[4] = {win.x * mt, win.y * mt, win.z * mt, win.w * mt};
  float lane[4][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lane[0][k] = v[k].x;
    lane[1][k] = v[k].y;
    lane[2][k] = v[k].z;
    lane[3][k] = v[k].w;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) softmax_weight<K>(lane[c], w[c]);
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[base + (long long)k * pp4] =
        make_float4(lane[0][k], lane[1][k], lane[2][k], lane[3][k]);
}

template <int K>
void launch(const float* logits, const float* window, const float* mask,
            float* out, long long T, long long pp, cudaStream_t stream) {
  long long n_vec = T * pp / 4;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  softmax_blend_vec4<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(logits),
      reinterpret_cast<const float4*>(window), mask,
      reinterpret_cast<float4*>(out), n_vec, (int)(pp / 4));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// logits, out: [T, K, P, P] float32 contiguous, 16-byte aligned, P*P % 4 == 0;
// window: [P, P]; mask: [T]; 1 <= K <= 3.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int softmax_blend_f32(const float* logits, const float* window,
                                 const float* mask, float* out, long long T,
                                 int K, int P, void* stream) {
  if (T <= 0 || P <= 0 || K < 1 || K > kMaxClasses) return (int)cudaErrorInvalidValue;
  const long long pp = (long long)P * P;
  if (pp % 4 || !aligned16(logits) || !aligned16(window) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(logits, window, mask, out, T, pp, s); break;
    case 2: launch<2>(logits, window, mask, out, T, pp, s); break;
    case 3: launch<3>(logits, window, mask, out, T, pp, s); break;
  }
  return (int)cudaGetLastError();
}
