// K3/K4a/K4b: the one-hop ring shift of the halo runtime's seam buffers.
//
// Replaces the TPU kernels of unmicst_tpu/kernels/halo_rdma.py: ring_shift
// (_shift_kernel), ring_shift_start (_start_kernel) and ring_shift_wait
// (_wait_kernel).  There, each chip issued a remote DMA into its neighbour's
// landing buffer after a barrier-semaphore handshake, and waited on DMA
// semaphores.  Here all ranks live in one process (several ranks may share
// one card), so the hop is two kernels:
//
//  * ring_store: ONE launch per source card (and store stream) and hop.  Its
//    argument is a table of segments, one per source rank on that card:
//    (source buffer, landing buffer on the same card or on a peer card,
//    completion word).  Every segment has the same byte count (a ring has
//    one shape and dtype) and gets `blocks` blocks; block b copies chunk
//    b % blocks of segment b / blocks, so no block straddles two segments.
//    The copy moves the widest unit (16, 8, 4, 2 or 1 bytes) that the
//    segment's source and landing addresses share, after a head of at most
//    15 bytes that brings both to that boundary: a view 4 bytes off
//    alignment copies by words, an aligned buffer by 16-byte vectors, four
//    in flight per thread.  Each block then adds 1 to its segment's word
//    with one release-add: gpu scope where the landing buffer is on the
//    source's card, system scope only where it is on a peer card.  A
//    segment whose destination reads the landing buffer on the store's own
//    stream has no word: stream order already publishes it.
//  * ring_wait: one warp on a destination stream; lane k acquires word k
//    until it reaches its target (the word's count of blocks after this
//    hop), backing off with __nanosleep.  The spin is bounded by the global
//    timer: past the limit it traps, so a hang becomes a launch error
//    instead of a stuck process.
//
// A word is never reset: counts only grow (the comparison is the signed
// 32-bit difference, so it survives the wrap at 2^32), and each word is
// written by one source on one stream, so no reset can race a hop and one
// hop kind never releases another's wait (the counterpart of JAX's
// separate collective_ids).
//
// Bound: device memory (each buffer read once, written once).  At the
// halo's sizes (a few MB per hop) the fixed costs dominate, so the design
// cuts them: one launch per card instead of one per rank, no ticket, no
// system fence on one card, and no wait kernel where stream order suffices.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors in flight per thread
constexpr int kMaxSegments = 32;
constexpr int kMaxWaits = 32;  // one lane each
constexpr unsigned kMaxSleepNs = 256;

// the launch tables: global, since the C entry points take them
struct Segment {
  const unsigned char* src;
  unsigned char* dst;
  unsigned* word;  // null: no completion signal
  int sys;         // the landing buffer is on a peer card
  int pad;
};

struct StoreArgs {
  Segment seg[kMaxSegments];
  long long nbytes;  // per segment
  int nseg;
  int blocks;  // per segment
};

struct WaitEntry {
  const unsigned* word;
  unsigned target;
  int sys;  // the word's source is on a peer card
};

struct WaitArgs {
  WaitEntry entry[kMaxWaits];
  int n;
  int pad;
  unsigned long long timeout_ns;
};

namespace {

__device__ __forceinline__ void add_release(unsigned* p, int sys) {
  if (sys)
    asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(p)
                 : "memory");
  else
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p)
                 : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p, int sys) {
  unsigned v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// units [lo, hi) of s into d, kUnroll loads in flight per thread, each
// warp on consecutive units
template <typename T>
__device__ __forceinline__ void copy_units(const T* __restrict__ s,
                                           T* __restrict__ d, long long lo,
                                           long long hi) {
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = s[i + k * kThreads];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) d[i + k * kThreads] = v[k];
  }
  for (; i < hi; i += kThreads) d[i] = s[i];
}

// chunk `chunk` of `chunks` of one segment, in units of T; src and dst
// agree modulo sizeof(T)
template <typename T>
__device__ __forceinline__ void copy_chunk(const unsigned char* src,
                                           unsigned char* dst, long long nbytes,
                                           int chunk, int chunks) {
  constexpr int W = sizeof(T);
  long long head = (W - (long long)((uintptr_t)dst % W)) % W;
  if (head > nbytes) head = nbytes;
  const long long n = (nbytes - head) / W;
  if (chunk == 0) {  // the ragged bytes at both ends
    for (long long t = threadIdx.x; t < head; t += kThreads) dst[t] = src[t];
    for (long long t = head + n * W + threadIdx.x; t < nbytes; t += kThreads)
      dst[t] = src[t];
  }
  // chunk starts on 128-byte steps of the unit grid
  constexpr long long kStep = 128 / W;
  const long long per = ((n + chunks - 1) / chunks + kStep - 1) / kStep * kStep;
  const long long lo = min(n, (long long)chunk * per);
  const long long hi = min(n, lo + per);
  copy_units(reinterpret_cast<const T*>(src + head),
             reinterpret_cast<T*>(dst + head), lo, hi);
}

__global__ void __launch_bounds__(kThreads)
    ring_store_kernel(const __grid_constant__ StoreArgs a) {
  const int s = blockIdx.x / a.blocks;
  const int chunk = blockIdx.x - s * a.blocks;
  const Segment& g = a.seg[s];
  const unsigned rel = (unsigned)(((uintptr_t)g.src ^ (uintptr_t)g.dst) & 15);
  if (rel == 0)
    copy_chunk<int4>(g.src, g.dst, a.nbytes, chunk, a.blocks);
  else if ((rel & 7) == 0)
    copy_chunk<uint2>(g.src, g.dst, a.nbytes, chunk, a.blocks);
  else if ((rel & 3) == 0)
    copy_chunk<unsigned>(g.src, g.dst, a.nbytes, chunk, a.blocks);
  else if ((rel & 1) == 0)
    copy_chunk<unsigned short>(g.src, g.dst, a.nbytes, chunk, a.blocks);
  else
    copy_chunk<unsigned char>(g.src, g.dst, a.nbytes, chunk, a.blocks);
  if (g.word == nullptr) return;
  // the barrier orders every thread's stores before thread 0's release,
  // and release is cumulative: the add publishes the whole block's chunk
  __syncthreads();
  if (threadIdx.x == 0) add_release(g.word, g.sys);
}

__global__ void ring_wait_kernel(const __grid_constant__ WaitArgs a) {
  if ((int)threadIdx.x >= a.n) return;
  const WaitEntry& e = a.entry[threadIdx.x];
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while ((int)(load_acquire(e.word, e.sys) - e.target) < 0) {
    if (global_ns() - t0 > a.timeout_ns) __trap();
    __nanosleep(sleep_ns);
    if (sleep_ns < kMaxSleepNs) sleep_ns <<= 1;
  }
}

struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};

}  // namespace

// One store launch on `stream` (on `device`): every segment of `a`.
extern "C" int ring_store(const StoreArgs* a, int device, void* stream) {
  if (!a || a->nseg < 1 || a->nseg > kMaxSegments || a->blocks < 1 ||
      a->nbytes < 0)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a->nseg; ++s)
    if (a->nbytes && (!a->seg[s].src || !a->seg[s].dst))
      return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  ring_store_kernel<<<(unsigned)(a->nseg * a->blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// One wait launch on `stream` (on `device`): block it until every word of
// `a` reaches its target; trap after a->timeout_ns nanoseconds.
extern "C" int ring_wait(const WaitArgs* a, int device, void* stream) {
  if (!a || a->n < 1 || a->n > kMaxWaits) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a->n; ++k)
    if (!a->entry[k].word) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  ring_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// Let kernels on `device` store into `peer`'s memory.
extern "C" int ring_enable_peer(int device, int peer) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not a fault: clear the recorded error
    e = cudaSuccess;
  }
  return (int)e;
}
