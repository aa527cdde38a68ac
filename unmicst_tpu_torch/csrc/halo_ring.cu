// K3/K4a/K4b: the one-hop ring shift of the halo runtime's seam buffers.
//
// Replaces the TPU kernels of unmicst_tpu/kernels/halo_rdma.py: ring_shift
// (_shift_kernel), ring_shift_start (_start_kernel) and ring_shift_wait
// (_wait_kernel).  There, each chip issued a remote DMA into its neighbour's
// landing buffer after a barrier-semaphore handshake, and waited on DMA
// semaphores.  Here several ranks may share one card, and a ring may span
// processes, so the hop is two kernels:
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
//    source's card, system scope where it is on a peer card or in another
//    process.  A segment whose destination reads the landing buffer on the
//    store's own stream has no word: stream order already publishes it.
//  * ring_wait_kernel: one warp on a destination stream; lane k acquires
//    word k until it reaches its target (the word's count of blocks after
//    this hop), backing off with __nanosleep.  The spin is bounded by the
//    global timer: past the limit it traps, so a hang becomes a launch error
//    instead of a stuck process.  ring_wait_all issues a hop's whole table
//    of such warps, one per destination card, in one call: the host side
//    prepares the table when the hop starts (words, targets, each card's
//    stream), and the call switches the current device only for a card
//    that is not already current.
//
// Across processes (a ring whose ranks live in several processes, on one
// card or several), the landing slot and the words of each (hop kind,
// destination rank) come from one cudaMalloc per process and card
// (ring_ipc_alloc), exported with cudaIpcGetMemHandle and opened by the
// other processes (ring_ipc_open).  Stream order cannot keep a store out
// of a slot its reader still reads there, so the slot has a credit word
// beside its completion word, JAX's barrier semaphore: the destination
// copies the slot out (a ring_store launch whose blocks each add 1 to the
// credit word, released at system scope), and ring_store_credit, the store
// into that slot, acquires the credit word until it reaches the count of
// those blocks after the previous hop, with the waits' timeout and trap.
// Every word whose two ranks are in different processes is released and
// acquired at system scope, even on one card.
//
// A word is never reset: counts only grow (the comparison is the signed
// 32-bit difference, so it survives the wrap at 2^32), and each word is
// written by one hop at a time, so no reset can race a hop and one hop
// kind never releases another's wait (the counterpart of JAX's separate
// collective_ids).
//
// Bound: device memory (each buffer read once, written once).  At the
// halo's sizes (a few MB per hop) the fixed costs dominate, so the design
// cuts them: one launch per card instead of one per rank, no ticket, no
// system fence on one card, and no wait kernel where stream order suffices.
// Without MPS the kernels of two processes on one card time-slice: a
// spinning wait holds its slice until the scheduler switches, so a hop
// across processes on one card takes milliseconds.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device_scope.cuh"

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

// the credit words of a ring_store_credit launch: word[s] (null: none) is
// acquired until it reaches target[s] before segment s is written
struct CreditArgs {
  const unsigned* word[kMaxSegments];
  unsigned target[kMaxSegments];
  unsigned long long timeout_ns;
};

// one destination card's wait warp: its words and the stream it blocks
struct WaitLaunch {
  WaitArgs args;
  void* stream;
  int device;
  int pad;
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

// spin until *p reaches target (signed difference), trapping after
// timeout_ns
__device__ __forceinline__ void acquire_until(const unsigned* p, int sys,
                                              unsigned target,
                                              unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while ((int)(load_acquire(p, sys) - target) < 0) {
    if (global_ns() - t0 > timeout_ns) __trap();
    __nanosleep(sleep_ns);
    if (sleep_ns < kMaxSleepNs) sleep_ns <<= 1;
  }
}

__device__ __forceinline__ void store_segment(const StoreArgs& a, int s,
                                              int chunk) {
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

__global__ void __launch_bounds__(kThreads)
    ring_store_kernel(const __grid_constant__ StoreArgs a) {
  const int s = blockIdx.x / a.blocks;
  store_segment(a, s, blockIdx.x - s * a.blocks);
}

// ring_store_kernel behind each segment's credit word: thread 0 acquires
// it (system scope: its releaser is another process), the barrier holds
// the block's stores behind that acquire
__global__ void __launch_bounds__(kThreads)
    ring_store_credit_kernel(const __grid_constant__ StoreArgs a,
                             const __grid_constant__ CreditArgs c) {
  const int s = blockIdx.x / a.blocks;
  if (c.word[s] != nullptr) {
    if (threadIdx.x == 0)
      acquire_until(c.word[s], 1, c.target[s], c.timeout_ns);
    __syncthreads();
  }
  store_segment(a, s, blockIdx.x - s * a.blocks);
}

__global__ void ring_wait_kernel(const __grid_constant__ WaitArgs a) {
  if ((int)threadIdx.x >= a.n) return;
  const WaitEntry& e = a.entry[threadIdx.x];
  acquire_until(e.word, e.sys, e.target, a.timeout_ns);
}

}  // namespace

static int check_store(const StoreArgs* a) {
  if (!a || a->nseg < 1 || a->nseg > kMaxSegments || a->blocks < 1 ||
      a->nbytes < 0)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a->nseg; ++s)
    if (a->nbytes && (!a->seg[s].src || !a->seg[s].dst))
      return (int)cudaErrorInvalidValue;
  return 0;
}

// One store launch on `stream` (on `device`): every segment of `a`.
extern "C" int ring_store(const StoreArgs* a, int device, void* stream) {
  if (int rc = check_store(a)) return rc;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  ring_store_kernel<<<(unsigned)(a->nseg * a->blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// The same, each segment behind its credit word in `c`.
extern "C" int ring_store_credit(const StoreArgs* a, const CreditArgs* c,
                                 int device, void* stream) {
  if (int rc = check_store(a)) return rc;
  if (!c) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  ring_store_credit_kernel<<<(unsigned)(a->nseg * a->blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a, *c);
  return (int)cudaGetLastError();
}

// The n wait launches of `w`, each on its own card's stream: block it until
// every word of its table reaches its target; trap after timeout_ns.  The
// current device changes only for a launch on another card, and is restored.
extern "C" int ring_wait_all(const WaitLaunch* w, int n) {
  if (!w || n < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const WaitArgs& a = w[i].args;
    if (a.n < 1 || a.n > kMaxWaits) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < a.n; ++k)
      if (!a.entry[k].word) return (int)cudaErrorInvalidValue;
  }
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  int cur = prev;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    if (w[i].device != cur) {
      err = cudaSetDevice(w[i].device);
      if (err != cudaSuccess) break;
      cur = w[i].device;
    }
    ring_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(w[i].stream)>>>(
        w[i].args);
    err = cudaGetLastError();
  }
  if (prev >= 0 && cur != prev) cudaSetDevice(prev);
  return (int)err;
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

// A ring's shared allocation on `device`: `bytes` zeroed (every word at 0,
// finished before the handle leaves this process) and its IPC handle
// (cudaIpcMemHandle_t, 64 bytes) written to `handle`.
extern "C" int ring_ipc_alloc(long long bytes, int device, void** ptr,
                              void* handle) {
  if (!ptr || !handle || bytes < 1) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)e;
}

// Another process's allocation, opened in this one (kernels on `device`
// and its peers may store into it).
extern "C" int ring_ipc_open(const void* handle, int device, void** ptr) {
  if (!ptr || !handle) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ring_ipc_close(void* ptr, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int ring_ipc_free(void* ptr, int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaFree(ptr);
}
