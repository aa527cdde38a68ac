// K3/K4a/K4b: the one-hop ring shift of the halo runtime's seam buffers.
//
// Replaces the TPU kernels of unmicst_tpu/kernels/halo_rdma.py: ring_shift
// (_shift_kernel), ring_shift_start (_start_kernel) and ring_shift_wait
// (_wait_kernel).  There, each chip issued a remote DMA into its neighbour's
// landing buffer after a barrier-semaphore handshake, and waited on DMA
// semaphores.  Here all ranks live in one process (several ranks may share
// one card), so the hop is two kernels:
//
//  * ring_store: one launch per source rank, on that rank's stream.  It
//    copies the rank's seam buffer into the destination rank's landing
//    buffer (on the same card, or on a peer card through its device
//    pointer), 16 bytes per thread where both buffers are 16-byte aligned
//    and byte by byte otherwise.  Every block fences its stores at system
//    scope (once, by its first thread, after the block's barrier) and
//    takes a ticket; the last block to finish does one release store of
//    the hop's epoch into the destination's flag word.
//  * ring_wait: one thread on the destination rank's stream.  It spins on
//    acquire loads of its flag word until the flag reaches the epoch it
//    expects, backing off with __nanosleep.  The spin is bounded by the
//    global timer: past the limit it traps, so a hang becomes a launch
//    error instead of a stuck process.
//
// A flag word is never reset: epochs only grow, so a reset cannot race with
// the next hop's store.  Each (hop kind, destination, source) has its own
// word, written by one source on one stream, so its epochs arrive in order;
// one hop's signal never releases another hop's wait (the counterpart of
// JAX's separate collective_ids).
//
// Bound: device memory (the buffer is read once and written once); at the
// halo's sizes (a few MB per hop) the launches dominate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
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

__global__ void ring_store_kernel(const unsigned char* __restrict__ src,
                                  unsigned char* __restrict__ dst,
                                  long long nbytes, int vec,
                                  unsigned* __restrict__ tickets,
                                  unsigned* __restrict__ flag,
                                  unsigned epoch) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long tail = 0;
  if (vec) {
    const long long n16 = nbytes >> 4;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (long long i = tid; i < n16; i += step) d[i] = s[i];
    tail = n16 << 4;
  }
  for (long long i = tail + tid; i < nbytes; i += step) dst[i] = src[i];
  // the barrier orders the block's stores before its first thread's fence,
  // which publishes them at system scope (fences are cumulative)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    const unsigned ticket = atomicAdd(tickets, 1u);
    if (ticket == gridDim.x - 1) {
      // every block has fenced its stores: publish the hop
      *tickets = 0;  // the next launch on this stream starts after us
      __threadfence_system();
      store_release_sys(flag, epoch);
    }
  }
}

__global__ void ring_wait_kernel(const unsigned* __restrict__ flag,
                                 unsigned epoch,
                                 unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while ((int)(load_acquire_sys(flag) - epoch) < 0) {
    if (global_ns() - t0 > timeout_ns) __trap();
    __nanosleep(sleep_ns);
    if (sleep_ns < 2048) sleep_ns <<= 1;
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

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;

}  // namespace

// Copy nbytes from src (on `device`) into dst (on `device` or a peer), then
// release `epoch` into *flag.  tickets: a zeroed word on `device`, owned by
// this (source rank, hop kind).
extern "C" int ring_store(const void* src, void* dst, long long nbytes,
                          unsigned* tickets, unsigned* flag, unsigned epoch,
                          int device, void* stream) {
  if (nbytes < 0 || !tickets || !flag || (nbytes && (!src || !dst)))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int vec = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  const long long units = vec ? (nbytes >> 4) + (nbytes & 15) : nbytes;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ring_store_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      nbytes, vec, tickets, flag, epoch);
  return (int)cudaGetLastError();
}

// Block `stream` (on `device`) until *flag reaches `epoch`; trap after
// timeout_ns nanoseconds.
extern "C" int ring_wait(const unsigned* flag, unsigned epoch,
                         unsigned long long timeout_ns, int device,
                         void* stream) {
  if (!flag) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  ring_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      flag, epoch, timeout_ns);
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
