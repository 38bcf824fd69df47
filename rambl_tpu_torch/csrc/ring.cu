// K4: one hop of the ring rotation of the seed-index shards, for Hopper.
//
// Replaces rambl_tpu/parallel/ring_dma.py::_rot_kernel (wrapper
// ring_permute_dma): rank r's shard, a flat array of 32-bit words, lands in
// rank (r + 1) % n's receive buffer, bitwise ppermute(i -> i+1). The TPU
// kernel splits each array into `chunks` remote DMAs, each waited on by its
// own DMA semaphore; on the card a copy kernel's blocks already keep every
// slice of the array in flight at once, and nothing on the receiver can
// start before the whole array is there, so here each array is one launch
// with one signal:
//
//   ring_copy_kernel     1-D grid: each block copies its grid-stride share
//                        with 16-byte vector loads and stores (a scalar tail,
//                        and a scalar path where src or dst is not 16-byte
//                        aligned). With a flag (dma_barrier), the last block
//                        to finish (an arrival counter in the sender's
//                        memory, reset by that block) makes the array
//                        visible at system scope and release-stores the
//                        rotation's epoch into the receiver's flag. It never
//                        waits, so it always finishes. Without a flag (dma)
//                        it only copies: CUDA events order it (ring_dma.py).
//   ring_wait_kernel     one block on the receiver's stream: thread i spins
//                        on flag i with acquire loads until it reads >= the
//                        epoch. Work issued after it on that stream sees the
//                        shard.
//   ring_barrier_kernel  dma_barrier's entry barrier (_rot_kernel's
//                        barrier block): one thread release-stores the epoch
//                        into its left neighbour's "from right" slot and its
//                        right neighbour's "from left" slot (with n = 2 both
//                        land on the one neighbour: it still signals twice),
//                        then waits until both of its own slots read >= the
//                        epoch.
//
// Flags hold epochs, one per rotation and increasing, so they are never
// reset. Every spin is bounded: __nanosleep back-off up to 1 us, and a
// deadline on %globaltimer. On timeout a waiter sets the shared status word
// (first writer wins) and returns; every waiter returns at once once the
// status word is set, so a broken ring drains instead of hanging, and the
// wrapper raises when it reads the word. Loads and stores of flags are
// ld.acquire.sys / st.release.sys: a flag may live on a peer card.
//
// Bound: bytes. Each word is read once and written once: 2 x shard bytes
// over HBM (3.35 TB/s) when both ranks share a card, over NVLink (450 GB/s
// each way) when the neighbour is another card. The design keeps 16 bytes
// a thread in flight four times over (unrolled loads before stores) so a
// few blocks an SM saturate the memory system.
//
// C interface: every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.sys.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag >= epoch. False when the status word is set or the
// deadline passes (then `code` goes into the status word if it was 0).
__device__ bool wait_flag(const int* flag, int epoch, int* status, int code,
                          unsigned long long deadline) {
  unsigned ns = 32;
  while (load_acquire(flag) < epoch) {
    if (load_acquire(status) != 0) return false;
    if (global_ns() > deadline) {
      atomicCAS_system(status, 0, code);
      return false;
    }
    __nanosleep(ns);
    ns = ns < 1024 ? ns * 2 : 1024;
  }
  return true;
}

__global__ void __launch_bounds__(kCopyThreads)
ring_copy_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                 long long n, int epoch, int* __restrict__ flag,
                 int* __restrict__ arrive) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  long long done = 0;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const long long nv = n / 4;
    long long i = tid;
    for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = s4[i + u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d4[i + u * stride] = v[u];
    }
    for (; i < nv; i += stride) d4[i] = s4[i];
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = src[i];
  if (flag == nullptr) return;
  // every thread's stores are visible system-wide before the block arrives
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(arrive, 1) == (int)gridDim.x - 1) {
      *arrive = 0;  // the next launch on this stream starts from 0
      __threadfence_system();
      store_release(flag, epoch);
    }
  }
}

__global__ void ring_wait_kernel(const int* __restrict__ flags, int nflags,
                                 int epoch, long long timeout_ns,
                                 int* status) {
  const unsigned long long deadline = global_ns() + timeout_ns;
  for (int i = threadIdx.x; i < nflags; i += blockDim.x) {
    if (!wait_flag(flags + i, epoch, status, 2, deadline)) return;
  }
}

__global__ void ring_barrier_kernel(int* left_from_right, int* right_from_left,
                                    const int* own, int epoch,
                                    long long timeout_ns, int* status) {
  const unsigned long long deadline = global_ns() + timeout_ns;
  store_release(left_from_right, epoch);
  store_release(right_from_left, epoch);
  if (wait_flag(own, epoch, status, 1, deadline))
    wait_flag(own + 1, epoch, status, 1, deadline);
}

}  // namespace

extern "C" {

// `flag` (and `arrive`) null: copy only.
int rambl_ring_copy(const void* src, void* dst, long long words, int blocks,
                    int epoch, void* flag, void* arrive, void* stream) {
  if (blocks < 1 || (flag != nullptr && arrive == nullptr))
    return (int)cudaErrorInvalidValue;
  ring_copy_kernel<<<blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, words, epoch, (int*)flag,
      (int*)arrive);
  return (int)cudaGetLastError();
}

int rambl_ring_wait(const void* flags, int nflags, int epoch,
                    long long timeout_ns, void* status, void* stream) {
  ring_wait_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int*)flags, nflags, epoch, timeout_ns, (int*)status);
  return (int)cudaGetLastError();
}

int rambl_ring_barrier(void* left_from_right, void* right_from_left,
                       const void* own, int epoch, long long timeout_ns,
                       void* status, void* stream) {
  ring_barrier_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (int*)left_from_right, (int*)right_from_left, (const int*)own, epoch,
      timeout_ns, (int*)status);
  return (int)cudaGetLastError();
}

// Let `device` write to `peer`'s memory through peer pointers. Already
// enabled is not an error.
int rambl_ring_enable_peer(int device, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
