// K4: one hop of the ring rotation of the seed-index shards, for Hopper.
//
// Replaces rambl_tpu/parallel/ring_dma.py::_rot_kernel (wrapper
// ring_permute_dma): rank r's tuple of flat arrays of 32-bit words lands in
// rank (r + 1) % n's receive buffers, bitwise ppermute(i -> i+1). The TPU
// kernel splits each array into `chunks` remote DMAs, each waited on by its
// own DMA semaphore. Here a rank's whole tuple is ONE launch with one
// signal: nothing on the receiver can start before every array is there.
//
//   ring_copy_kernel     persistent blocks, one an SM. The tuple's 16-byte
//                        aligned words are cut into 64 KB tiles numbered
//                        through the arrays, and block b of G takes tiles
//                        b, b + G, b + 2 G, ... (the walk, below), so
//                        the grid sweeps the arrays together. One
//                        thread of the block moves its tiles through a ring
//                        of three in shared memory with 1-D bulk copies
//                        (TMA): a load reports to its stage's mbarrier, a
//                        bulk store drains the stage, and the stage is
//                        refilled when that store has read it. The other
//                        threads copy the scalar part: the last words % 4
//                        words of an array, and every word of an array
//                        whose src or dst is not 16-byte aligned. With a
//                        flag (dma_barrier), the last block to finish
//                        release-stores the rotation's epoch into the
//                        receiver's flag, after its bulk stores have
//                        completed (wait_group 0, not .read) and been
//                        fenced out of the async proxy. It never waits, so
//                        it always finishes. Without a flag (dma) it only
//                        copies: CUDA events order it (ring_dma.py).
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
// each way) when the neighbour is another card. Nothing is computed, so the
// design spends no registers or instructions on the data: an SM keeps
// 192 KB in flight through shared memory, and a rotation costs the host one
// launch a rank. Large tiles taken in a sweep measured fastest (PERF.md):
// at any time the grid reads one window of G x 64 KB and writes another,
// where blocks that each own a contiguous run keep G distant DRAM pages
// open in each direction. The copy pointers stay generic, so dst may be a
// peer card's memory.
//
// C interface: every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxArrays = 4;
constexpr int kCopyThreads = 128;
// The one design: a ring of three 64 KB tiles a block, one block an SM.
constexpr int kStages = 3;
constexpr int kTileBytes = 65536;
constexpr int kTileWords = kTileBytes / 4;
constexpr int kRingBytes = kStages * kTileBytes;

// One launch copies every array of a rank's tuple: src[a] -> dst[a],
// words[a] 32-bit words each. Passed to the kernel by value.
struct CopyTable {
  const int32_t* src[kMaxArrays];
  int32_t* dst[kMaxArrays];
  long long words[kMaxArrays];
  int n;
};

// The walk (parallel/ring_dma.py::copy_walk mirrors it, and the CPU tests
// check that it covers every word exactly once). An array whose src and dst
// are both 16-byte aligned has a bulk part, its first words & ~3 words, cut
// into tiles of kTileWords (the last tile of an array may be short, always a
// multiple of 4 words); tiles are numbered through the arrays in order, and
// block b of G takes tiles b, b + G, b + 2 G, ... of the T tiles: the grid
// sweeps the arrays together, so at any time its reads fall in one window
// of G tiles and its writes in another. What is left (the last words % 4
// words of an aligned array, every word of an unaligned one) is the scalar
// part: scalar thread `tid` of `stride` (a block's threads but its first
// are scalar threads) copies the words bulk + tid, bulk + tid + stride, ...
// of each array.
__device__ __forceinline__ long long bulk_words(const CopyTable& tb, int a) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(tb.src[a]) |
                         reinterpret_cast<uintptr_t>(tb.dst[a])) & 15) == 0;
  return aligned ? (tb.words[a] & ~3LL) : 0;
}

__device__ __forceinline__ long long tiles_of(long long bulk) {
  return (bulk + kTileWords - 1) / kTileWords;
}

__device__ __forceinline__ long long total_tiles(const CopyTable& tb) {
  long long t = 0;
  for (int a = 0; a < tb.n; ++a) t += tiles_of(bulk_words(tb, a));
  return t;
}

// Tile t of the walk: its array, first word and word count.
__device__ __forceinline__ void locate_tile(const CopyTable& tb, long long t,
                                            int* a_out, long long* first,
                                            int* nwords) {
  int a = 0;
  for (; a < tb.n - 1; ++a) {
    const long long na = tiles_of(bulk_words(tb, a));
    if (t < na) break;
    t -= na;
  }
  const long long off = t * kTileWords;
  const long long left = bulk_words(tb, a) - off;
  *a_out = a;
  *first = off;
  *nwords = (int)(left < kTileWords ? left : kTileWords);
}

__device__ __forceinline__ void copy_scalar_part(const CopyTable& tb,
                                                 long long tid,
                                                 long long stride) {
  for (int a = 0; a < tb.n; ++a) {
    const int32_t* __restrict__ s = tb.src[a];
    int32_t* __restrict__ d = tb.dst[a];
    for (long long i = bulk_words(tb, a) + tid; i < tb.words[a]; i += stride)
      d[i] = s[i];
  }
}

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

// The end of a dma_barrier copy. Every thread of the block calls it after
// its own stores (a thread that issued bulk stores has waited for them and
// fenced the async proxy first). The last block to arrive (a counter in the
// sender's memory, reset by that block) release-stores the rotation's epoch
// into the receiver's flag. It never waits, so the copy always finishes.
__device__ __forceinline__ void arrive_and_signal(int epoch, int* flag,
                                                  int* arrive) {
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

// ---- bulk copies (TMA, 1-D) and their barriers ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// expect_tx comes before the copy that completes it is issued
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier has left the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(smem)), "l"(__cvta_generic_to_global(gmem)),
         "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
      :: "l"(__cvta_generic_to_global(gmem)), "r"(smem_addr(smem)),
         "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most kPending of this thread's bulk groups still read shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kPending)
               : "memory");
}

// Every bulk store of this thread has been written, and the writes of the
// async proxy are ordered before what this thread does next.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async;" ::: "memory");
}

// The tile-ring copy of this block's tiles (blockIdx.x, blockIdx.x +
// gridDim.x, ... below the walk's total), by ONE thread: bulk loads fill a
// ring of kStages tiles in shared memory, each reported to its stage's
// mbarrier; as a stage completes, a bulk store drains it. Stage s is
// refilled once the store that last read it has finished reading
// (wait_group.read 1: all but the newest store). Stage k % kStages holds
// the block's k-th tile, so its barrier is in phase (k / kStages) & 1 while
// that tile loads. No byte passes through a register.
__device__ __forceinline__ void tile_ring_copy(const CopyTable& tb,
                                               unsigned char* ring,
                                               uint64_t* full) {
  const long long T = total_tiles(tb), b = blockIdx.x, G = gridDim.x;
  const long long n = T > b ? (T - b + G - 1) / G : 0;   // my tiles
  for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
  // the barriers' init is visible to the async proxy before any copy
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  auto load = [&](long long k) {
    int a, nw;
    long long first;
    locate_tile(tb, b + k * G, &a, &first, &nw);
    const int s = (int)(k % kStages);
    mbar_expect_tx(full + s, (uint32_t)nw * 4u);
    bulk_load(ring + (size_t)s * kTileBytes, tb.src[a] + first,
              (uint32_t)nw * 4u, full + s);
  };
  for (long long k = 0; k < n && k < kStages - 1; ++k) load(k);
  for (long long k = 0; k < n; ++k) {
    int a, nw;
    long long first;
    locate_tile(tb, b + k * G, &a, &first, &nw);
    const int s = (int)(k % kStages);
    mbar_wait(full + s, (uint32_t)((k / kStages) & 1));
    bulk_store(tb.dst[a] + first, ring + (size_t)s * kTileBytes,
               (uint32_t)nw * 4u);
    bulk_commit();
    if (k + kStages - 1 < n) {
      bulk_wait_read<1>();        // store k - 1 has let go of its stage
      load(k + kStages - 1);
    }
  }
  bulk_wait_all();
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
ring_copy_kernel(const CopyTable tb, int epoch, int* __restrict__ flag,
                 int* __restrict__ arrive) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x == 0) {
    tile_ring_copy(tb, ring, full);
  } else {
    // the block's other threads are the grid's scalar threads
    constexpr long long kScalar = kCopyThreads - 1;
    copy_scalar_part(tb, blockIdx.x * kScalar + threadIdx.x - 1,
                     gridDim.x * kScalar);
  }
  if (flag != nullptr) arrive_and_signal(epoch, flag, arrive);
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

// Copies src[a] -> dst[a], words[a] 32-bit words, for a < n_arrays (host
// arrays of device pointers and counts). `flag` (and `arrive`) null: copy
// only.
int rambl_ring_copy(const void* const* src, void* const* dst,
                    const long long* words, int n_arrays, int blocks,
                    int epoch, void* flag, void* arrive, void* stream) {
  if (blocks < 1 || n_arrays < 1 || n_arrays > kMaxArrays ||
      (flag != nullptr && arrive == nullptr))
    return (int)cudaErrorInvalidValue;
  CopyTable tb{};
  tb.n = n_arrays;
  for (int a = 0; a < n_arrays; ++a) {
    tb.src[a] = static_cast<const int32_t*>(src[a]);
    tb.dst[a] = static_cast<int32_t*>(dst[a]);
    tb.words[a] = words[a];
  }
  cudaError_t err = cudaFuncSetAttribute(
      ring_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (err != cudaSuccess) return (int)err;
  ring_copy_kernel<<<blocks, kCopyThreads, kRingBytes,
                     (cudaStream_t)stream>>>(tb, epoch, (int*)flag,
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

// The walk's constants, for the wrapper to hold its mirror of the walk
// (ring_dma.copy_walk) against: words of a bulk tile, scalar threads a
// block, most arrays a launch.
void rambl_ring_layout(int* tile_words, int* scalar_threads,
                       int* max_arrays) {
  *tile_words = kTileWords;
  *scalar_threads = kCopyThreads - 1;
  *max_arrays = kMaxArrays;
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
