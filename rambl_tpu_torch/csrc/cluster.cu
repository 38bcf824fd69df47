// DP-means' center recount for Hopper (sm_90a): one launch an iteration of
// rambl_tpu_torch/pipeline/cluster.py::dp_means_leaves, bit-identical to its
// plain PyTorch version there, `recount_centers`.
//
//   dp_recount_kernel    replaces no Pallas kernel. The JAX package
//                        recounts with a one-hot jnp.einsum
//                        (rambl_tpu/pipeline/cluster.py:311-319), which XLA
//                        lowers on the TPU; the plain version scatters every
//                        (leaf, member, column) entry of a block with an
//                        int32 index_add_, each uncovered entry into one
//                        inert slot, so nearly all of its adds pile onto
//                        one address.
//
// Function. For leaf l, cluster k and column p, count[b] = the members m of
// l with assign[l][m] == k and feat[l][m][p] == b, b in 0..3 (-1, an
// uncovered entry, counts nowhere). The center is the first base of the
// largest count; fallback[l][p] where no member counts; 0 for every
// k >= kact[l].
//
// Bound: bytes. feat is read once (NL x M x P int8), assign once (NL x M
// int32), the centers written once (NL x K x P int8): 142 MB at a block of
// 512 leaves x 4,096 members x 64 columns, K 16, or 42 us at 3.35 TB/s. Only
// the covered entries take an add; at that block they are a few in ten
// thousand. The design:
//
// - A block a leaf. Its K x P x 4 int32 counts live in shared memory, laid
//   out [base][k][p] so that lanes adding to different columns of one base
//   hit different banks, zeroed at the start. No index is built in device
//   memory and no add leaves the SM.
// - The block streams its leaf's M x P bytes of feat as 16-byte loads, two
//   in flight a thread; the bytes before the first 16-byte boundary and
//   after the last are read one a thread. A chunk with no covered byte (all
//   0xFF) costs one test. A covered byte's member and column follow from
//   its offset in the leaf (one division a chunk), its cluster from assign.
// - Contention. In a dense leaf every member of a cluster adds to the same
//   word of a column. At P = 64 a warp's 32 chunks are 8 members x the same
//   4 runs of 16 columns, and lane t walks its chunk from byte
//   (t + t / 16) % 16: the 8 lanes on one run of columns start on 8
//   different columns, so no two lanes of a warp add to one word at once.
//   A fully covered leaf puts at most M adds on one word.
// - The epilogue. After a barrier, a thread per (k, p) reads its 4 counts,
//   takes the argmax with ties to the lowest base, or the fallback, or 0,
//   and writes the center's byte.
//
// Exact: the counts are integers, so the order of the atomics changes no bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 2;       // 16-byte loads in flight a thread

extern __shared__ int cnt[];    // [4][K][P]

struct Leaf {
  const int32_t* assign;    // the leaf's M clusters
  int K, P, KP;
};

// One entry of the leaf: base v of member m at column p.
__device__ __forceinline__ void add(const Leaf& f, int v, int m, int p) {
  if ((unsigned)v < 4u) {
    const int k = __ldg(f.assign + m);
    if ((unsigned)k < (unsigned)f.K)
      atomicAdd(&cnt[v * f.KP + k * f.P + p], 1);
  }
}

// The single byte at offset e of the leaf.
__device__ __forceinline__ void add_byte(const Leaf& f, const int8_t* leaf,
                                         int e) {
  const int v = leaf[e];
  if (v >= 0) add(f, v, e / f.P, e % f.P);
}

// The 16 bytes v at offset e0 of the leaf, walked from byte `rot`.
__device__ __forceinline__ void add_chunk(const Leaf& f, uint4 v, int e0,
                                          int rot) {
  if ((v.x & v.y & v.z & v.w) == 0xFFFFFFFFu) return;
  // rotate the 16 bytes right by rot: byte j of w is byte (j + rot) % 16 of v
  uint32_t w0 = v.x, w1 = v.y, w2 = v.z, w3 = v.w;
  if (rot & 8) {
    uint32_t t = w0; w0 = w2; w2 = t;
    t = w1; w1 = w3; w3 = t;
  }
  if (rot & 4) {
    const uint32_t t = w0;
    w0 = w1; w1 = w2; w2 = w3; w3 = t;
  }
  const int sh = (rot & 3) * 8;
  const uint32_t w[4] = {
      __funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
      __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w0, sh)};
  const int m0 = e0 / f.P;
  const int p0 = e0 - m0 * f.P;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int b = (int)(int8_t)(w[j >> 2] >> ((j & 3) * 8));
    if (b >= 0) {
      int m = m0, p = p0 + ((j + rot) & 15);
      while (p >= f.P) {
        p -= f.P;
        ++m;
      }
      add(f, b, m, p);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dp_recount_kernel(const int8_t* __restrict__ feat,
                  const int32_t* __restrict__ assign,
                  const int8_t* __restrict__ fallback,
                  const int32_t* __restrict__ kact,
                  int8_t* __restrict__ centers, int M, int P, int K) {
  const int l = blockIdx.x;
  const int t = threadIdx.x;
  const Leaf f{assign + (size_t)l * M, K, P, K * P};
  for (int i = t; i < 4 * f.KP; i += kThreads) cnt[i] = 0;
  __syncthreads();

  const int n = M * P;
  const int8_t* leaf = feat + (size_t)l * n;
  const int head = min(n, (int)((16 - ((uintptr_t)leaf & 15)) & 15));
  const int chunks = (n - head) / 16;
  const int tail = head + chunks * 16;
  if (t < head) add_byte(f, leaf, t);
  if (tail + t < n) add_byte(f, leaf, tail + t);
  const uint4* body = reinterpret_cast<const uint4*>(leaf + head);
  const int lane = t & 31;
  const int rot = (lane + (lane >> 4)) & 15;
  for (int c0 = t; c0 < chunks; c0 += kThreads * kLoads) {
    uint4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = c < chunks ? __ldg(body + c) : make_uint4(~0u, ~0u, ~0u, ~0u);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      add_chunk(f, v[u], head + (c0 + u * kThreads) * 16, rot);
  }
  __syncthreads();

  const int ka = kact[l];
  int8_t* out = centers + (size_t)l * f.KP;
  for (int i = t; i < f.KP; i += kThreads) {
    const int k = i / P;
    int8_t c = 0;
    if (k < ka) {
      const int c0 = cnt[i], c1 = cnt[f.KP + i], c2 = cnt[2 * f.KP + i],
                c3 = cnt[3 * f.KP + i];
      if ((c0 | c1 | c2 | c3) == 0) {
        c = fallback[(size_t)l * P + (i - k * P)];
      } else {
        int best = 0, top = c0;
        if (c1 > top) best = 1, top = c1;
        if (c2 > top) best = 2, top = c2;
        if (c3 > top) best = 3;
        c = (int8_t)best;
      }
    }
    out[i] = c;
  }
}

}  // namespace

extern "C" {

// feat (NL, M, P) int8, assign (NL, M) int32, fallback (NL, P) int8,
// kact (NL,) int32 -> centers (NL, K, P) int8. The wrapper checks the shapes,
// M x P < 2^31 and the shared memory, 16 x K x P bytes.
int rambl_dp_recount(const void* feat, const void* assign,
                     const void* fallback, const void* kact, void* centers,
                     int NL, int M, int P, int K, void* stream) {
  const size_t smem = (size_t)4 * K * P * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      dp_recount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dp_recount_kernel<<<NL, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(feat), static_cast<const int32_t*>(assign),
      static_cast<const int8_t*>(fallback), static_cast<const int32_t*>(kact),
      static_cast<int8_t*>(centers), M, P, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
