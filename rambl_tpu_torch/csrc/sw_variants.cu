// K1 variant sweep (S1) and K1 on pre-transposed inputs (S2) for Hopper
// (sm_90a): the kernels of the two bench scripts beside bench.py.
//
//   sw_variant_kernel<T, U, S>  replaces scripts/bench_sw_variants.py::
//                               make_score_fn(...).score (its Pallas
//                               `kernel`): K1's function, generated in
//                               variants; each is held against the oracle
//                               before it is timed.
//   sw_pretransposed_kernel     replaces scripts/ablate_prep.py::kernel_only
//                               (rambl_tpu/ops/sw_pallas.py::_score_kernel on
//                               inputs already cast to int32 and transposed):
//                               the raw packed best key.
//
// Both follow K1's design (sw.cu): one thread per pair sweeping window
// columns outer and query rows inner, with one column of packed (H, E) per
// thread in shared memory, laid out [row][thread].
//
// S1 knobs. The TPU script's preshift, phases and rowkey remove roll and
// select work of its anti-diagonal layout; the column sweep does none of that
// work, so they have no counterpart here. The knobs that mean something on
// this card:
//   T  threads per block, 64 / 128 / 256 (the TPU's `tile`, pairs per grid
//      step). Shared memory per block grows with T, so T = 256 runs one
//      block (8 warps) an SM at L = 128 and T = 64 several.
//   U  rows per unrolled inner-loop step, 4 or 8 (the TPU's `mid_unroll`).
//   S  stage the block's q tile in shared memory: loaded once with
//      coalesced 4-byte reads, instead of each thread's strided __ldg of its
//      own row (a warp's 32 loads touch 32 lines, sw.cu's K1).
// S1's contract differs from K1's wrapper: no `rows` truncation and any W
// (161 in the sweep), so w is read bytewise. Window codes >= 4 never match.
//
// S2. qT (L, B) and wT (>= W, B) are int32 and batch-minor, so a warp's
// loads of qT[i, b..b+31] and wT[j, b..b+31] are single 128-byte lines: the
// coalesced layout the ablation is about. The match test is qT == wT on the
// codes as given (the caller remaps N to a sentinel, as sw_score_pallas
// does). The result is the raw key that _score_kernel leaves in row 0 of its
// output tile: the maximum over every cell, zero cells included, of
// H * 32768 - (i * (W + 1) + j). Only rows 0..W-1 of wT are read.
//
// Bound. About 12 integer ops per cell, so both kernels are bound by integer
// issue: 131,072 x 128 x 161 cells at 132 SMs x 64 INT32 lanes and 1.98 GHz
// need >= 1.9 ms; their bytes (int8 or int32 in, int32 out) take
// microseconds. Neither design moves the DP state through device memory:
// per cell the only global load is one q code (S1 without staging, S2),
// which staging (S1) or the batch-minor layout (S2) makes coalesced.
//
// C interface: every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sw_common.cuh"

namespace {

constexpr int kNoMatch = 1 << 20;  // equals no int8 code
constexpr int kS2Threads = 128;

// One DP cell of the score-only column sweep (rows inner, columns outer):
// reads the packed (H, E) of (i, j - 1) from *col, writes that of (i, j)
// back, and advances the running H(i - 1, j - 1), H(i - 1, j) and
// F(i - 1, j) to row i. Returns H(i, j). K1 and K2 (sw.cu) keep their own
// inline copy of this recurrence, which must change with it: routed through
// a helper like this one, K2 got fewer registers from ptxas and ran slower.
__device__ __forceinline__ int sw_cell(uint32_t* col, bool match,
                                       const Scoring& sc, int& hdiag,
                                       int& hup, int& fup) {
  const uint32_t left = *col;
  const int hleft = unpack_h(left);
  const int e = max(hleft - sc.go_ge, unpack_e(left) - sc.ge);
  const int f = max(hup - sc.go_ge, fup - sc.ge);
  const int diag = hdiag + (match ? sc.match : sc.mismatch);
  const int h = max(max(diag, 0), max(e, f));
  *col = pack_he(h, e);
  hdiag = hleft;
  hup = h;
  fup = f;
  return h;
}

template <int kT, int kUnroll, bool kStageQ>
__global__ void __launch_bounds__(kT)
sw_variant_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                  int32_t* __restrict__ score, int32_t* __restrict__ i_end,
                  int32_t* __restrict__ j_end, int n, int L, int W,
                  Scoring sc) {
  extern __shared__ uint32_t smem[];
  uint32_t* col = smem;                           // (L + 1) x kT (H, E)
  uint32_t* qs = smem + (size_t)(L + 1) * kT;     // (L / 4) x (kT + 1) words
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kT;
  const int b = b0 + tid;
  const int L4 = L >> 2;
  if (kStageQ) {
    // The block's q rows are one contiguous run of words: thread t takes
    // words t, t + kT, ... and stores word r4 of pair p at
    // qs[r4 * (kT + 1) + p]; the +1 pad keeps both sides conflict-free.
    const uint32_t* tile =
        reinterpret_cast<const uint32_t*>(q + (size_t)b0 * L);
    const int words = min(kT, n - b0) * L4;
    for (int k = tid; k < words; k += kT) {
      const int p = k / L4;
      qs[(k - p * L4) * (kT + 1) + p] = __ldg(tile + k);
    }
    __syncthreads();
  }
  if (b >= n) return;  // no block-wide barrier below

  const uint32_t* qb = reinterpret_cast<const uint32_t*>(q + (size_t)b * L);
  const int8_t* wb = w + (size_t)b * W;
  for (int i = 0; i <= L; ++i) col[i * kT + tid] = pack_he(0, kEBorder);

  int best = kNone;
  for (int j = 1; j <= W; ++j) {
    const int wj = wb[j - 1];
    const int wm = wj < 4 ? wj : kNoMatch;
    int hdiag = 0;     // H(i - 1, j - 1); row 0 is the zero border
    int hup = 0;       // H(i - 1, j)
    int fup = sc.neg;  // F(i - 1, j); row 0 is neg_inf
#pragma unroll (kUnroll / 4)
    for (int i4 = 0; i4 < L4; ++i4) {
      const uint32_t q4 = kStageQ ? qs[i4 * (kT + 1) + tid] : __ldg(qb + i4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * i4 + u + 1;
        const int qi = static_cast<int8_t>((q4 >> (8 * u)) & 0xFFu);
        const int h = sw_cell(col + i * kT + tid, qi == wm, sc, hdiag, hup,
                              fup);
        if (h > 0) best = max(best, h * kTie - (i * (W + 1) + j));
      }
    }
  }
  decode_best(best, W, b, score, i_end, j_end);
}

__global__ void __launch_bounds__(kS2Threads)
sw_pretransposed_kernel(const int32_t* __restrict__ qT,
                        const int32_t* __restrict__ wT,
                        int32_t* __restrict__ key, int n, int L, int W,
                        Scoring sc) {
  extern __shared__ uint32_t col[];  // (L + 1) x kS2Threads packed (H, E)
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kS2Threads + tid;
  if (b >= n) return;
  for (int i = 0; i <= L; ++i) col[i * kS2Threads + tid] = pack_he(0, kEBorder);

  int best = INT_MIN;
  for (int j = 1; j <= W; ++j) {
    const int wj = __ldg(wT + (size_t)(j - 1) * n + b);
    int hdiag = 0;
    int hup = 0;
    int fup = sc.neg;
#pragma unroll 4
    for (int i = 1; i <= L; ++i) {
      const int qi = __ldg(qT + (size_t)(i - 1) * n + b);
      const int h = sw_cell(col + i * kS2Threads + tid, qi == wj, sc, hdiag,
                            hup, fup);
      best = max(best, h * kTie - (i * (W + 1) + j));
    }
  }
  key[b] = best;
}

Scoring make_scoring(int match, int mismatch, int gap_open, int gap_extend,
                     int neg) {
  return Scoring{match, mismatch, gap_open + gap_extend, gap_extend, neg};
}

// ops/sw_variants.py::Variant.smem_bytes gives the same count.
template <int kT, int kUnroll, bool kStageQ>
int launch_variant(const void* q, const void* w, void* score, void* i_end,
                   void* j_end, int n, int L, int W, Scoring sc,
                   void* stream) {
  const size_t smem =
      ((size_t)(L + 1) * kT + (kStageQ ? (size_t)(L / 4) * (kT + 1) : 0)) *
      sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sw_variant_kernel<kT, kUnroll, kStageQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kT - 1) / kT;
  sw_variant_kernel<kT, kUnroll, kStageQ>
      <<<blocks, kT, smem, (cudaStream_t)stream>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
          static_cast<int32_t*>(score), static_cast<int32_t*>(i_end),
          static_cast<int32_t*>(j_end), n, L, W, sc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the S1 variant named at run time, or returns
// cudaErrorInvalidValue for one that is not built.
int rambl_sw_variant_score(const void* q, const void* w, void* score,
                           void* i_end, void* j_end, int n, int L, int W,
                           int match, int mismatch, int gap_open,
                           int gap_extend, int neg, int threads, int unroll,
                           int stage_q, void* stream) {
  const Scoring sc = make_scoring(match, mismatch, gap_open, gap_extend, neg);
#define RAMBL_VARIANT(T, U)                                                  \
  if (threads == T && unroll == U)                                           \
    return stage_q ? launch_variant<T, U, true>(q, w, score, i_end, j_end, n, \
                                                L, W, sc, stream)            \
                   : launch_variant<T, U, false>(q, w, score, i_end, j_end,  \
                                                 n, L, W, sc, stream);
  RAMBL_VARIANT(64, 4)
  RAMBL_VARIANT(64, 8)
  RAMBL_VARIANT(128, 4)
  RAMBL_VARIANT(128, 8)
  RAMBL_VARIANT(256, 4)
  RAMBL_VARIANT(256, 8)
#undef RAMBL_VARIANT
  return (int)cudaErrorInvalidValue;
}

int rambl_sw_pretransposed(const void* qT, const void* wT, void* key, int n,
                           int L, int W, int match, int mismatch,
                           int gap_open, int gap_extend, int neg,
                           void* stream) {
  const size_t smem = (size_t)(L + 1) * kS2Threads * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sw_pretransposed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kS2Threads - 1) / kS2Threads;
  sw_pretransposed_kernel<<<blocks, kS2Threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(qT), static_cast<const int32_t*>(wT),
      static_cast<int32_t*>(key), n, L, W,
      make_scoring(match, mismatch, gap_open, gap_extend, neg));
  return (int)cudaGetLastError();
}

}  // extern "C"
