// Smith-Waterman kernels for Hopper (sm_90a): the hot DP of the align step.
//
// Three kernels, each bit-identical to its plain PyTorch twin in
// rambl_tpu_torch/ops/sw.py (and so to rambl_tpu/ops/sw.py):
//
//   sw_score_kernel      replaces rambl_tpu/ops/sw_pallas.py::_score_kernel
//                        (K1): best cell (score, i_end, j_end) of every
//                        (query, window) pair.
//   sw_align_kernel      replaces rambl_tpu/ops/sw_pallas.py::_align_kernel
//                        (K2): the same DP, also writing a 4-bit direction
//                        code per cell (bits 0-1 the H choice with ties
//                        zero > diag > E > F, bit 2 E-open, bit 3 F-open;
//                        open wins ties with extend).
//   sw_traceback_kernel  replaces rambl_tpu/ops/sw_pallas.py::
//                        sw_traceback_packed (K3): walks the M/E/F state
//                        machine back from the end cell into ref_col.
//
// Design. One thread per pair. The DP sweeps window columns j = 1..W in the
// outer loop and query rows i = 1..rows in the inner loop, so the state kept
// between columns is one column of (H, E): rows + 1 words per thread in
// shared memory, laid out [row][thread] so a warp touches 32 banks. F and the
// H above are running scalars in registers. H <= rows * match < 2^15 and
// E >= -(gap_open + gap_extend) once j >= 1, so H and E share one 32-bit word
// (E in the high half); the E border of column 0, whose true value is
// neg_inf, is stored as INT16_MIN, which loses to every open move exactly as
// neg_inf does. The wrapper checks both bounds. The best cell is the running
// maximum of the packed key H * 32768 - (i * (W + 1) + j) over cells with
// H > 0, so the sweep order does not change which cell wins.
//
// Bound. About 12 integer ops per cell and ~1.1 G cells per 8192-read batch
// (65,536 pairs x 104 rows x 160 columns): the kernel is bound by integer
// issue, and by latency at this occupancy (128 threads a block, 4 blocks an
// SM at rows = 104). Staging a block's q and w tiles in shared memory with a
// batch-minor layout, 16-bit DPX (__vimax3_s32, __viaddmax_s16x2) and a warp
// per pair are left for later performance work.
//
// Direction layout (K2 -> K3): dirs[(i + j - 2), (i - 1), b] as bytes, shape
// (rows + W - 1, rows, n): the reference's anti-diagonal layout with the
// batch axis last, so a warp's writes are coalesced. Cells outside the
// rectangle stay 0 (the wrapper zero-fills).
//
// C interface: every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "sw_common.cuh"

namespace {

constexpr int kThreads = 128;

// One thread per pair; see the file comment. q rows are read four codes at a
// time (rows and L are multiples of 4, checked by the wrapper).
template <bool kDirs>
__global__ void __launch_bounds__(kThreads)
sw_dp_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
             int32_t* __restrict__ score, int32_t* __restrict__ i_end,
             int32_t* __restrict__ j_end, uint8_t* __restrict__ dirs, int n,
             int L, int W, int rows, Scoring sc) {
  extern __shared__ uint32_t col[];  // (rows + 1) x kThreads packed (H, E)
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= n) return;  // no block-wide barrier below, so leaving is safe

  const uint32_t* qb = reinterpret_cast<const uint32_t*>(q + (size_t)b * L);
  const int8_t* wb = w + (size_t)b * W;
  for (int i = 0; i <= rows; ++i) col[i * kThreads + tid] = pack_he(0, kEBorder);

  int best = kNone;
  for (int j = 1; j <= W; ++j) {
    const int wj = wb[j - 1];
    int hdiag = 0;       // H(i - 1, j - 1); row 0 is the zero border
    int hup = 0;         // H(i - 1, j)
    int fup = sc.neg;    // F(i - 1, j); row 0 is neg_inf
    for (int i0 = 0; i0 < rows; i0 += 4) {
      const uint32_t q4 = __ldg(qb + (i0 >> 2));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u + 1;
        const int qi = static_cast<int8_t>((q4 >> (8 * u)) & 0xFFu);
        const uint32_t left = col[i * kThreads + tid];
        const int hleft = unpack_h(left);
        const int e_open = hleft - sc.go_ge;
        const int e_ext = unpack_e(left) - sc.ge;
        const int e = max(e_open, e_ext);
        const int f_open = hup - sc.go_ge;
        const int f_ext = fup - sc.ge;
        const int f = max(f_open, f_ext);
        const int diag =
            hdiag + ((qi == wj && qi < 4) ? sc.match : sc.mismatch);
        const int h = max(max(diag, 0), max(e, f));
        if (kDirs) {
          const int ch = h == 0 ? 0 : (h == diag ? 1 : (h == e ? 2 : 3));
          const int nib =
              ch | (e_open >= e_ext ? 4 : 0) | (f_open >= f_ext ? 8 : 0);
          dirs[((size_t)(i + j - 2) * rows + (i - 1)) * n + b] =
              static_cast<uint8_t>(nib);
        }
        if (h > 0) best = max(best, h * kTie - (i * (W + 1) + j));
        col[i * kThreads + tid] = pack_he(h, e);
        hdiag = hleft;
        hup = h;
        fup = f;
      }
    }
  }
  decode_best(best, W, b, score, i_end, j_end);
}

// One thread per pair, following rambl_tpu/ops/sw.py::sw_traceback step for
// step: states 0 = M, 1 = E, 2 = F, 3 = done; at most rows + W + 2 steps.
__global__ void __launch_bounds__(kThreads)
sw_traceback_kernel(const uint8_t* __restrict__ dirs,
                    const int32_t* __restrict__ i_end,
                    const int32_t* __restrict__ j_end,
                    int32_t* __restrict__ ref_col, int n, int rows, int L,
                    int W) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n) return;
  int32_t* out = ref_col + (size_t)b * L;
  for (int k = 0; k < L; ++k) out[k] = -1;

  int i = i_end[b];
  int j = j_end[b];
  int st = (i > 0 && j > 0) ? 0 : 3;
  const int steps = rows + W + 2;
  for (int t = 0; t < steps && st != 3; ++t) {
    // st != 3 implies 1 <= i <= rows and 1 <= j <= W
    const int p = dirs[((size_t)(i + j - 2) * rows + (i - 1)) * n + b];
    const int ch = p & 0x3;
    const bool act_m = st == 0, act_e = st == 1, act_f = st == 2;
    const bool m_diag = act_m && ch == 1;
    if (m_diag) out[i - 1] = j - 1;
    const int ni = i - (m_diag ? 1 : 0) - (act_f ? 1 : 0);
    const int nj = j - (m_diag ? 1 : 0) - (act_e ? 1 : 0);
    int nst = st;
    if (act_m && ch == 0) nst = 3;
    if (act_m && ch == 2) nst = 1;
    if (act_m && ch == 3) nst = 2;
    if (act_e) nst = ((p >> 2) & 1) ? 0 : 1;
    if (act_f) nst = ((p >> 3) & 1) ? 0 : 2;
    if (ni <= 0 || nj <= 0) nst = 3;
    i = ni;
    j = nj;
    st = nst;
  }
}

template <bool kDirs>
int launch_dp(const void* q, const void* w, void* score, void* i_end,
              void* j_end, void* dirs, int n, int L, int W, int rows,
              int match, int mismatch, int gap_open, int gap_extend, int neg,
              void* stream) {
  const size_t smem = (size_t)(rows + 1) * kThreads * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sw_dp_kernel<kDirs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Scoring sc{match, mismatch, gap_open + gap_extend, gap_extend, neg};
  const int blocks = (n + kThreads - 1) / kThreads;
  sw_dp_kernel<kDirs><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(score), static_cast<int32_t*>(i_end),
      static_cast<int32_t*>(j_end), static_cast<uint8_t*>(dirs), n, L, W,
      rows, sc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rambl_sw_score(const void* q, const void* w, void* score, void* i_end,
                   void* j_end, int n, int L, int W, int rows, int match,
                   int mismatch, int gap_open, int gap_extend, int neg,
                   void* stream) {
  return launch_dp<false>(q, w, score, i_end, j_end, nullptr, n, L, W, rows,
                          match, mismatch, gap_open, gap_extend, neg, stream);
}

int rambl_sw_align(const void* q, const void* w, void* score, void* i_end,
                   void* j_end, void* dirs, int n, int L, int W, int rows,
                   int match, int mismatch, int gap_open, int gap_extend,
                   int neg, void* stream) {
  return launch_dp<true>(q, w, score, i_end, j_end, dirs, n, L, W, rows,
                         match, mismatch, gap_open, gap_extend, neg, stream);
}

int rambl_sw_traceback(const void* dirs, const void* i_end, const void* j_end,
                       void* ref_col, int n, int rows, int L, int W,
                       void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  sw_traceback_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(i_end),
      static_cast<const int32_t*>(j_end), static_cast<int32_t*>(ref_col), n,
      rows, L, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
