// K1's function under a sweep of designs (S1) and on pre-transposed inputs
// (S2), for Hopper (sm_90a): the kernels of the two bench scripts beside
// bench.py. Both are instances of one strip kernel built on K1's design
// (sw.cu, whose device pieces it shares through sw_common.cuh).
//
//   sw_strip_kernel<kStrips, kWarps, kPairs, S1Load, TripleOut>
//       replaces scripts/bench_sw_variants.py::make_score_fn(...).score (its
//       Pallas `kernel`): int8 q (n, L) and w (n, W), pair-major, -> the
//       best cell (score, i_end, j_end) of each pair; window codes >= 4
//       never match; no `rows` truncation; any W. One instance a variant of
//       the sweep (ops/sw_variants.py::VARIANTS).
//   sw_strip_kernel<kS2Strips, kS2Warps, 2, S2Load, RawKeyOut>
//       replaces scripts/ablate_prep.py::kernel_only
//       (rambl_tpu/ops/sw_pallas.py::_score_kernel on inputs already cast to
//       int32 and transposed): int32 qT (L, n) and wT (>= W, n), batch-minor,
//       codes compared as given, -> the raw key that _score_kernel leaves in
//       row 0 of its output tile: the maximum over every cell, zero cells
//       included, of H * 32768 - (i * (W + 1) + j). It is rebuilt from the
//       best cell: s * 32768 - (i * (W + 1) + j) when s > 0, else -(W + 2),
//       the key of cell (1, 1). Only rows 0..W-1 of wT are read.
//
// The design (K1's, generalised).
// - kPairs pairs a thread: 2 in packed 16-bit DPX (__viaddmax_s16x2,
//   __vimax3_s16x2_relu: sw_common.cuh::score_cell), or 1 in 32-bit DPX
//   (__viaddmax_s32, __vimax3_s32_relu: score_cell32 below), the arithmetic
//   of K2 + K3's recurrence. The column state is (H - open, E) a row, one
//   64-bit shared word per thread and row either way, [row][lane].
// - kStrips strips. A pair's q words are cut into kStrips strips of whole
//   words, strip s on lanes [s * 32 / kStrips, (s + 1) * 32 / kStrips) of the
//   warp, and strip s does column t + 1 - s at step t: it takes H - open and
//   F of the last row of strip s - 1 at its column, and the column's w
//   codes, by __shfl_up_sync, and the H that came in a step before is its
//   diagonal. W + kStrips - 1 steps. The loop count is the warp's, so every
//   shuffle is reached by all 32 lanes; a strip outside 1 <= j <= W skips
//   the column after the shuffles. More strips mean more resident warps on
//   the same shared memory: the column state costs (rows + kStrips - 1) x
//   8 B a thread, whatever kStrips is, and kStrips cuts a thread's rows.
// - kWarps warps a block. The block stages its pairs' w codes 32 columns at
//   a time between two __syncthreads, so kWarps sets the scope of those
//   barriers against the number of blocks an SM holds.
// - The block's q words are staged once, [pair parity][strip][word][lane],
//   a strip's words an odd count apart so that the strips' reads of a step
//   meet in no bank; strip s's column state starts s rows further down for
//   the same reason. w is staged as [column][pair] bytes.
// - The match test is K1's: codes staged one byte each, two byte-equality
//   masks for four rows of two pairs, one prmt a cell. S1 remaps q >= 4 to
//   4 and w >= 4 to 5 while staging, so that code 4 never matches. S2
//   compares its int32 codes as given, so a code cut to one byte would make
//   256 equal 0: S2 takes a block-uniform branch. The block stages its q
//   codes as bytes, and __syncthreads_or, the barrier after the staging,
//   tells whether any lies outside 0..126. If none does, the byte path is
//   exact whatever w holds: a w code outside 0..126 is staged as 127, which
//   equals no q byte, and a row past L (or a pair past n) as 255, which
//   equals no w byte. If one does, the block runs the same sweep with the
//   32-bit compare: each strip reads its q codes and the column's w codes
//   from device memory and builds the same equality bits, with rows past L
//   never equal.
// - The best cell: K1's keys. A column key (H << rbits) + (2^rbits - i),
//   one multiply-add and one max a cell, then once a column
//   (colkey << 16) | (0xFFFF - j) into the running max: the highest H, then
//   the lowest i, then the lowest j, the reference's order. The strips'
//   maxima meet in strip 0 by __shfl_down_sync.
// 16-bit range: sw.cu's argument, with rows = L rounded up to whole words
// (ops.sw.check_packed16 at the wrappers). A row past L (S2 only) matches
// nothing, so its H is below that of a cell above or left of it, and it
// never holds the best cell.
//
// Bound: integer operations. K1's 5.25 a cell on the byte path (a packed
// instruction serves two cells), 10.5 in 32-bit arithmetic; S2's range
// test while staging adds two a code, (L + W) a pair. The bytes (int8 or
// int32 in, 12 B or 4 B out a pair) take microseconds.
//
// C interface: every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "sw_common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChunk = 32;                 // window columns staged at a time
// S2's one design: 8 strips of 16 rows at 128 rows, 4 warps a block (36
// resident warps an SM at 65,536 x 128 x 160; its times are in PERF.md §6)
constexpr int kS2Strips = 8, kS2Warps = 4;
constexpr uint32_t kNoRow = 0xFFFFFFFFu;   // S2: rows past L (file comment)

// A block's shared memory at `rows` query rows (ops/sw_variants.py::
// Variant.smem_bytes gives the same count): each warp's column state and q
// planes, then one chunk of w.
template <int kStrips, int kWarps, int kPairs>
struct StripLayout {
  static constexpr int kLanes = 32 / kStrips;          // lanes a strip
  static constexpr int kWarpPairs = kLanes * kPairs;
  static constexpr int kBlockPairs = kWarps * kWarpPairs;
  static constexpr int kWStride = kBlockPairs + 4;     // bytes a w column
  int r4;        // q words a pair
  int q_words;   // words a strip of a q plane holds (odd)
  int col_rows;  // rows of a warp's column state (kStrips - 1 of them pads)
  __host__ __device__ explicit StripLayout(int rows)
      : r4((rows + 3) >> 2),
        q_words(((r4 + kStrips - 1) / kStrips) | 1),
        col_rows(4 * r4 + kStrips - 1) {}
  __host__ __device__ int k0(int strip) const { return strip * r4 / kStrips; }
  // the strip that holds q word k: the last s with k0(s) <= k
  __host__ __device__ int strip_of(int k) const {
    return ((k + 1) * kStrips - 1) / r4;
  }
  __host__ __device__ size_t col_bytes() const {   // a warp's
    return (size_t)col_rows * kLanes * 8;
  }
  __host__ __device__ size_t q_bytes() const {     // a warp's
    return (size_t)kPairs * kStrips * q_words * kLanes * 4;
  }
  __host__ __device__ size_t bytes() const {
    return kWarps * (col_bytes() + q_bytes()) +
           (((size_t)kChunk * kWStride + 15) & ~(size_t)15);
  }
};

// S1's codes: int8, pair-major; a pair past n is all code 4.
struct S1Load {
  const int8_t* q;
  const int8_t* w;
  static constexpr bool kPairMinor = false;  // staging order for coalescing
  static constexpr bool kMayBeWide = false;
  __device__ uint32_t q_word(int b, int k, int n, int L, bool&) const {
    return b < n ? remap4(__ldg(reinterpret_cast<const uint32_t*>(q) +
                                (size_t)b * (L >> 2) + k), 4)
                 : 0x04040404u;
  }
  __device__ unsigned char w_byte(int b, int j, int n, int W) const {
    const int c = b < n ? w[(size_t)b * W + j] : 4;
    return static_cast<unsigned char>(c < 4 ? c : 5);
  }
  // the 32-bit compare path: never taken (S1 has no codes outside a byte),
  // but the sweep names it in both of its instances
  __device__ uint32_t eq_word(int, int, int, int, int) const { return 0; }
  __device__ int w_code(int, int, int) const { return 0; }
};

// S2's codes: int32, batch-minor, compared as given.
struct S2Load {
  const int32_t* qT;
  const int32_t* wT;
  static constexpr bool kPairMinor = true;
  static constexpr bool kMayBeWide = true;
  // q word k of pair b as bytes; `wide` is set if a code lies outside
  // 0..126 (the block then takes the 32-bit compare path)
  __device__ uint32_t q_word(int b, int k, int n, int L, bool& wide) const {
    uint32_t v = kNoRow;
    if (b < n) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * k + u;
        if (i < L) {
          const int c = __ldg(qT + (size_t)i * n + b);
          wide |= (uint32_t)c > 126u;
          v = (v & ~(0xFFu << (8 * u))) | ((uint32_t)(c & 0xFF) << (8 * u));
        }
      }
    }
    return v;
  }
  // byte path: a code outside 0..126 equals no staged q code
  __device__ unsigned char w_byte(int b, int j, int n, int) const {
    const uint32_t c = b < n ? (uint32_t)__ldg(wT + (size_t)j * n + b) : 127u;
    return static_cast<unsigned char>(c > 126u ? 127u : c);
  }
  // 32-bit compare path: bit 7 of byte u set iff row 4k + u of pair b
  // exists and its code equals wj
  __device__ uint32_t eq_word(int b, int k, int wj, int n, int L) const {
    uint32_t eq = 0;
    if (b < n) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * k + u;
        if (i < L && __ldg(qT + (size_t)i * n + b) == wj) eq |= 0x80u << (8 * u);
      }
    }
    return eq;
  }
  __device__ int w_code(int b, int j, int n) const {
    return b < n ? __ldg(wT + (size_t)j * n + b) : 0;
  }
};

// S1: the decoded best cell.
struct TripleOut {
  int32_t* score;
  int32_t* i_end;
  int32_t* j_end;
  __device__ void put(int b, int h, int i, int j, int) const {
    score[b] = h;
    i_end[b] = i;
    j_end[b] = j;
  }
};

// S2: the raw key of _score_kernel (file comment).
struct RawKeyOut {
  int32_t* key;
  __device__ void put(int b, int h, int i, int j, int W) const {
    key[b] = h ? h * kTie - (i * (W + 1) + j) : -(W + 2);
  }
};

template <class Load, class Out>
struct StripArgs {
  Load load;
  Out out;
  int n, L, W, rows;  // rows: L rounded up to whole q words
  Scoring2 sc;
};

// The scoring constants of the 32-bit arithmetic.
struct Scoring32 {
  int mismatch_open, match_delta, neg_extend, neg_open;
  __device__ explicit Scoring32(const Scoring2& s)
      : mismatch_open(lo16(s.mismatch_open)),
        match_delta(lo16(s.mismatch_open) ^
                    lo16(s.mismatch_open ^ s.match_delta)),
        neg_extend(lo16(s.neg_extend)),
        neg_open(lo16(s.neg_open)) {}
  __device__ static int lo16(uint32_t v) {
    return static_cast<int16_t>(v & 0xFFFFu);
  }
};

// score_cell for one pair in 32-bit DPX arithmetic: row kRow of the four
// whose equality bits are in eq.
template <int kRow>
__device__ __forceinline__ void score_cell32(uint2* cell, uint32_t eq,
                                             int row_code, int key_mul,
                                             const Scoring32& sc, int& hm_diag,
                                             int& hm_up, int& f_up,
                                             int& colkey) {
  constexpr uint32_t kSel = (kRow | 8) * 0x1111u;
  const uint2 left = *cell;                         // (H - open, E)(i, j - 1)
  const int e = __viaddmax_s32(static_cast<int>(left.y), sc.neg_extend,
                               static_cast<int>(left.x));
  const int match = static_cast<int>(prmt<kSel>(eq, 0u));
  const int diag = hm_diag + (sc.mismatch_open ^ (match & sc.match_delta));
  const int f = __viaddmax_s32(f_up, sc.neg_extend, hm_up);
  const int h = __vimax3_s32_relu(diag, e, f);
  const int hm = h + sc.neg_open;
  *cell = make_uint2(static_cast<uint32_t>(hm), static_cast<uint32_t>(e));
  colkey = __viaddmax_s32(h * key_mul + row_code, -kRow, colkey);
  hm_diag = static_cast<int>(left.x);
  hm_up = hm;
  f_up = f;
}

// The strip kernel (file comment). Thread (warp g, lane l) is strip
// l / kLanes of the pairs base + g * kWarpPairs + kPairs * (l % kLanes)
// + 0 .. kPairs - 1; the halves of its words are those pairs.
template <int kStrips, int kWarps, int kPairs, class Load, class Out>
__global__ void __launch_bounds__(32 * kWarps)
sw_strip_kernel(const StripArgs<Load, Out> a) {
  static_assert(kPairs == 1 || kPairs == 2, "one or two pairs a thread");
  using Lay = StripLayout<kStrips, kWarps, kPairs>;
  constexpr int kLanes = Lay::kLanes, kPW = Lay::kWarpPairs;
  constexpr int kPB = Lay::kBlockPairs, kThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay lay(a.rows);
  const int n = a.n, L = a.L, W = a.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = lane / kLanes, unit = lane % kLanes;
  const int base = blockIdx.x * kPB;         // the block's first pair
  const int b0 = base + warp * kPW + kPairs * unit;  // the thread's first
  uint2* col = reinterpret_cast<uint2*>(smem + warp * lay.col_bytes());
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + kWarps * lay.col_bytes());
  unsigned char* ws = smem + kWarps * (lay.col_bytes() + lay.q_bytes());
  const int k0 = lay.k0(strip), k1 = lay.k0(strip + 1);  // my q words
  const int rbits = a.sc.rbits;
  const Scoring2 sc = a.sc;
  const Scoring32 sc32(a.sc);
  // no thread leaves before the last barrier: a warp past n computes on
  // the sentinels and writes nothing

  // q: word k of pair p to [parity][strip][word][lane] of its warp (loads
  // unrolled so that several are in flight)
  bool wide = false;
#pragma unroll 4
  for (int x = threadIdx.x; x < kPB * lay.r4; x += kThreads) {
    const int p = Load::kPairMinor ? x % kPB : x / lay.r4;
    const int k = Load::kPairMinor ? x / kPB : x % lay.r4;
    const int pw = p % kPW, s = lay.strip_of(k);
    qs[(p / kPW) * (lay.q_bytes() / 4) +
       (((pw % kPairs) * kStrips + s) * lay.q_words + k - lay.k0(s)) *
           kLanes +
       pw / kPairs] = a.load.q_word(base + p, k, n, L, wide);
  }
  if (Load::kMayBeWide) wide = __syncthreads_or(wide);  // block-uniform

  // the sweep, on the byte path or (S2) the 32-bit compare path
  auto sweep = [&](auto wide_tag) {
    constexpr bool kWide = decltype(wide_tag)::value;
    const uint32_t hm0 = kPairs == 2 ? sc.neg_open : sc32.neg_open;
    const uint32_t border = kPairs == 2 ? pack2(kBorder16) : kBorder16;
    uint2* my_col = col + (4 * k0 + strip) * kLanes + unit;
    for (int i = 0; i < 4 * (k1 - k0); ++i)
      my_col[i * kLanes] = make_uint2(hm0, border);
    const uint32_t* my_q = qs + warp * (lay.q_bytes() / 4) +
                           strip * lay.q_words * kLanes + unit;
    const int q_plane = kStrips * lay.q_words * kLanes;
    const int row0 = (1 << rbits) - (4 * k0 + 1);
    const uint32_t row_code0 = kPairs == 2 ? pack2(row0) : (uint32_t)row0;

    // per pair: (column key << 16) | (0xFFFF - j) of the best cell so far
    uint32_t best_lo = 0, best_hi = 0;
    uint32_t last_hm = hm0, last_f = border;  // my last row's H - open, F
    uint32_t diag_in = hm0, wcur = 0;         // and what came in
    const int steps = W + kStrips - 1;        // strip s: column t + 1 - s
    for (int t0 = 0; t0 < steps; t0 += kChunk) {
      const int cw = min(kChunk, steps - t0);
      if (!kWide) {
        __syncthreads();        // the last chunk is used up (first: q staged)
#pragma unroll 4
        for (int x = threadIdx.x; x < kChunk * kPB; x += kThreads) {
          const int p = Load::kPairMinor ? x % kPB : x / kChunk;
          const int c = Load::kPairMinor ? x / kPB : x % kChunk;
          if (t0 + c < W)
            ws[c * Lay::kWStride + p] = a.load.w_byte(base + p, t0 + c, n, W);
        }
        __syncthreads();
      }
      for (int c = 0; c < cw; ++c) {
        const int j = t0 + c + 1 - strip;     // my column at this step
        uint32_t hm_up = hm0, f_up = border, hm_diag = hm0;
        const uint32_t in_hm = __shfl_up_sync(kFull, last_hm, kLanes);
        const uint32_t in_f = __shfl_up_sync(kFull, last_f, kLanes);
        const uint32_t in_w = kWide ? 0u : __shfl_up_sync(kFull, wcur, kLanes);
        if (strip > 0) {
          hm_up = in_hm;
          f_up = in_f;
          hm_diag = diag_in;                  // what came in a step ago
          diag_in = in_hm;
          wcur = in_w;
        }
        if (!kWide && strip == 0 && j <= W) {
          const unsigned char* wc = ws + c * Lay::kWStride + warp * kPW +
                                    kPairs * unit;
          wcur = kPairs == 2 ? *reinterpret_cast<const uint16_t*>(wc) : *wc;
        }
        if (j < 1 || j > W) continue;         // filling or draining
        int wj0 = 0, wj1 = 0;
        if (kWide) {
          wj0 = a.load.w_code(b0, j - 1, n);
          if (kPairs == 2) wj1 = a.load.w_code(b0 + 1, j - 1, n);
        }
        const uint32_t w0 = prmt<0x0000>(wcur, 0u);  // byte 0 four times
        const uint32_t w1 = prmt<0x1111>(wcur, 0u);
        uint2* cell = my_col;
        const uint32_t* qk = my_q;
        uint32_t low = 0xFFFFu - (uint32_t)j;
        if (kPairs == 2) {
          uint32_t colkey = 0, row_code = row_code0;
#pragma unroll 2
          for (int k = k0; k < k1; ++k) {
            const uint32_t eq_lo = kWide ? a.load.eq_word(b0, k, wj0, n, L)
                                         : equal_bits(qk[0], w0);
            const uint32_t eq_hi = kWide ? a.load.eq_word(b0 + 1, k, wj1, n, L)
                                         : equal_bits(qk[q_plane], w1);
            score_cell<0>(cell, eq_lo, eq_hi, row_code, sc, hm_diag, hm_up,
                          f_up, colkey);
            score_cell<1>(cell + kLanes, eq_lo, eq_hi, row_code, sc, hm_diag,
                          hm_up, f_up, colkey);
            score_cell<2>(cell + 2 * kLanes, eq_lo, eq_hi, row_code, sc,
                          hm_diag, hm_up, f_up, colkey);
            score_cell<3>(cell + 3 * kLanes, eq_lo, eq_hi, row_code, sc,
                          hm_diag, hm_up, f_up, colkey);
            cell += 4 * kLanes;
            qk += kLanes;
            row_code -= 0x00040004u;
          }
          best_lo = max(best_lo, (colkey << 16) | low);
          best_hi = max(best_hi, (colkey & 0xFFFF0000u) | low);
        } else {
          int colkey = 0, row_code = row0;
          int hmd = (int)hm_diag, hmu = (int)hm_up, fu = (int)f_up;
          const int key_mul = 1 << rbits;
#pragma unroll 2
          for (int k = k0; k < k1; ++k) {
            const uint32_t eq = kWide ? a.load.eq_word(b0, k, wj0, n, L)
                                      : equal_bits(qk[0], w0);
            score_cell32<0>(cell, eq, row_code, key_mul, sc32, hmd, hmu, fu,
                            colkey);
            score_cell32<1>(cell + kLanes, eq, row_code, key_mul, sc32, hmd,
                            hmu, fu, colkey);
            score_cell32<2>(cell + 2 * kLanes, eq, row_code, key_mul, sc32,
                            hmd, hmu, fu, colkey);
            score_cell32<3>(cell + 3 * kLanes, eq, row_code, key_mul, sc32,
                            hmd, hmu, fu, colkey);
            cell += 4 * kLanes;
            qk += kLanes;
            row_code -= 4;
          }
          hm_up = (uint32_t)hmu;
          f_up = (uint32_t)fu;
          best_lo = max(best_lo, ((uint32_t)colkey << 16) | low);
        }
        last_hm = hm_up;
        last_f = f_up;
      }
    }
    // the strips' bests meet in strip 0 (their rows differ, so their keys do)
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1) {
      best_lo = max(best_lo, __shfl_down_sync(kFull, best_lo, off));
      if (kPairs == 2)
        best_hi = max(best_hi, __shfl_down_sync(kFull, best_hi, off));
    }
    if (strip != 0) return;
#pragma unroll
    for (int half = 0; half < kPairs; ++half) {
      const int b = b0 + half;
      if (b >= n) break;
      const uint32_t best = half ? best_hi : best_lo;
      const int key = (int)(best >> 16);
      const int h = key >> rbits;             // a cell with H = 0 keys < 2^rbits
      a.out.put(b, h, h ? (1 << rbits) - (key & ((1 << rbits) - 1)) : 0,
                h ? (int)(0xFFFFu - (best & 0xFFFFu)) : 0, W);
    }
  };
  if constexpr (Load::kMayBeWide) {
    if (wide) {
      sweep(std::true_type{});
      return;
    }
  }
  sweep(std::false_type{});
}

template <int kStrips, int kWarps, int kPairs, class Load, class Out>
int launch_strips(const StripArgs<Load, Out>& a, void* stream) {
  using Lay = StripLayout<kStrips, kWarps, kPairs>;
  const size_t smem = Lay(a.rows).bytes();
  auto* kernel = sw_strip_kernel<kStrips, kWarps, kPairs, Load, Out>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + Lay::kBlockPairs - 1) / Lay::kBlockPairs;
  kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S1: the variant (strips, warps, pairs a thread) named at run time, or
// cudaErrorInvalidValue for one that is not built. L is a multiple of 4;
// `rbits` as for rambl_sw_score, at L rows.
int rambl_sw_strip_score(const void* q, const void* w, void* score,
                         void* i_end, void* j_end, int n, int L, int W,
                         int match, int mismatch, int gap_open,
                         int gap_extend, int rbits, int strips, int warps,
                         int pairs, void* stream) {
  const StripArgs<S1Load, TripleOut> a{
      S1Load{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w)},
      TripleOut{static_cast<int32_t*>(score), static_cast<int32_t*>(i_end),
                static_cast<int32_t*>(j_end)},
      n, L, W, L, make_scoring2(match, mismatch, gap_open, gap_extend, rbits)};
#define RAMBL_STRIPS(S, G)                                                   \
  if (strips == S && warps == G)                                             \
    return pairs == 2 ? launch_strips<S, G, 2>(a, stream)                    \
                      : launch_strips<S, G, 1>(a, stream);
  if (pairs == 1 || pairs == 2) {
    RAMBL_STRIPS(1, 1)
    RAMBL_STRIPS(1, 4)
    RAMBL_STRIPS(2, 1)
    RAMBL_STRIPS(2, 4)
    RAMBL_STRIPS(4, 1)
    RAMBL_STRIPS(4, 4)
  }
#undef RAMBL_STRIPS
  return (int)cudaErrorInvalidValue;
}

// S2: `rbits` at L rounded up to a multiple of 4 rows.
int rambl_sw_pretransposed(const void* qT, const void* wT, void* key, int n,
                           int L, int W, int match, int mismatch,
                           int gap_open, int gap_extend, int rbits,
                           void* stream) {
  const StripArgs<S2Load, RawKeyOut> a{
      S2Load{static_cast<const int32_t*>(qT), static_cast<const int32_t*>(wT)},
      RawKeyOut{static_cast<int32_t*>(key)},
      n, L, W, (L + 3) & ~3,
      make_scoring2(match, mismatch, gap_open, gap_extend, rbits)};
  return launch_strips<kS2Strips, kS2Warps, 2>(a, stream);
}

}  // extern "C"
