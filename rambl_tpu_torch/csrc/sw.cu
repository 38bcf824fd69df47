// Smith-Waterman kernels for Hopper (sm_90a): the hot DP of the align step.
//
// Two kernels, each bit-identical to its plain PyTorch twin in
// rambl_tpu_torch/ops/sw.py (and so to rambl_tpu/ops/sw.py):
//
//   sw_score_kernel      replaces rambl_tpu/ops/sw_pallas.py::_score_kernel
//                        (K1): best cell (score, i_end, j_end) of every
//                        (query, window) pair. Two pairs a thread in packed
//                        16-bit DPX arithmetic on staged q and w tiles, a
//                        pair's rows split over two lanes (K1's bound and
//                        design, below).
//   sw_align_traceback_kernel
//                        replaces sw_pallas.py::_align_kernel (K2) and
//                        sw_pallas.py::sw_traceback_packed (K3) in one
//                        launch: the same DP in 32-bit arithmetic with a
//                        4-bit direction code a cell (bits 0-1 the H choice
//                        with ties zero > diag > E > F, bit 2 E-open, bit 3
//                        F-open; open wins ties with extend), kept in shared
//                        memory, then the walk of the M/E/F state machine
//                        back from the end cell into ref_col.
//
// K1's bound and design. The best cell is the one with the highest H, then
// the lowest i, then the lowest j; (0, 0, 0) where no cell is positive.
// Bound: integer operations (the bytes, int8 in and three int32 out a pair,
// take microseconds). The design halves the operations a cell and takes
// every load out of device memory's way:
//
// - Two pairs a thread. H, E and F of pairs 2t and 2t + 1 ride in the low
//   and high half of one 32-bit word, and Hopper's DPX instructions work on
//   both halves at once: __viaddmax_s16x2(a, b, c) = max(a + b, c) is one
//   gap recurrence, __vimax3_s16x2_relu(a, b, c) = max(a, b, c, 0) is H.
// - The sweep is columns outer, rows inner, so the state between columns is
//   one column of (H - open, E) a pair: rows x 2 words a thread in shared
//   memory, [row][thread], read and written as one 64-bit word. H is kept
//   less gap_open + gap_extend because both its uses want it so: E of the
//   next column and F of the next row open from it, and the diagonal adds
//   the substitution score plus the same constant back.
// - Two lanes a pair of pairs. The column state, 420 bytes a pair, is what
//   limits the warps an SM holds, and one warp's chain of dependent DPX
//   operations down a column cannot fill its scheduler alone. So the rows
//   of a pair are cut into two strips, the second a column behind the
//   first, which hands it its last row by shuffle (kernel comment): twice
//   the warps on the same shared memory, in half-size units of work. A
//   block is one warp, 32 pairs, so the barriers around the staging of w
//   stall no other warp; twelve blocks an SM at 104 rows.
// - The block's q rows are staged once (coalesced 4-byte loads, laid out
//   conflict-free for the sweep's reads), its w rows 32 columns at a time
//   ([column][pair] bytes). Codes that can never match are remapped while
//   staging (q >= 4 to 4, w >= 4 to 5), so the match test of four rows of
//   both pairs is two byte-equality masks, and one prmt a cell spreads a
//   row's two bits over the halves.
// - The best cell. The 32-bit key H * 32768 - (i * (W + 1) + j) does not fit
//   a half. Within a column a half tracks max(H << rbits | (2^rbits - i)),
//   which orders cells by H and then by lowest i, in one multiply-add and
//   one max a cell; once a column each half's maximum goes, as
//   (maximum << 16) | (0xFFFF - j), into a running max that is the pair's
//   best, so of equal (H, i) the lowest j stays. That is the key's order
//   exactly.
//
// 16-bit borders. Row 0's F and column 0's E are neg_inf in the reference.
// Here they are -16384. That is exact: E(i, 1) = max(H(i, 0) - open,
// border - extend) and H >= 0, so the border term loses to -open, and every
// later E and F is >= -open by the same recurrence; the border value never
// reaches H or the next cell, whatever it is, as long as it is below -open.
// The lowest value formed is border - extend >= -32768 (the wrapper checks
// gap_open + gap_extend < 16384), and the highest is the key, below 32768
// (checked too), so nothing wraps.
//
// K2 + K3's bound and design. About 9.25 integer ops a cell (K1's 5.25 for
// the recurrence, whose values fit 16 bits here too, and 4 for the direction
// code) and 10 a step of the walk; in bytes, q and w in, 12 B a pair and
// ref_col out: the codes never leave the SM. The align step sends it only
// the gapped reads, ~171 pairs a batch, which cannot fill the card: it is
// bound by the latency of a pair's chain of dependent cells, which a warp a
// pair cuts 26 ways.
//
// - A wavefront of strips. Lane l owns rows R*l + 1 .. R*l + R (R = 4 up to
//   128 rows, 8 up to 256) and does column j at step j - 1 + l, W + lanes -
//   1 steps. Lane l - 1 hands on H and F of its last row in one shuffle
//   (both fit 16 bits: H < 2^15 and, below row 0, F >= -(gap_open +
//   gap_extend)); H and E of the lane's rows at the previous column and its
//   q codes stay in registers; the window's codes are staged in shared
//   memory. E, F and H are one DPX instruction each (__viaddmax_s32,
//   __vimax3_s32_relu), in 32-bit arithmetic. Borders as in the reference:
//   row 0 has H = 0 and F = neg_inf, column 0 H = 0 and E = neg_inf.
// - The best cell. Each lane keeps the running max of the key
//   H * 32768 - (i * (W + 1) + j), which is > 0 iff H > 0 (a row past
//   `rows` is keyed below 0); one __reduce_max_sync gives the pair's, and
//   the sweep order cannot change which cell wins.
// - The codes. A lane's R codes of a column are one word in shared memory,
//   [column][lane] with the column stride padded (nib_stride) so that the
//   skewed writes of a step meet in no bank: about rows x W / 2 bytes a
//   pair (8,640 at 104 x 160).
// - The walk. After __syncwarp the warp fills the first `rows` words of a
//   ref_col row in shared memory with -1 (a walk reaches no row past them),
//   lane 0 runs the state machine over the shared words, one load a step,
//   storing j - 1 at i - 1 on each diagonal move, and the warp writes the
//   row out once, -1 from `rows` to L.
// - A block holds kAlignWarps = 4 pairs; a warp past n leaves at once, and
//   nothing after that uses a block barrier.
// - Optional dirs, for the tests: each cell's code also as a byte at
//   dirs[(i + j - 2), (i - 1), b], shape (rows + W - 1, rows, n), the
//   reference's anti-diagonal layout with the batch axis last. Cells outside
//   the rectangle stay 0 (the wrapper zero-fills).
//
// C interface: every entry point launches on the given stream, allocates
// nothing and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "sw_common.cuh"

namespace {

// ---- K1 --------------------------------------------------------------------

constexpr int kScoreThreads = 32;         // a block is one warp
constexpr int kStripLanes = 16;           // lanes a strip, pairs of pairs a block
constexpr int kScorePairs = 2 * kStripLanes;
constexpr int kWChunk = 32;               // window columns staged at a time
constexpr int kWStride = kScorePairs + 4; // bytes between two staged columns
static_assert(kWChunk == kScoreThreads, "a lane stages a column of the chunk");

// A block's shared memory at `rows` query rows (kernel comment).
struct ScoreLayout {
  int col_rows;   // rows of the column state (one of them a pad)
  int q_words;    // words a strip of a q plane holds
  __host__ __device__ explicit ScoreLayout(int rows)
      : col_rows(rows + 1), q_words((((rows >> 2) + 1) / 2) | 1) {}
  __host__ __device__ size_t col_bytes() const {
    return (size_t)col_rows * kStripLanes * 8;
  }
  __host__ __device__ size_t q_bytes() const {
    return (size_t)4 * q_words * kStripLanes * 4;
  }
  __host__ __device__ size_t bytes() const {
    return col_bytes() + q_bytes() + (size_t)kWChunk * kWStride;
  }
};

// A block is one warp and scores 32 pairs: lane l and lane l + 16 share the
// pair of pairs l. The rows of a pair are cut into two strips of whole q
// words; strip 1 (lanes 16-31) runs one column behind strip 0, which hands
// it H - open and F of its last row and the column's w codes by shuffle:
// the same shared memory a pair feeds twice the warps, in units of work
// half the size.
//
// Shared memory: the column state, col_rows x 16 words of 64 bits (strip
// 1's rows start one row below its first row, so that the two strips never
// meet in a bank); q as [pair parity][strip][word][pair of pairs], a
// strip's words an odd count apart for the same reason; one chunk of w as
// [column][pair] bytes.
__global__ void __launch_bounds__(kScoreThreads)
sw_score_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                int32_t* __restrict__ score, int32_t* __restrict__ i_end,
                int32_t* __restrict__ j_end, int n, int L, int W, int rows,
                Scoring2 sc) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  extern __shared__ __align__(16) unsigned char smem[];
  const ScoreLayout lay(rows);
  const int R4 = rows >> 2;
  uint2* col = reinterpret_cast<uint2*>(smem);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + lay.col_bytes());
  unsigned char* ws = smem + lay.col_bytes() + lay.q_bytes();
  const int lane = threadIdx.x;
  const int strip = lane / kStripLanes;
  const int pp = lane % kStripLanes;      // the thread's pair of pairs
  const int base = blockIdx.x * kScorePairs;   // the block's first pair
  const int k0 = strip ? R4 / 2 : 0;      // the strip's q words [k0, k1)
  const int k1 = strip ? R4 : R4 / 2;

  // q: a pair's row at a time, lane by lane its words; a pair past n is all
  // code 4 and scores nothing
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
  const int L4 = L >> 2;
#pragma unroll 4
  for (int p = 0; p < kScorePairs; ++p) {
    for (int k = lane; k < R4; k += 32) {
      const uint32_t v =
          base + p < n ? __ldg(q32 + (size_t)(base + p) * L4 + k) : 0x04040404u;
      const int s = k >= R4 / 2;          // the strip that holds word k
      qs[(((p & 1) * 2 + s) * lay.q_words + k - s * (R4 / 2)) * kStripLanes +
         (p >> 1)] = remap4(v, 4);
    }
  }
  const uint32_t hm0 = sc.neg_open;       // H = 0, less open
  uint2* my_col = col + (4 * k0 + strip) * kStripLanes + pp;
  for (int i = 0; i < 4 * (k1 - k0); ++i)
    my_col[i * kStripLanes] = make_uint2(hm0, pack2(kBorder16));
  const uint32_t* my_q = qs + strip * lay.q_words * kStripLanes + pp;
  const int q_plane = 2 * lay.q_words * kStripLanes;
  const uint32_t row_code0 = pack2((1 << sc.rbits) - (4 * k0 + 1));

  // per half: (column key << 16) | (0xFFFF - j) of the best cell so far, so
  // that one max keeps the highest H, then the lowest i, then the lowest j
  uint32_t best_lo = 0, best_hi = 0;
  uint32_t last_hm = hm0, last_f = pack2(kBorder16);  // my last row's H - open
  uint32_t diag_in = hm0, wpair = 0;                  // and F; what came in
  const int steps = W + 1;                // strip s does column t - s at step t
  for (int t0 = 0; t0 < steps; t0 += kWChunk) {
    const int cw = min(kWChunk, steps - t0);
    __syncthreads();          // the last chunk is used up (first: q staged)
    if (t0 + lane < W) {      // kWChunk is a warp's width: a column a lane
#pragma unroll 8
      for (int p = 0; p < kScorePairs; ++p) {
        const int b = base + p < n ? w[(size_t)(base + p) * W + t0 + lane] : 4;
        ws[lane * kWStride + p] = static_cast<unsigned char>(b < 4 ? b : 5);
      }
    }
    __syncthreads();
    for (int c = 0; c < cw; ++c) {
      const int j = t0 + c + 1 - strip;   // my column at this step
      // from strip 0: its last row at this column (it did it one step ago),
      // and the column's w codes
      uint32_t hm_up = hm0, f_up = pack2(kBorder16), hm_diag = hm0;
      const uint32_t in_hm = __shfl_up_sync(kFull, last_hm, kStripLanes);
      const uint32_t in_f = __shfl_up_sync(kFull, last_f, kStripLanes);
      const uint32_t in_w = __shfl_up_sync(kFull, wpair, kStripLanes);
      if (strip > 0) {
        hm_up = in_hm;
        f_up = in_f;
        hm_diag = diag_in;                // what came in a column ago
        diag_in = in_hm;
        wpair = in_w;
      }
      if (strip == 0 && j <= W)
        wpair = *reinterpret_cast<const uint16_t*>(ws + c * kWStride + 2 * pp);
      if (j < 1 || j > W) continue;       // filling or draining the strips
      const uint32_t w_lo = prmt<0x0000>(wpair, 0u);
      const uint32_t w_hi = prmt<0x1111>(wpair, 0u);
      uint32_t colkey = 0;
      uint32_t row_code = row_code0;
      uint2* cell = my_col;
      const uint32_t* qk = my_q;
#pragma unroll 2
      for (int k = k0; k < k1; ++k) {
        const uint32_t eq_lo = equal_bits(qk[0], w_lo);
        const uint32_t eq_hi = equal_bits(qk[q_plane], w_hi);
        score_cell<0>(cell, eq_lo, eq_hi, row_code, sc, hm_diag, hm_up, f_up,
                      colkey);
        score_cell<1>(cell + kStripLanes, eq_lo, eq_hi, row_code, sc, hm_diag,
                      hm_up, f_up, colkey);
        score_cell<2>(cell + 2 * kStripLanes, eq_lo, eq_hi, row_code, sc,
                      hm_diag, hm_up, f_up, colkey);
        score_cell<3>(cell + 3 * kStripLanes, eq_lo, eq_hi, row_code, sc,
                      hm_diag, hm_up, f_up, colkey);
        cell += 4 * kStripLanes;
        qk += kStripLanes;
        row_code -= 0x00040004u;
      }
      last_hm = hm_up;
      last_f = f_up;
      const uint32_t low = 0xFFFFu - (uint32_t)j;
      best_lo = max(best_lo, (colkey << 16) | low);
      best_hi = max(best_hi, (colkey & 0xFFFF0000u) | low);
    }
  }
  // the strips' bests meet in strip 0 (their rows differ, so their keys do)
  best_lo = max(best_lo, __shfl_down_sync(kFull, best_lo, kStripLanes));
  best_hi = max(best_hi, __shfl_down_sync(kFull, best_hi, kStripLanes));
  if (strip != 0) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b = base + 2 * pp + half;
    if (b >= n) break;
    const uint32_t best = half ? best_hi : best_lo;
    const int key = (int)(best >> 16);
    const int h = key >> sc.rbits;        // a cell with H = 0 keys < 2^rbits
    score[b] = h;
    i_end[b] = h ? (1 << sc.rbits) - (key & ((1 << sc.rbits) - 1)) : 0;
    j_end[b] = h ? (int)(0xFFFFu - (best & 0xFFFFu)) : 0;
  }
}
// ---- K2 + K3 ---------------------------------------------------------------

constexpr int kAlignWarps = 4;            // warps a block, a pair a warp
constexpr int kNoMatch = 1 << 20;         // a q code >= 4: equals no w byte
constexpr int kDeadRow = -(1 << 30);      // key base of a row past `rows`

// Words in one column of a pair's direction buffer. A lane's R codes of a
// column are one word (16 bits at R = 4, 32 at R = 8), and at step t lane l
// writes word (t - l) * S + l = t * S - l * (S - 1). At R = 4, S = 3 mod 4:
// S - 1 = 2k with k odd, so the lanes' 4-byte words t * S / 2 - k * l are 32
// different banks; at R = 8, S is even and S - 1 odd, the same.
__host__ __device__ __forceinline__ int nib_stride(int lanes, int R) {
  return R == 4 ? (lanes | 3) : ((lanes + 1) & ~1);
}

// One warp's shared memory: [the walk's ref_col row, `rows` words] [w
// codes] [direction words, W columns x S], each 16-byte aligned.
template <int R>
struct AlignLayout {
  using Word = typename std::conditional<R == 4, uint16_t, uint32_t>::type;
  int S;
  size_t row_bytes, w_bytes, nib_bytes;
  __host__ __device__ AlignLayout(int rows, int W)
      : S(nib_stride((rows + R - 1) / R, R)),
        row_bytes(((size_t)rows * 4 + 15) & ~(size_t)15),
        w_bytes(((size_t)W + 15) & ~(size_t)15),
        nib_bytes(((size_t)W * S * sizeof(Word) + 15) & ~(size_t)15) {}
  __host__ __device__ size_t warp_bytes() const {
    return row_bytes + w_bytes + nib_bytes;
  }
};

struct AlignArgs {
  const int8_t* q;
  const int8_t* w;
  int32_t* score;
  int32_t* i_end;
  int32_t* j_end;
  int32_t* ref_col;
  uint8_t* dirs;       // null on the main path
  int n, L, W, rows;
  Scoring sc;
};

// A warp a pair (file comment). Lane l owns rows R*l + 1 .. R*l + R and
// does column j at step t = j - 1 + l; it takes H and F of the row above its
// strip at column j from lane l - 1, which did that column a step before,
// and keeps that H for the next step's diagonal. H and E of its own rows at
// the previous column stay in registers. The codes go to shared memory as
// [column][lane] words; after the sweep lane 0 walks them into ref_col.
template <int R>
__global__ void __launch_bounds__(kAlignWarps * 32)
sw_align_traceback_kernel(const AlignArgs a) {
  using Lay = AlignLayout<R>;
  using Word = typename Lay::Word;
  constexpr unsigned kFull = 0xFFFFFFFFu;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kAlignWarps + (threadIdx.x >> 5);
  if (b >= a.n) return;  // a whole warp leaves; below only __syncwarp
  const int rows = a.rows, L = a.L, W = a.W;
  const Scoring sc = a.sc;
  const Lay lay(rows, W);
  const int lanes = (rows + R - 1) / R;
  unsigned char* mine = smem + (threadIdx.x >> 5) * lay.warp_bytes();
  int32_t* row = reinterpret_cast<int32_t*>(mine);
  int8_t* ws = reinterpret_cast<int8_t*>(mine + lay.row_bytes);
  Word* nibs = reinterpret_cast<Word*>(mine + lay.row_bytes + lay.w_bytes);

  const int8_t* wb = a.w + (size_t)b * W;
  for (int k = lane; k < W; k += 32) ws[k] = wb[k];
  // my rows' q codes (four a load: rows and L are multiples of 4) and key
  // bases -(i * (W + 1)); a row past `rows` matches nothing and never wins
  int qc[R], kb[R];
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(a.q + (size_t)b * L);
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    const int r0 = lane * R + 4 * k;
    const uint32_t v = r0 < rows ? __ldg(q32 + (r0 >> 2)) : 0x04040404u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = static_cast<int8_t>((v >> (8 * u)) & 0xFFu);
      const int i = r0 + u + 1;
      qc[4 * k + u] = c < 4 ? c : kNoMatch;
      kb[4 * k + u] = i <= rows ? -(i * (W + 1)) : kDeadRow;
    }
  }
  int H[R], E[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    H[u] = 0;
    E[u] = sc.neg;                        // column 0: neg_inf
  }
  int best = kNone;
  uint32_t out = 0;      // (H, F) of my last row at my last column
  int diag_in = 0;       // H of the row above my strip, a column back
  __syncwarp();          // w staged
  const int steps = W + lanes - 1;
  for (int t = 0; t < steps; ++t) {
    const uint32_t in = __shfl_up_sync(kFull, out, 1);
    const int j = t - lane + 1;           // my column at this step
    if (j < 1 || j > W) continue;         // the skew fills and drains
    int hup = 0, fup = sc.neg, hdiag = 0; // row 0: the zero / neg_inf border
    if (lane > 0) {
      hup = unpack_h(in);
      fup = unpack_e(in);
      hdiag = diag_in;
      diag_in = hup;
    }
    const int wj = ws[j - 1];
    uint32_t nib = 0;
    int colkey = kNone;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      // Hopper's DPX forms: max(a + b, c) is one gap recurrence and
      // max(a, b, c, 0) is H; open wins a tie with extend
      const int e_open = H[u] - sc.go_ge;
      const int f_open = hup - sc.go_ge;
      const int diag = hdiag + (qc[u] == wj ? sc.match : sc.mismatch);
      const int e = __viaddmax_s32(E[u], -sc.ge, e_open);
      const int f = __viaddmax_s32(fup, -sc.ge, f_open);
      const int h = __vimax3_s32_relu(diag, e, f);
      const int ch = h == 0 ? 0 : (h == diag ? 1 : (h == e ? 2 : 3));
      nib |= static_cast<uint32_t>(ch | (e == e_open ? 4 : 0) |
                                   (f == f_open ? 8 : 0)) << (4 * u);
      colkey = max(colkey, h * kTie + kb[u]);
      hdiag = H[u];
      H[u] = h;
      E[u] = e;
      hup = h;
      fup = f;
    }
    out = pack_he(hup, fup);              // F >= -(gap_open + gap_extend)
    best = max(best, colkey - j);         // H * kTie - (i * (W + 1) + j)
    if (lane < lanes) nibs[(j - 1) * lay.S + lane] = static_cast<Word>(nib);
    if (a.dirs) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int i = lane * R + u + 1;
        if (i <= rows)
          a.dirs[((size_t)(i + j - 2) * rows + (i - 1)) * a.n + b] =
              static_cast<uint8_t>((nib >> (4 * u)) & 0xFu);
      }
    }
  }
  // a key is > 0 iff its cell's H is
  best = __reduce_max_sync(kFull, best);
  int s = 0, ie = 0, je = 0;
  if (best > 0) {
    s = best / kTie + 1;
    const int r = s * kTie - best;
    ie = r / (W + 1);
    je = r % (W + 1);
  }
  if (lane == 0) {
    a.score[b] = s;
    a.i_end[b] = ie;
    a.j_end[b] = je;
  }
  for (int k = lane; k < rows; k += 32) row[k] = -1;
  __syncwarp();  // every lane's codes and -1s before lane 0 reads and writes
  if (lane == 0) {
    // rambl_tpu/ops/sw.py::sw_traceback step for step: states 0 = M,
    // 1 = E, 2 = F, 3 = done; at most rows + W + 2 steps
    int i = ie, j = je;
    int st = (i > 0 && j > 0) ? 0 : 3;
    const int walk = rows + W + 2;
    for (int k = 0; k < walk && st != 3; ++k) {
      // st != 3 implies 1 <= i <= rows and 1 <= j <= W
      const int p =
          (nibs[(j - 1) * lay.S + (i - 1) / R] >> (4 * ((i - 1) % R))) & 0xF;
      const int ch = p & 0x3;
      const bool act_m = st == 0, act_e = st == 1, act_f = st == 2;
      const bool m_diag = act_m && ch == 1;
      if (m_diag) row[i - 1] = j - 1;
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
  __syncwarp();
  // the walk only reaches rows below `rows`: the rest of the row is -1
  int32_t* ref = a.ref_col + (size_t)b * L;
  for (int k = lane; k < L; k += 32) ref[k] = k < rows ? row[k] : -1;
}

template <int R>
int launch_align(const AlignArgs& a, cudaStream_t stream) {
  const size_t smem = kAlignWarps * AlignLayout<R>(a.rows, a.W).warp_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      sw_align_traceback_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + kAlignWarps - 1) / kAlignWarps;
  sw_align_traceback_kernel<R><<<blocks, kAlignWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. `rbits` is the width of the row field of the column key (file
// comment): rows <= 1 << rbits and (rows * match + 1) << rbits <= 32768.
int rambl_sw_score(const void* q, const void* w, void* score, void* i_end,
                   void* j_end, int n, int L, int W, int rows, int match,
                   int mismatch, int gap_open, int gap_extend, int rbits,
                   void* stream) {
  const size_t smem = ScoreLayout(rows).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      sw_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kScorePairs - 1) / kScorePairs;
  sw_score_kernel<<<blocks, kScoreThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(score), static_cast<int32_t*>(i_end),
      static_cast<int32_t*>(j_end), n, L, W, rows,
      make_scoring2(match, mismatch, gap_open, gap_extend, rbits));
  return (int)cudaGetLastError();
}

// K2 + K3: 4 rows a lane up to 128 rows, 8 up to 256 (the wrapper checks);
// `dirs` may be null.
int rambl_sw_align(const void* q, const void* w, void* score, void* i_end,
                   void* j_end, void* ref_col, void* dirs, int n, int L,
                   int W, int rows, int match, int mismatch, int gap_open,
                   int gap_extend, int neg, void* stream) {
  const AlignArgs a{static_cast<const int8_t*>(q),
                    static_cast<const int8_t*>(w),
                    static_cast<int32_t*>(score),
                    static_cast<int32_t*>(i_end),
                    static_cast<int32_t*>(j_end),
                    static_cast<int32_t*>(ref_col),
                    static_cast<uint8_t*>(dirs),
                    n, L, W, rows,
                    Scoring{match, mismatch, gap_open + gap_extend,
                            gap_extend, neg}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows > 128 ? launch_align<8>(a, s) : launch_align<4>(a, s);
}

}  // extern "C"
