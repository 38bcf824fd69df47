// Helpers shared by the Smith-Waterman kernels of sw.cu and sw_variants.cu:
// the packed (H, E) column word, the best-cell key and its decode (K2 + K3),
// and the packed 16-bit DPX cell of K1's design (K1, and the strip kernel of
// S1 and S2): the scoring constants in both halves of a word, the remap and
// byte-equality masks of staged codes, and one cell of two pairs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTie = 32768;
constexpr int kNone = -(1 << 30);
constexpr int kEBorder = -32768;  // INT16_MIN: stands for neg_inf at j = 0

struct Scoring {
  int match, mismatch, go_ge, ge, neg;
};

// H <= rows * match < 2^15 and E >= -(gap_open + gap_extend) once j >= 1, so
// H and E share one 32-bit word, E in the high half (wrappers check both).
__device__ __forceinline__ uint32_t pack_he(int h, int e) {
  return (static_cast<uint32_t>(e) << 16) | (static_cast<uint32_t>(h) & 0xFFFFu);
}

__device__ __forceinline__ int unpack_h(uint32_t v) {
  return static_cast<int>(v & 0xFFFFu);
}

__device__ __forceinline__ int unpack_e(uint32_t v) {
  return static_cast<int>(v) >> 16;  // arithmetic shift keeps the sign
}

constexpr int kBorder16 = -16384;         // stands for neg_inf (sw.cu, file comment)
constexpr uint32_t kMin2 = 0x80008000u;   // INT16_MIN twice: max()'s identity

__host__ __device__ __forceinline__ uint32_t pack2(int x) {
  return (static_cast<uint32_t>(x) & 0xFFFFu) * 0x10001u;
}

// The scoring constants, each in both halves of a word.
struct Scoring2 {
  uint32_t mismatch_open;  // mismatch + gap_open + gap_extend
  uint32_t match_delta;    // the same for a match, XOR mismatch_open
  uint32_t neg_extend;     // -gap_extend
  uint32_t neg_open;       // -(gap_open + gap_extend)
  uint32_t key_mul;        // 1 << rbits: the row bits of the column key
  int rbits;
};

__host__ __forceinline__ Scoring2 make_scoring2(int match, int mismatch,
                                                int gap_open, int gap_extend,
                                                int rbits) {
  const int open = gap_open + gap_extend;
  return Scoring2{pack2(mismatch + open),
                  pack2(mismatch + open) ^ pack2(match + open),
                  pack2(-gap_extend), pack2(-open), 1u << rbits, rbits};
}

// Four int8 codes in a word: a code >= 4 becomes `sentinel`.
__device__ __forceinline__ uint32_t remap4(uint32_t v, int sentinel) {
  uint32_t r = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = static_cast<int8_t>((v >> (8 * u)) & 0xFFu);
    r |= static_cast<uint32_t>((c < 4 ? c : sentinel) & 0xFF) << (8 * u);
  }
  return r;
}

// Bit 7 of each byte is set iff that byte of a equals that byte of b (the
// other bits mean nothing).
__device__ __forceinline__ uint32_t equal_bits(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
}

// prmt with a constant selector; a selector nibble n | 8 spreads the sign
// bit of byte n over the result byte.
template <uint32_t kSel>
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "n"(kSel));
  return d;
}

// One DP cell of both pairs: row kRow of the four whose equality bits are
// in eq_lo / eq_hi. `cell` is the column state of this row (H - open, E).
template <int kRow>
__device__ __forceinline__ void score_cell(uint2* cell, uint32_t eq_lo,
                                           uint32_t eq_hi, uint32_t row_code,
                                           const Scoring2& sc,
                                           uint32_t& hm_diag, uint32_t& hm_up,
                                           uint32_t& f_up, uint32_t& colkey) {
  constexpr uint32_t kLo = kRow | 8, kHi = (kRow + 4) | 8;
  const uint2 left = *cell;                         // (H - open, E)(i, j - 1)
  const uint32_t e = __viaddmax_s16x2(left.y, sc.neg_extend, left.x);
  const uint32_t match =
      prmt<kLo | (kLo << 4) | (kHi << 8) | (kHi << 12)>(eq_lo, eq_hi);
  const uint32_t sub = sc.mismatch_open ^ (match & sc.match_delta);
  const uint32_t diag = __viaddmax_s16x2(hm_diag, sub, kMin2);
  const uint32_t f = __viaddmax_s16x2(f_up, sc.neg_extend, hm_up);
  const uint32_t h = __vimax3_s16x2_relu(diag, e, f);
  const uint32_t hm = __viaddmax_s16x2(h, sc.neg_open, kMin2);
  *cell = make_uint2(hm, e);
  // (H << rbits) + (2^rbits - i): both halves stay below 2^15, so the
  // 32-bit multiply-add carries nothing across
  colkey = __viaddmax_s16x2(h * sc.key_mul + row_code, pack2(-kRow), colkey);
  hm_diag = left.x;
  hm_up = hm;
  f_up = f;
}

}  // namespace
