// Helpers shared by the Smith-Waterman kernels of sw.cu and sw_variants.cu:
// the packed (H, E) column word, the best-cell key and its decode.
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

// best = s * kTie - pos with 0 < pos < kTie and s >= 1, so best > 0 and
// best / kTie == s - 1.
__device__ __forceinline__ void decode_best(int best, int W, int b,
                                            int32_t* score, int32_t* i_end,
                                            int32_t* j_end) {
  if (best == kNone) {
    score[b] = 0;
    i_end[b] = 0;
    j_end[b] = 0;
    return;
  }
  const int s = best / kTie + 1;
  const int r = s * kTie - best;
  score[b] = s;
  i_end[b] = r / (W + 1);
  j_end[b] = r % (W + 1);
}

}  // namespace
