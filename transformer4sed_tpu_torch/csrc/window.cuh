// Pieces shared by the Swin window-attention forward and backward kernels.
//
// One (window, head) pair is a 64 x 64 x 24 problem: 64 tokens of an 8 x 8
// window, head dim 24 in every HTSAT stage. A block of 4 warps takes it, each
// warp 16 query rows, with mma.sync m16n8k16. 24 is not a multiple of the
// k step of 16, so the row-major tiles that feed a product over the head dim
// (Q K^T, dO V^T) are staged in shared memory 32 lanes wide with lanes 24..31
// zeroed: no lane of the neighbouring head is ever read. As an n dimension
// (P V, dV, dQ, dK) 24 is three 8-wide tiles.
#pragma once

#include "mma.cuh"

namespace t4s {

constexpr int WA_N = 64;          // tokens of a window
constexpr int WA_D = 24;          // head dim
constexpr int WA_WARPS = 4;
constexpr int WA_THREADS = 32 * WA_WARPS;
constexpr int WA_LD = 40;         // row-major [64][24 -> 32] tiles, +8 against bank conflicts
constexpr int WA_LDT = WA_N + 8;  // transposed [24][64] tiles and [64][64] P^T / dS^T tiles

// Zero lanes 24..31 of a row-major tile: one 16-byte store per row.
__device__ __forceinline__ void zero_pad_lanes(bf16* tile) {
  for (int r = threadIdx.x; r < WA_N; r += WA_THREADS)
    *reinterpret_cast<uint4*>(tile + r * WA_LD + WA_D) = make_uint4(0u, 0u, 0u, 0u);
}

// This warp's 16 rows (r0, r0 + 8 per thread) of
//   S = scale * Q K^T + bias[h] + shift[w mod nW]
// from the staged row-major Q and K tiles; bias_h and shift_w point at the
// [64][64] f32 slices (shift_w may be null: no shifted windows).
__device__ __forceinline__ void window_scores(float (&s)[WA_N / 8][4], const bf16* sQ,
                                              const bf16* sK, const float* __restrict__ bias_h,
                                              const float* __restrict__ shift_w, int r0, int g,
                                              int t, float scale) {
  uint32_t qf[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qf[kk][0] = ld_b32(&sQ[r0 * WA_LD + c0]);
    qf[kk][1] = ld_b32(&sQ[(r0 + 8) * WA_LD + c0]);
    qf[kk][2] = ld_b32(&sQ[r0 * WA_LD + c0 + 8]);
    qf[kk][3] = ld_b32(&sQ[(r0 + 8) * WA_LD + c0 + 8]);
  }
#pragma unroll
  for (int nt = 0; nt < WA_N / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const bf16* kr = &sK[(nt * 8 + g) * WA_LD + 2 * t];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma_16816(s[nt], qf[kk], ld_b32(kr + kk * 16), ld_b32(kr + kk * 16 + 8));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (r0 + 8 * r) * WA_N + nt * 8 + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(bias_h + off);
      float s0 = s[nt][2 * r] * scale + b.x, s1 = s[nt][2 * r + 1] * scale + b.y;
      if (shift_w != nullptr) {
        const float2 m = *reinterpret_cast<const float2*>(shift_w + off);
        s0 += m.x;
        s1 += m.y;
      }
      s[nt][2 * r] = s0;
      s[nt][2 * r + 1] = s1;
    }
  }
}

// In place s -> exp(s - rowmax); l = the two rows' sums. The scores are
// finite (the shift mask is -100, not -inf), so no row is empty.
__device__ __forceinline__ void window_softmax(float (&s)[WA_N / 8][4], float (&l)[2]) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < WA_N / 8; ++nt) {
    m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
    m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < WA_N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f((s[nt][e] - m[e >> 1]) * 1.4426950408889634f);
      s[nt][e] = p;
      l[e >> 1] += p;
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// The A operand (16 rows x 16 keys, slice kk) of a product over keys, from a
// warp's f32 row tile rounded to bf16: the C layout of two neighbouring 16x8
// tiles is the A layout of one 16x16 slice.
__device__ __forceinline__ void rows_to_a(uint32_t (&a)[4], const float (&x)[WA_N / 8][4],
                                          int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// Two rows (r0, r0 + 8) of a warp's [16][24] f32 result, times `mul[r]`, to a
// bf16 [.., 24] row-major destination whose row r0 starts at `dst` with row
// stride `rs`; this thread owns lanes dt * 8 + 2t, +1.
__device__ __forceinline__ void store_rows(bf16* dst, long long rs, const float (&x)[WA_D / 8][4],
                                           const float (&mul)[2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = dst + (long long)(8 * r) * rs + 2 * t;
#pragma unroll
    for (int dt = 0; dt < WA_D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack_bf16(x[dt][2 * r] * mul[r], x[dt][2 * r + 1] * mul[r]);
  }
}

}  // namespace t4s
