// Flash attention forward on mma.sync for Hopper (sm_90a): the device code
// of the biased entry point (flash_attention_bias.cu, row 4) and the
// experiment's variants (flash_variants.cu, row 16). Rows 1, 3, 5 and 7 run
// on flash_fwd.cuh's wgmma body.
//
//   softmax(scale * Q K^T [+ bias]) V  per (batch, head)
// Every operand comes as a base pointer with batch, head and row strides
// (Rows, mma.cuh), so a [B, N, H*d] projection slice (head stride d) and a
// [B, H, T, d] tensor, contiguous or a strided view of a [B, T, 3*H*d]
// projection, are the same to the kernel. HD is the head dim, a multiple of
// 16; 32 and 64 are built.
//
// What bounds it: the two products are 4*T^2*d operations per (batch, head)
// against 4*T*d*2 bytes of q/k/v/o, about T/2 operations per byte: at
// T = 1190 some 600, above the H100's ~295 FLOP/byte ridge for d = 32 as for
// d = 64, so the tensor cores bound it (row 4's f32 bias read brings it below
// the ridge: flash_attention_bias.cu).
// Design: scores and probabilities never leave registers. One block of
// 4 warps owns 64 query rows of one (batch, head); each warp keeps its
// 16 rows' Q fragments in registers and runs mma.sync m16n8k16 (bf16 in,
// f32 accumulate) over 64-key K/V tiles staged in shared memory, with an
// f32 online softmax (exp2, running max and sum per row). The ragged key
// tail (T = 1190 is not a multiple of 64) is masked to -inf in-kernel; no
// operand is padded or copied. This is the plain first version: no TMA,
// no wgmma, no double buffering of the K/V tiles. The shared-memory pitch
// HD + 8 keeps the fragment loads conflict-free at HD = 32 (20-word rows) as
// at 64 (36-word rows).
#pragma once

#include "mma.cuh"

namespace t4s {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 128;
constexpr int FA_MIN_BLOCKS = 4;  // row 16: 65536 registers / (4 * 128 threads) = 128 each
constexpr int FA_PAD = 8;

// What the scores get besides scale * q.k, chosen at compile time:
//   FA_BIAS:       the ragged key tail masked element by element in every
//                  tile, plus an f32 bias element read from global memory
//                  (row 4, flash_attention_bias.cu);
//   FA_TAIL_EXP2:  the ragged key tail masked in the last tile only (row 16,
//                  flash_variants.cu, variant B: exp2 with log2(e) folded
//                  into the scale);
//   FA_TAIL_EXP:   the same with the natural exp (variant A).
enum FaScores { FA_BIAS, FA_TAIL_EXP2, FA_TAIL_EXP };

template <int MODE>
__device__ __forceinline__ float fa_exp(float x) {
  if constexpr (MODE == FA_TAIL_EXP) return expf(x);
  return exp2f(x);
}

template <int HD>
__host__ __device__ constexpr int fa_smem_bytes() {
  return (2 * FA_BQ * (HD + FA_PAD) + HD * (FA_BK + FA_PAD)) * sizeof(bf16);
}

// One block's 64 query rows of one (batch, head). `scale` is in the exp's
// domain: sm_scale * log2(e) for exp2, sm_scale for FA_TAIL_EXP. bias (FA_BIAS
// only) is read in the exp2 domain as bias * log2(e).
template <int HD, int MODE>
__device__ __forceinline__ void flash_fwd_body(unsigned char* smem, Rows<const bf16> q,
                                               Rows<const bf16> k, Rows<const bf16> v,
                                               Rows<bf16> o, Rows<const float> bias, int n,
                                               float scale) {
  constexpr int LD = HD + FA_PAD;      // pitch of the Q and K tiles
  constexpr int LDV = FA_BK + FA_PAD;  // pitch of the transposed V tile
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + FA_BQ * LD;
  bf16* sVt = sK + FA_BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k.at(b, h);
  const bf16* vb = v.at(b, h);

  load_rows<HD, FA_THREADS>(sQ, LD, q.at(b, h) + (long long)i0 * q.rs, q.rs, FA_BQ, n - i0);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qf[kk][0] = ld_b32(&sQ[r0 * LD + c0]);
    qf[kk][1] = ld_b32(&sQ[(r0 + 8) * LD + c0]);
    qf[kk][2] = ld_b32(&sQ[r0 * LD + c0 + 8]);
    qf[kk][3] = ld_b32(&sQ[(r0 + 8) * LD + c0 + 8]);
  }
  // FA_BIAS: this thread's two bias rows (rows past n read row n - 1; their
  // outputs are never written)
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (MODE == FA_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias.at(b, h) + (long long)min(i0 + r0 + 8 * r, n - 1) * bias.rs + 2 * t;
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j0 = 0; j0 < n; j0 += FA_BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD, FA_THREADS>(sK, LD, kb + (long long)j0 * k.rs, k.rs, FA_BK, n - j0);
    load_rows_transposed<HD, FA_THREADS>(sVt, LDV, vb + (long long)j0 * v.rs, v.rs, FA_BK,
                                         n - j0);
    // FA_BIAS: the tile's bias elements in the score fragments' layout, read
    // while the tiles land: each warp load covers 8 rows of 32 bytes
    float bs[MODE == FA_BIAS ? FA_BK / 8 : 1][4];
    if constexpr (MODE == FA_BIAS) {
#pragma unroll
      for (int nt = 0; nt < FA_BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + nt * 8 + 2 * t + (e & 1);
          bs[nt][e] = col < n ? brow[e >> 1][j0 + nt * 8 + (e & 1)] * 1.4426950408889634f : 0.f;
        }
      }
    }
    __syncthreads();

    float s[FA_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = &sK[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_16816(s[nt], qf[kk], ld_b32(kr + kk * 16), ld_b32(kr + kk * 16 + 8));
    }

    // scale into the exp's domain, add the bias, mask the ragged key tail
    // (every tile, or the last one only), row maxima
    const bool ragged = j0 + FA_BK > n;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + 2 * t + (e & 1);
        if constexpr (MODE == FA_BIAS)
          s[nt][e] = col < n ? s[nt][e] * scale + bs[nt][e] : -INFINITY;
        else
          s[nt][e] = !ragged || col < n ? s[nt][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // rows with no valid key yet
      alpha[r] = fa_exp<MODE>(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fa_exp<MODE>(s[nt][e] - base[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V, P straight from the score registers (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const bf16* vr = &sVt[(dt * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld_b32(vr), ld_b32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + r0 + 8 * r;
    if (row >= n) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    bf16* orow = o.at(b, h) + (long long)row * o.rs;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

}  // namespace t4s
