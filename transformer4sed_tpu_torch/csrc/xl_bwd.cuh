// Fused Transformer-XL attention backward for Hopper (sm_90a): the device code
// of xl_attention_bwd.cu's entry point, for the heads-in-lanes layout (row 13)
// and the head-major one (row 11), with the two passes around it.
//
// With the forward's saved output O and row log-sum-exp L, and
// delta = rowsum(dO * O):
//   S[i,j]  = scale * (qu_i . k_j + qv_i . P[T-1-i+j])     (band-masked)
//   A       = exp(S - L),  dS = A * (dO V^T - delta)       (dS rounded to bf16)
//   dV      = A^T dO                                       (A rounded to bf16)
//   dK      = scale * dS^T qu
//   dQu_i   = scale * sum_j dS[i,j] k_j
//   dQv_i   = scale * sum_j dS[i,j] P[T-1-i+j]
//   dP[m]   = scale * sum_{(i,j): T-1-i+j = m} dS[i,j] qv_i   (summed over batch)
// Every operand is a [B, H, T, d] view with its own batch, head and row
// strides (Rows, mma.cuh), P a [H, 2T-1, d] view. HD is the head dim: 64
// (rows 13 and 11) and 32 (row 11) are built.
//
// What bounds it: eight products of 2*T^2*d per (batch, head) (content and
// position scores, dO V^T, dV, dK, dQu, dQv, dP), 295 GFLOP at B=24, T=1000,
// H=12, d=64, against ~160 MB of operands and results: 0.298 ms at the
// H100's 989 TFLOP/s, far above its ~295 FLOP/byte ridge, so the tensor cores
// bound it (at d = 32 as at d = 64).
//
// Design.
// * The pre-pass (xl_bwd_prepass_kernel) reads dO and O once and writes per
//   query row (L * log2 e, delta) to a side buffer [B, H, T_pad, 2] (+inf
//   for a padded row and where L is -inf, so its A is 0 without a test), as
//   flash_bwd.cuh's does; it zeroes the f32 workspaces, and for row 13 forms
//   qu = bf16(q + u) and qv = bf16(q + v) once, [B, H, T, d] contiguous, so
//   that both rows run one main kernel on TMA operands.
// * The main kernel runs one block per (128-key tile, head, batch): two
//   consumer warpgroups of 64 keys each and a producer warpgroup, one thread
//   of which issues every copy. It loads K and V once and streams 64-row
//   query steps of qu, qv and dO (TMA, 4-D maps over (d, heads, rows, batch)
//   whose out-of-bounds fill zeroes the ragged tail) with their side rows
//   through two stages, each guarded by a full and an empty mbarrier.
// * The rel-shift. For query rows i0..i0+63 and keys j0..j0+127 the P rows
//   T-1-i+j form one strip of 191 rows from s0 = T - i0 - 64 + j0. The
//   producer loads it as 64-row pieces by TMA into a ring of four (the
//   strips of consecutive steps overlap by 128 rows, so each piece is loaded
//   once a block, with the step that first needs it); a start below 0 or an
//   end past 2T-1 reads as zeros (TMA's out-of-bounds fill), and such rows
//   meet only masked pairs. Each consumer computes G = (its 128 strip rows)
//   qv^T by wgmma into f32 registers, writes G to its own shared buffer
//   (pitch 72 floats) and reads the position score of (key jw, query il) at
//   G[63 - il + jw][il] onto S^T. Scores stay f32.
// * As flash_bwd.cuh: S^T = K qu^T and dP^T = V dO^T by wgmma from shared
//   memory, A^T and dS^T in the accumulator registers (the MUFU's
//   ex2.approx), dV += A^T dO and dK += dS^T qu with A from those registers
//   rounded to bf16 and B the same tiles read MN-major.
// * dS^T goes to shared memory once as is (stmatrix, for dQu = dS K) and once
//   skewed, D[il][63 - il + jl] = dS[il][jl], a [64 x 192] bf16 matrix in
//   three swizzled tiles whose two triangles stay zero (zeroed once; every
//   step rewrites the band). Then dQv = D P_strip and the strip's dP = D^T qv
//   are plain wgmma products from shared memory: D read K-major for the one,
//   MN-major for the other. Each warpgroup computes d/2 columns of dQu, dQv
//   and dP.
// * No atomics. The dQ partials (row 13: dQu + dQv, with their column sums
//   kept apart for dbu and dbv; row 11: dQu and dQv) are staged in f32 and
//   added to the workspace by one TMA reduction a box. dP is carried in the
//   accumulator registers: the strip's 64 rows that no later step reaches are
//   added to the dP workspace by one TMA reduction, the other 128 become the
//   next step's, and the last two pieces are added after the last step. The
//   staging boxes live in the warpgroup's G buffer, free once the scores are
//   read.
// * The post-pass (xl_bwd_postpass_kernel) writes dq (row 13; dqu and dqv for
//   row 11) and dP in bf16, scaled, through the caller's strides, and for row
//   13 dbu and dbv in f32, each the sum of the blocks' column sums.
// Shared memory is the constraint: 226 KB at d = 64 (K, V 32; two stages of
// qu, qv, dO 48; four pieces 32; G of both warpgroups 72; dS^T 16; D 24; side
// rows 1), one block an SM. 384 threads start with 168 registers; setmaxnreg
// moves the producer warpgroup to 40 and the consumers to 232.
#pragma once

#include "hopper.cuh"

namespace t4s {

constexpr int XB_KEYS = 128;                    // keys per block
constexpr int XB_QROWS = 64;                    // query rows per step
constexpr int XB_STAGES = 2;                    // query steps in flight
constexpr int XB_PIECES = 4;                    // 64-row strip pieces in the ring
constexpr int XB_CONSUMERS = 256;               // two warpgroups
constexpr int XB_THREADS = XB_CONSUMERS + 128;  // and the producer warpgroup
constexpr int XB_PRODUCER_REGS = 40;            // 128 * 40 + 256 * 232 = 384 * 168
constexpr int XB_CONSUMER_REGS = 232;
constexpr int XB_SIDE_BYTES = XB_QROWS * 2 * 4;      // (L * log2 e, delta) per row
constexpr int XB_DS_BYTES = XB_KEYS * XB_QROWS * 2;  // dS^T [128 keys][64 queries] bf16
constexpr int XB_D_TILE = XB_QROWS * 64 * 2;         // D [64 queries][64 strip rows] bf16
constexpr int XB_GP = 72;                            // pitch (floats) of a G buffer
constexpr int XB_G_BYTES = 128 * XB_GP * 4;          // 128 strip rows x 64 queries, f32
constexpr int XB_PAD = 64;                           // dP workspace rows before P row 0
constexpr float XB_LOG2E = 1.4426950408889634f;

// Planted faults, for the kernel check only (0 on every real path): the last
// key tile's dQ partial left out, the strip pieces' start clamped at row 0
// instead of zero-filled, the dP carry of the last step never added.
enum XbFault { XB_FAULT_NONE = 0, XB_FAULT_SKIP_DQ_TILE, XB_FAULT_CLAMP_STRIP, XB_FAULT_NO_FLUSH };

template <int HD>
struct XbSmem {
  static constexpr int ROW = HD * 2;  // bytes of one tile row
  static constexpr int KV_TILE = XB_KEYS * ROW;
  static constexpr int Q_TILE = XB_QROWS * ROW;  // also one strip piece
  static constexpr int BOX = XB_QROWS * HD / 2 * 4;  // one f32 staging box [64][d/2]
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_TILE;
  static constexpr int QU_OFF = V_OFF + KV_TILE;
  static constexpr int QV_OFF = QU_OFF + XB_STAGES * Q_TILE;
  static constexpr int DO_OFF = QV_OFF + XB_STAGES * Q_TILE;
  static constexpr int P_OFF = DO_OFF + XB_STAGES * Q_TILE;
  static constexpr int G_OFF = P_OFF + XB_PIECES * Q_TILE;  // both warpgroups' G and staging
  static constexpr int DS_OFF = G_OFF + 2 * XB_G_BYTES;
  static constexpr int D_OFF = DS_OFF + XB_DS_BYTES;
  static constexpr int SIDE_OFF = D_OFF + 3 * XB_D_TILE;
  static constexpr int BAR_OFF = SIDE_OFF + XB_STAGES * XB_SIDE_BYTES;
  // kv_full, full[XB_STAGES], empty[XB_STAGES]; then slack to align the base to 1024
  static constexpr int BYTES = BAR_OFF + (1 + 2 * XB_STAGES) * 8 + 1024;
  static_assert(3 * BOX <= XB_G_BYTES, "the staging boxes fit in a G buffer");
};

// SUMQ (row 13): dQu + dQv to one workspace [B, H, T_pad, d], their column
// sums to colsum [B, H, n_kt, 2, d]; without (row 11): dQu and dQv to the two
// halves of the workspace [B, H, T_pad, 2d]. dP goes to dp_acc [H, ndp, d],
// P row m at row XB_PAD + m. Every workspace holds unscaled sums.
template <int HD, bool SUMQ>
__global__ void __launch_bounds__(XB_THREADS, 1)
xl_bwd_kernel(const __grid_constant__ CUtensorMap tqu, const __grid_constant__ CUtensorMap tqv,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tp,
              const __grid_constant__ CUtensorMap tdq, const __grid_constant__ CUtensorMap tdp,
              const float* __restrict__ side, const int* __restrict__ band,
              float* __restrict__ colsum, Rows<bf16> dk, Rows<bf16> dv, int n, int ndp, int fault,
              float scale, float scale_log2) {
  using namespace hopper;
  using L = XbSmem<HD>;
  constexpr int ROW = L::ROW;
  constexpr uint64_t SW = HD == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  static_assert(HD == 64 || HD == 32, "head dims 32 and 64 are built");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + XB_STAGES;

  const int kt = blockIdx.x, j0 = kt * XB_KEYS, h = blockIdx.y, b = blockIdx.z;
  const int nq = (n + XB_QROWS - 1) / XB_QROWS, n_pad = nq * XB_QROWS;
  const long long bh = (long long)b * gridDim.y + h;
  // strip piece q holds P rows [strip0 - 64 q, strip0 - 64 q + 64); step it
  // reads pieces it + 2, it + 1, it as its strip rows 0-63, 64-127, 128-191
  const int strip0 = n + 64 + j0;
  const int dp_row0 = h * ndp + XB_PAD + strip0;  // dP workspace row of piece 0
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < XB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  // D's two triangles are zero from here on: every step rewrites only its band
  for (int i = threadIdx.x; i < 3 * XB_D_TILE / 16; i += XB_THREADS)
    reinterpret_cast<uint4*>(smem + L::D_OFF)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= XB_CONSUMERS / 32) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<XB_PRODUCER_REGS>();
    if (warp == XB_CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_TILE);
      tma_load_4d(smem + L::K_OFF, &tk, kv_full, 0, h, j0, b);
      tma_load_4d(smem + L::V_OFF, &tv, kv_full, 0, h, j0, b);
      for (int it = 0; it < nq; ++it) {
        const int s = it % XB_STAGES;
        // a stage is free once its step is done, and so is the ring slot of
        // that step's oldest piece, it - 2 (slot (it + 2) % 4)
        if (it >= XB_STAGES) mbar_wait(&empty[s], (it / XB_STAGES - 1) & 1);
        const int first = it == 0 ? 0 : it + 2;  // pieces 0, 1, 2 with step 0, then it + 2
        mbar_expect_tx(&full[s], 3 * L::Q_TILE + XB_SIDE_BYTES + (it + 3 - first) * L::Q_TILE);
        tma_load_4d(smem + L::QU_OFF + s * L::Q_TILE, &tqu, &full[s], 0, h, it * XB_QROWS, b);
        tma_load_4d(smem + L::QV_OFF + s * L::Q_TILE, &tqv, &full[s], 0, h, it * XB_QROWS, b);
        tma_load_4d(smem + L::DO_OFF + s * L::Q_TILE, &tdo, &full[s], 0, h, it * XB_QROWS, b);
        bulk_load(smem + L::SIDE_OFF + s * XB_SIDE_BYTES,
                  side + (bh * n_pad + (long long)it * XB_QROWS) * 2, XB_SIDE_BYTES, &full[s]);
        for (int q = first; q <= it + 2; ++q) {
          int row = strip0 - 64 * q;
          if (fault == XB_FAULT_CLAMP_STRIP) row = max(row, 0);
          tma_load_4d(smem + L::P_OFF + (q % XB_PIECES) * L::Q_TILE, &tp, &full[s], 0, h, row, 0);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: keys wg*64 .. wg*64+63 of the block, d/2 columns of
  // the dQ and dP products
  setmaxnreg_inc<XB_CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;  // issues the warpgroup's reductions
  const unsigned char* sK = smem + L::K_OFF;
  const unsigned char* sKw = sK + wg * 64 * ROW;
  const unsigned char* sVw = smem + L::V_OFF + wg * 64 * ROW;
  float* sG = reinterpret_cast<float*>(smem + L::G_OFF + wg * XB_G_BYTES);
  float* box_a = sG;  // staging boxes inside the G buffer
  float* box_b = sG + L::BOX / 4;
  float* box_p = sG + 2 * L::BOX / 4;
  unsigned char* sDS = smem + L::DS_OFF;
  unsigned char* sD = smem + L::D_OFF;
  const unsigned char* sP = smem + L::P_OFF;
  const int jw0 = wl * 16 + g;  // this thread's keys in the warpgroup: jw0, jw0 + 8
  const int key0 = j0 + wg * 64 + jw0;
  const bool key_ok[2] = {key0 < n, key0 + 8 < n};
  const int half = band != nullptr ? band[h] / 2 : -1;  // -1: no band
  const bool last_tile = kt == (int)gridDim.x - 1;

  float dk_acc[HD / 2], dv_acc[HD / 2], c1[HD / 4], c2[HD / 4], cu[HD / 8], cv[HD / 8];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) c1[i] = c2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) cu[i] = cv[i] = 0.f;

  mbar_wait(kv_full, 0);
  __syncwarp();
  for (int it = 0; it < nq; ++it) {
    const int s = it % XB_STAGES, i0 = it * XB_QROWS;
    const unsigned char* sQu = smem + L::QU_OFF + s * L::Q_TILE;
    const unsigned char* sQv = smem + L::QV_OFF + s * L::Q_TILE;
    const unsigned char* sdO = smem + L::DO_OFF + s * L::Q_TILE;
    const float* sSide = reinterpret_cast<const float*>(smem + L::SIDE_OFF + s * XB_SIDE_BYTES);
    mbar_wait(&full[s], (it / XB_STAGES) & 1);
    __syncwarp();  // converged again for the .sync.aligned wgmma instructions

    // G = (strip rows 64 wg .. 64 wg + 127) qv^T, to this warpgroup's buffer
    {
      float gacc[2][32];
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const unsigned char* pc = sP + ((it + 2 - wg - mb) % XB_PIECES) * L::Q_TILE;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<0, 0>(gacc[mb], desc(pc + kk * 32, 8 * ROW, SW),
                         desc(sQv + kk * 32, 8 * ROW, SW), kk);
      }
      wgmma_commit();
      if (issuer) bulk_wait_read<0>();  // the last step's reductions have read the staging
      wgmma_wait<0>();
      fence_regs(gacc[0]);
      fence_regs(gacc[1]);
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(sG + (mb * 64 + jw0 + 8 * r) * XB_GP + 8 * j + 2 * t) =
                make_float2(gacc[mb][4 * j + 2 * r], gacc[mb][4 * j + 2 * r + 1]);
    }

    // S^T = K qu^T and dP^T = V dO^T: 64 keys x 64 queries, K-major operands
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(st, desc(sKw + kk * 32, 8 * ROW, SW), desc(sQu + kk * 32, 8 * ROW, SW), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(dpt, desc(sVw + kk * 32, 8 * ROW, SW), desc(sdO + kk * 32, 8 * ROW, SW),
                     kk);
    wgmma_commit();
    bar_sync(2 + wg, 128);  // G is complete
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // A^T = exp2(scale log2e (S^T + the skewed G) - L2), dS^T = A^T (dP^T - delta);
    // keys past n and outside the band weigh 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 ld = *reinterpret_cast<const float4*>(sSide + 2 * (8 * j + 2 * t));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * t + (e & 1), jw = jw0 + 8 * (e >> 1);
        const float pos = sG[(63 - il + jw) * XB_GP + il];
        bool ok = key_ok[e >> 1];
        if (half >= 0) {
          const int row = i0 + il, col = key0 + 8 * (e >> 1);
          ok = ok && ((col >= row - half && col < row + half) || col == row);
        }
        const float l2 = (e & 1) ? ld.z : ld.x;
        const float dl = (e & 1) ? ld.w : ld.y;
        const int i = 4 * j + e;
        const float a = ok ? ex2_approx((st[i] + pos) * scale_log2 - l2) : 0.f;
        st[i] = a;
        dpt[i] = a * (dpt[i] - dl);
      }
    }
    uint32_t pa[4][4], sa[4][4];
    acc_to_a(st, pa);
    acc_to_a(dpt, sa);

    // dV += A^T dO, dK += dS^T qu: A from registers, B (dO, qu) read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dv_acc, pa[kk], desc(sdO + kk * 16 * ROW, 8 * ROW, SW), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dk_acc, sa[kk], desc(sQu + kk * 16 * ROW, 8 * ROW, SW), 1);
    wgmma_commit();

    bar_sync(1, XB_CONSUMERS);  // both warpgroups are done with the last step's dS^T and D
    {
      // dS^T [128 keys][64 queries], 128-byte swizzle (stmatrix)
      const int mi = lane >> 3, r = lane & 7;  // this lane's row r of matrix mi
      const uint32_t row = smem_u32(sDS) + (wg * 64 + wl * 16 + (mi & 1) * 8 + r) * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) stmatrix_x4(row + (((2 * kk + (mi >> 1)) ^ r) << 4), sa[kk]);
      // dS skewed, D[il][63 - il + jl], one bf16 a store. sa[kk][e] holds
      // dS^T[jw0 + 8 (e & 1)][il, il + 1], il = 16 kk + 8 (e >> 1) + 2t (+ odd):
      // strip row 63 - il + jl is a constant of the thread and of il's parity
      // plus 8 ((e & 1) - 2 kk - (e >> 1)), so only its 16-byte chunk moves
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int r = 63 - 2 * t - odd + wg * 64 + jw0, c0 = r >> 3, x = (2 * t + odd) & 7;
        unsigned char* row = sD + (2 * t + odd) * 128 + (r & 7) * 2;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + (e & 1) - 2 * kk - (e >> 1);  // the strip row's chunk
            const int at = (c >> 3) * XB_D_TILE + (16 * kk + 8 * (e >> 1)) * 128;
            *reinterpret_cast<uint16_t*>(row + at + (((c & 7) ^ x) << 4)) =
                static_cast<uint16_t>(sa[kk][e] >> (16 * odd));
          }
      }
    }
    fence_proxy_async();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(sa);
    bar_sync(1, XB_CONSUMERS);  // dS^T and D are complete

    // this warpgroup's d/2 columns of dQu = dS K (dS^T and K read MN-major),
    // dQv = D P_strip (D K-major, the pieces MN-major) and the strip's
    // dP = D^T qv (D and qv MN-major): strip rows 0-63 fresh, 64-191 onto the carry
    float dq_u[HD / 4], dq_v[HD / 4], n0[HD / 4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < XB_KEYS / 16; ++kk)
      wgmma_ss<1, 1>(dq_u, desc(sDS + kk * 16 * 128, 1024, SWIZZLE_128B),
                     desc(sK + kk * 16 * ROW + wg * HD, 8 * ROW, SW), kk);
#pragma unroll
    for (int kk = 0; kk < 12; ++kk)
      wgmma_ss<0, 1>(dq_v, desc(sD + (kk >> 2) * XB_D_TILE + (kk & 3) * 32, 1024, SWIZZLE_128B),
                     desc(sP + ((it + 2 - (kk >> 2)) % XB_PIECES) * L::Q_TILE +
                              (kk & 3) * 16 * ROW + wg * HD,
                          8 * ROW, SW),
                     kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(n0, desc(sD + kk * 16 * 128, 1024, SWIZZLE_128B),
                     desc(sQv + kk * 16 * ROW + wg * HD, 8 * ROW, SW), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(c1, desc(sD + XB_D_TILE + kk * 16 * 128, 1024, SWIZZLE_128B),
                     desc(sQv + kk * 16 * ROW + wg * HD, 8 * ROW, SW), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(c2, desc(sD + 2 * XB_D_TILE + kk * 16 * 128, 1024, SWIZZLE_128B),
                     desc(sQv + kk * 16 * ROW + wg * HD, 8 * ROW, SW), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_u);
    fence_regs(dq_v);
    fence_regs(n0);
    fence_regs(c1);
    fence_regs(c2);
    if (issuer) mbar_arrive(&empty[s]);  // qu, qv, dO, side rows and piece it consumed

    // stage and add: dQ (row 13: dQu + dQv, their column sums kept; row 11:
    // both), and strip rows 128-191 (piece it), which no later step reaches
    if (SUMQ) {
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) {
        cu[(i >> 2) * 2 + (i & 1)] += dq_u[i];
        cv[(i >> 2) * 2 + (i & 1)] += dq_v[i];
        dq_u[i] += dq_v[i];
      }
    } else {
      stage_box<HD>(box_b, dq_v, wl, g, t);
    }
    stage_box<HD>(box_a, dq_u, wl, g, t);
    stage_box<HD>(box_p, c2, wl, g, t);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (issuer) {
      if (!(fault == XB_FAULT_SKIP_DQ_TILE && last_tile)) {
        const int qrow = (int)(bh * n_pad) + i0;
        tma_reduce_add_2d(&tdq, box_a, wg * (HD / 2), qrow);
        if (!SUMQ) tma_reduce_add_2d(&tdq, box_b, HD + wg * (HD / 2), qrow);
      }
      tma_reduce_add_2d(&tdp, box_p, wg * (HD / 2), dp_row0 - 64 * it);
      bulk_commit();
    }
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {  // the carry moves down one piece
      c2[i] = c1[i];
      c1[i] = n0[i];
    }
  }

  // the last step's carry: pieces nq and nq + 1
  if (issuer) bulk_wait_read<0>();
  bar_sync(2 + wg, 128);
  if (fault != XB_FAULT_NO_FLUSH) {
    stage_box<HD>(box_a, c2, wl, g, t);
    stage_box<HD>(box_b, c1, wl, g, t);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (issuer) {
      tma_reduce_add_2d(&tdp, box_a, wg * (HD / 2), dp_row0 - 64 * nq);
      tma_reduce_add_2d(&tdp, box_b, wg * (HD / 2), dp_row0 - 64 * (nq + 1));
      bulk_commit();
    }
  }

  if (SUMQ) {
    // the column sums of dQu and dQv over this block's queries: over g by
    // shuffles, over the four warps in shared memory (past the staging boxes)
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cu[i] += __shfl_xor_sync(0xffffffffu, cu[i], off);
        cv[i] += __shfl_xor_sync(0xffffffffu, cv[i], off);
      }
    float* red = box_p;  // [4 warps][2][d/2]
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int col = 8 * (i >> 1) + 2 * t + (i & 1);
        red[(wl * 2 + 0) * (HD / 2) + col] = cu[i];
        red[(wl * 2 + 1) * (HD / 2) + col] = cv[i];
      }
    }
    bar_sync(2 + wg, 128);
    const int tid = threadIdx.x & 127;
    if (tid < HD) {
      const int which = tid / (HD / 2), col = tid % (HD / 2);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[(w * 2 + which) * (HD / 2) + col];
      colsum[((bh * gridDim.x + kt) * 2 + which) * HD + wg * (HD / 2) + col] = sum;
    }
  }
  if (issuer) bulk_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const int key = key0 + 8 * r;
    bf16* dkr = dk.at(b, h) + (long long)key * dk.rs + 2 * t;
    bf16* dvr = dv.at(b, h) + (long long)key * dv.rs + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
          pack_bf16(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// The pre-pass: per (batch, head, row < T_pad) the side pair (L * log2 e or
// +inf, delta = rowsum(dO * O) in f32, 0 past T); with q (row 13) qu and qv
// [B, H, T, d] contiguous, bf16 of the f32 sums of q and each bias [H, d];
// and the workspaces, `zero4` float4s from `ws`, zeroed. HD / 8 threads a
// row, 16 bytes each; the grid covers B * H * T_pad rows exactly.
template <int HD, bool BIAS>
__global__ void __launch_bounds__(256)
xl_bwd_prepass_kernel(Rows<const bf16> o, Rows<const bf16> dout, const float* __restrict__ lse,
                      float* __restrict__ side, float4* __restrict__ ws, long long zero4,
                      Rows<const bf16> q, const float* __restrict__ bias_u,
                      const float* __restrict__ bias_v, bf16* __restrict__ qu,
                      bf16* __restrict__ qv, int n, int n_pad, int heads) {
  constexpr int TPR = HD / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / TPR;
  const int part = idx % TPR;
  const int r = row % n_pad;
  const long long bh = row / n_pad;
  const int b = bh / heads, h = bh % heads;
  const bool live = r < n;
  hopper::side_pair<HD>(o.at(b, h) + (long long)r * o.rs, dout.at(b, h) + (long long)r * dout.rs,
                        live ? lse[bh * n + r] : 0.f, live, part, side + row * 2);
  if (BIAS && live) {
    const uint4 xv = *reinterpret_cast<const uint4*>(q.at(b, h) + (long long)r * q.rs + part * 8);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const float* bu = bias_u + h * HD + part * 8;
    const float* bv = bias_v + h * HD + part * 8;
    uint32_t u[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = __bfloat162float(xe[2 * i]), x1 = __bfloat162float(xe[2 * i + 1]);
      u[i] = pack_bf16(x0 + bu[2 * i], x1 + bu[2 * i + 1]);
      v[i] = pack_bf16(x0 + bv[2 * i], x1 + bv[2 * i + 1]);
    }
    const long long at = (bh * n + r) * HD + part * 8;
    *reinterpret_cast<uint4*>(qu + at) = make_uint4(u[0], u[1], u[2], u[3]);
    *reinterpret_cast<uint4*>(qv + at) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  const long long threads = (long long)gridDim.x * blockDim.x;
  for (long long i = idx; i < zero4; i += threads) ws[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The post-pass, one thread per 8 elements: dq = bf16(scale * dq_acc) for
// rows < T (SUMQ: the one workspace into dq; without: its halves into dq and
// dqv), dp = bf16(scale * dp_acc) for P rows 0 .. 2T-2, and with SUMQ
// dbias [2, H, d] (dbu, then dbv) = scale * the sum of colsum over batch and
// key tiles, one thread an element.
template <int HD, bool SUMQ>
__global__ void __launch_bounds__(256)
xl_bwd_postpass_kernel(const float* __restrict__ dq_acc, const float* __restrict__ dp_acc,
                       const float* __restrict__ colsum, Rows<bf16> dq, Rows<bf16> dqv,
                       Rows<bf16> dp, float* __restrict__ dbias, int batch, int n, int heads,
                       int n_kt, int ndp, long long q_chunks, long long p_chunks, float scale) {
  constexpr int CPR = HD / 8;
  constexpr int WS = SUMQ ? HD : 2 * HD;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  auto put = [scale](bf16* dst, const float* src) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16(lo.x * scale, lo.y * scale), pack_bf16(lo.z * scale, lo.w * scale),
                   pack_bf16(hi.x * scale, hi.y * scale), pack_bf16(hi.z * scale, hi.w * scale));
  };
  if (idx < q_chunks) {
    const long long row = idx / CPR;
    const int part = idx % CPR, r = row % n;
    const long long bh = row / n;
    const int b = bh / heads, h = bh % heads;
    const int n_pad = (n + XB_QROWS - 1) / XB_QROWS * XB_QROWS;
    const float* src = dq_acc + (bh * n_pad + r) * WS + part * 8;
    put(dq.at(b, h) + (long long)r * dq.rs + part * 8, src);
    if (!SUMQ) put(dqv.at(b, h) + (long long)r * dqv.rs + part * 8, src + HD);
    return;
  }
  idx -= q_chunks;
  if (idx < p_chunks) {
    const long long row = idx / CPR;
    const int part = idx % CPR, m = row % (2 * n - 1), h = row / (2 * n - 1);
    put(dp.at(0, h) + (long long)m * dp.rs + part * 8,
        dp_acc + ((long long)h * ndp + XB_PAD + m) * HD + part * 8);
    return;
  }
  idx -= p_chunks;
  if (SUMQ && idx < 2LL * heads * HD) {
    const int which = idx / (heads * HD), h = (idx / HD) % heads, c = idx % HD;
    float sum = 0.f;
    for (int b = 0; b < batch; ++b)
      for (int kt = 0; kt < n_kt; ++kt)
        sum += colsum[((((long long)b * heads + h) * n_kt + kt) * 2 + which) * HD + c];
    dbias[idx] = sum * scale;
  }
}

// -- host side ----------------------------------------------------------------------

static inline int xb_padded_rows(int n) { return (n + XB_QROWS - 1) / XB_QROWS * XB_QROWS; }
static inline int xb_key_tiles(int n) { return (n + XB_KEYS - 1) / XB_KEYS; }
// rows per head of the dP workspace: P rows -64 .. 2T + 191, every row a strip
// piece of any block can reach
static inline int xb_dp_rows(int n) { return 2 * n + 256; }

// Launch the main kernel on `stream`; returns cudaGetLastError() after the
// launch (0 = launched). side, dq_acc and dp_acc come from the pre-pass.
template <int HD, bool SUMQ>
static int launch_xl_bwd(int batch, int n, int heads, void* stream, Rows<const bf16> qu,
                         Rows<const bf16> qv, Rows<const bf16> k, Rows<const bf16> v,
                         Rows<const bf16> dout, Rows<const bf16> p, const int* band,
                         const float* side, float* dq_acc, float* dp_acc, float* colsum,
                         Rows<bf16> dk, Rows<bf16> dv, int fault, float sm_scale) {
  using hopper::tensor_map;
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tqu, tqv, tk, tv, tdo, tp, tdq, tdp;
  if (!tensor_map(encode, &tqu, qu, batch, heads, n, HD, XB_QROWS) ||
      !tensor_map(encode, &tqv, qv, batch, heads, n, HD, XB_QROWS) ||
      !tensor_map(encode, &tk, k, batch, heads, n, HD, XB_KEYS) ||
      !tensor_map(encode, &tv, v, batch, heads, n, HD, XB_KEYS) ||
      !tensor_map(encode, &tdo, dout, batch, heads, n, HD, XB_QROWS) ||
      !tensor_map(encode, &tp, p, 1, heads, 2 * n - 1, HD, 64) ||
      !hopper::f32_box_map(encode, &tdq, dq_acc, (long long)batch * heads * xb_padded_rows(n),
                           SUMQ ? HD : 2 * HD, HD / 2) ||
      !hopper::f32_box_map(encode, &tdp, dp_acc, (long long)heads * xb_dp_rows(n), HD, HD / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = XbSmem<HD>::BYTES;
  static_assert(bytes <= 232448, "a block's shared memory on sm_90");
  cudaError_t err = cudaFuncSetAttribute(xl_bwd_kernel<HD, SUMQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(xb_key_tiles(n), heads, batch);
  xl_bwd_kernel<HD, SUMQ><<<grid, XB_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tqu, tqv, tk, tv, tdo, tp, tdq, tdp, side, band, colsum, dk, dv, n, xb_dp_rows(n), fault,
      sm_scale, sm_scale * XB_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool BIAS>
static int launch_xl_bwd_prepass(int batch, int n, int heads, int ws_cols, void* stream,
                                 Rows<const bf16> o, Rows<const bf16> dout, const float* lse,
                                 float* side, float* ws, Rows<const bf16> q, const float* bias_u,
                                 const float* bias_v, bf16* qu, bf16* qv) {
  const int n_pad = xb_padded_rows(n);
  const long long threads = (long long)batch * heads * n_pad * (HD / 8);  // a multiple of 256
  const long long floats = (long long)batch * heads * n_pad * ws_cols +
                           (long long)heads * xb_dp_rows(n) * HD;
  xl_bwd_prepass_kernel<HD, BIAS><<<(unsigned)(threads / 256), 256, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      o, dout, lse, side, reinterpret_cast<float4*>(ws), floats / 4, q, bias_u, bias_v, qu, qv, n,
      n_pad, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool SUMQ>
static int launch_xl_bwd_postpass(int batch, int n, int heads, void* stream, const float* dq_acc,
                                  const float* dp_acc, const float* colsum, Rows<bf16> dq,
                                  Rows<bf16> dqv, Rows<bf16> dp, float* dbias, float sm_scale) {
  const long long q_chunks = (long long)batch * heads * n * (HD / 8);
  const long long p_chunks = (long long)heads * (2 * n - 1) * (HD / 8);
  const long long total = q_chunks + p_chunks + (SUMQ ? 2LL * heads * HD : 0);
  xl_bwd_postpass_kernel<HD, SUMQ><<<(unsigned)((total + 255) / 256), 256, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      dq_acc, dp_acc, colsum, dq, dqv, dp, dbias, batch, n, heads, xb_key_tiles(n),
      xb_dp_rows(n), q_chunks, p_chunks, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
