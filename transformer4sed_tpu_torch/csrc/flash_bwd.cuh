// Flash attention backward for Hopper (sm_90a): the device code shared by the
// heads-in-lanes entry point (flash_attention_bwd.cu) and the head-major one
// (flash_attention_hm_bwd.cu).
//
// From the saved output O and row log-sum-exp L of the forward, with
// delta = rowsum(dO * O) per head computed beforehand (as the TPU wrappers
// do):
//   P  = exp(scale * Q K^T - L)
//   dV = P^T dO                      (P rounded to bf16)
//   dS = P * (dO V^T - delta)        (rounded to bf16)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// Every operand comes as a base pointer with batch, head and row strides
// (Rows, mma.cuh): [B, N, H*d] lane slices and [B, H, T, d] views alike. HD is
// the head dim, a multiple of 16; the launchers build 64 (heads-in-lanes) and
// 32, 64 (head major).
//
// What bounds it: five products of 2*T^2*d per (batch, head), 87 GFLOP at
// B=8, T=1190, H=12, d=64 against ~100 MB of operands, far above the H100's
// ~295 FLOP/byte ridge: the tensor cores bound it.
// Design: one kernel where the TPU runs two (dq, then dk/dv). One block of
// 4 warps owns one 64-key tile of one (batch, head) and keeps its K and V
// (row-major and transposed) in shared memory and its dK/dV sums in registers
// (each warp 16 keys). It walks the 64-row query tiles; per tile each warp
// recomputes its 16 rows of S and dO V^T with mma.sync m16n8k16 (bf16 in, f32
// accumulate), forms P and dS in registers, adds its dS K partial into an f32
// dQ workspace with atomicAdd (the caller casts it to bf16), and parks P^T and
// dS^T in shared memory, from which each warp multiplies its 16 keys' rows
// into dV and dK. The ragged tail (T = 1190 is not a multiple of 64) is masked
// for queries and keys alike; a row whose L is -inf has zero weight. This is
// the plain first version: no TMA, no wgmma, scalar transposed stores, dQ by
// atomics.
#pragma once

#include "mma.cuh"

namespace t4s {

constexpr int FB_TILE = 64;
constexpr int FB_WARPS = 4;
constexpr int FB_THREADS = 32 * FB_WARPS;
constexpr int FB_PAD = 8;

template <int HD>
struct FbSmem {
  static constexpr int LD = HD + FB_PAD;        // row-major [64][HD] tiles
  static constexpr int LDT = FB_TILE + FB_PAD;  // transposed [HD][64] and [64][64] tiles
  static constexpr int ROW_TILE = FB_TILE * LD * 2;
  static constexpr int T_TILE = (HD > FB_TILE ? HD : FB_TILE) * LDT * 2;
  static constexpr int K_OFF = 0;
  static constexpr int KT_OFF = K_OFF + ROW_TILE;
  static constexpr int V_OFF = KT_OFF + T_TILE;
  static constexpr int Q_OFF = V_OFF + ROW_TILE;
  static constexpr int QT_OFF = Q_OFF + ROW_TILE;
  static constexpr int DO_OFF = QT_OFF + T_TILE;
  static constexpr int DOT_OFF = DO_OFF + ROW_TILE;
  static constexpr int PT_OFF = DOT_OFF + T_TILE;
  static constexpr int DST_OFF = PT_OFF + T_TILE;
  static constexpr int L_OFF = DST_OFF + T_TILE;
  static constexpr int D_OFF = L_OFF + FB_TILE * 4;
  static constexpr int BYTES = D_OFF + FB_TILE * 4;
};

template <int HD>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v,
                 Rows<const bf16> dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, Rows<float> dq_acc, Rows<bf16> dk,
                 Rows<bf16> dv, int n, float scale, float scale_log2) {
  using L = FbSmem<HD>;
  constexpr int LD = L::LD, LDT = L::LDT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sKt = reinterpret_cast<bf16*>(smem + L::KT_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sQt = reinterpret_cast<bf16*>(smem + L::QT_OFF);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  bf16* sdOt = reinterpret_cast<bf16*>(smem + L::DOT_OFF);
  bf16* sPt = reinterpret_cast<bf16*>(smem + L::PT_OFF);
  bf16* sdSt = reinterpret_cast<bf16*>(smem + L::DST_OFF);
  float* sL = reinterpret_cast<float*>(smem + L::L_OFF);
  float* sD = reinterpret_cast<float*>(smem + L::D_OFF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * FB_TILE, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q.at(b, h);
  const bf16* kb = k.at(b, h) + (long long)j0 * k.rs;
  const bf16* vb = v.at(b, h) + (long long)j0 * v.rs;
  const bf16* ob = dout.at(b, h);
  const long long bh = (long long)b * gridDim.y + h;
  const float* lse_bh = lse + bh * n;
  const float* delta_bh = delta + bh * n;

  load_rows<HD, FB_THREADS>(sK, LD, kb, k.rs, FB_TILE, n - j0);
  load_rows_transposed<HD, FB_THREADS>(sKt, LDT, kb, k.rs, FB_TILE, n - j0);
  load_rows<HD, FB_THREADS>(sV, LD, vb, v.rs, FB_TILE, n - j0);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int r0 = warp * 16 + g;  // this thread's query rows r0, r0 + 8 of the tile
  for (int i0 = 0; i0 < n; i0 += FB_TILE) {
    __syncthreads();  // the previous tile's P^T/dS^T/Q/dO are consumed
    load_rows<HD, FB_THREADS>(sQ, LD, qb + (long long)i0 * q.rs, q.rs, FB_TILE, n - i0);
    load_rows_transposed<HD, FB_THREADS>(sQt, LDT, qb + (long long)i0 * q.rs, q.rs, FB_TILE,
                                         n - i0);
    load_rows<HD, FB_THREADS>(sdO, LD, ob + (long long)i0 * dout.rs, dout.rs, FB_TILE, n - i0);
    load_rows_transposed<HD, FB_THREADS>(sdOt, LDT, ob + (long long)i0 * dout.rs, dout.rs,
                                         FB_TILE, n - i0);
    for (int r = threadIdx.x; r < FB_TILE; r += FB_THREADS) {
      const bool ok = i0 + r < n;
      sL[r] = ok ? lse_bh[i0 + r] * 1.4426950408889634f : INFINITY;
      sD[r] = ok ? delta_bh[i0 + r] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
    uint32_t qf[HD / 16][4], of[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      qf[kk][0] = ld_b32(&sQ[r0 * LD + c0]);
      qf[kk][1] = ld_b32(&sQ[(r0 + 8) * LD + c0]);
      qf[kk][2] = ld_b32(&sQ[r0 * LD + c0 + 8]);
      qf[kk][3] = ld_b32(&sQ[(r0 + 8) * LD + c0 + 8]);
      of[kk][0] = ld_b32(&sdO[r0 * LD + c0]);
      of[kk][1] = ld_b32(&sdO[(r0 + 8) * LD + c0]);
      of[kk][2] = ld_b32(&sdO[r0 * LD + c0 + 8]);
      of[kk][3] = ld_b32(&sdO[(r0 + 8) * LD + c0 + 8]);
    }
    float s[FB_TILE / 8][4], ds[FB_TILE / 8][4];
#pragma unroll
    for (int nt = 0; nt < FB_TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = ds[nt][e] = 0.f;
      const bf16* kr = &sK[(nt * 8 + g) * LD + 2 * t];
      const bf16* vr = &sV[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_16816(s[nt], qf[kk], ld_b32(kr + kk * 16), ld_b32(kr + kk * 16 + 8));
        mma_16816(ds[nt], of[kk], ld_b32(vr + kk * 16), ld_b32(vr + kk * 16 + 8));
      }
    }

    // P = exp(scale S - L) and dS = P (dP - delta); P^T and dS^T to shared
    const float l2[2] = {sL[r0], sL[r0 + 8]}, dl[2] = {sD[r0], sD[r0 + 8]};
#pragma unroll
    for (int nt = 0; nt < FB_TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = r0 + 8 * (e >> 1), c = nt * 8 + 2 * t + (e & 1);
        const bool ok = i0 + rl < n && j0 + c < n && l2[e >> 1] != -INFINITY;
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - l2[e >> 1]) : 0.f;
        s[nt][e] = p;
        ds[nt][e] = p * (ds[nt][e] - dl[e >> 1]);
        sPt[c * LDT + rl] = __float2bfloat16(p);
        sdSt[c * LDT + rl] = __float2bfloat16(ds[nt][e]);
      }
    }

    // dQ partial of this key tile: scale * dS K, into the f32 workspace
    float dq[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FB_TILE / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
      a[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
      a[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      a[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const bf16* kt = &sKt[(dt * 8 + g) * LDT + kk * 16 + 2 * t];
        mma_16816(dq[dt], a, ld_b32(kt), ld_b32(kt + 8));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + r0 + 8 * r;
      if (row >= n) continue;
      float* dqr = dq_acc.at(b, h) + (long long)row * dq_acc.rs + 2 * t;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        atomicAdd(dqr + dt * 8, dq[dt][2 * r] * scale);
        atomicAdd(dqr + dt * 8 + 1, dq[dt][2 * r + 1] * scale);
      }
    }
    __syncthreads();  // P^T and dS^T of all four warps are in place

    // dV += P^T dO and dK += dS^T Q for this warp's 16 keys
    const int k0 = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < FB_TILE / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      uint32_t pa[4], sa[4];
      pa[0] = ld_b32(&sPt[k0 * LDT + c0]);
      pa[1] = ld_b32(&sPt[(k0 + 8) * LDT + c0]);
      pa[2] = ld_b32(&sPt[k0 * LDT + c0 + 8]);
      pa[3] = ld_b32(&sPt[(k0 + 8) * LDT + c0 + 8]);
      sa[0] = ld_b32(&sdSt[k0 * LDT + c0]);
      sa[1] = ld_b32(&sdSt[(k0 + 8) * LDT + c0]);
      sa[2] = ld_b32(&sdSt[k0 * LDT + c0 + 8]);
      sa[3] = ld_b32(&sdSt[(k0 + 8) * LDT + c0 + 8]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const bf16* ot = &sdOt[(dt * 8 + g) * LDT + c0];
        const bf16* qt = &sQt[(dt * 8 + g) * LDT + c0];
        mma_16816(dv_acc[dt], pa, ld_b32(ot), ld_b32(ot + 8));
        mma_16816(dk_acc[dt], sa, ld_b32(qt), ld_b32(qt + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + warp * 16 + g + 8 * r;
    if (key >= n) continue;
    bf16* dkr = dk.at(b, h) + (long long)key * dk.rs + 2 * t;
    bf16* dvr = dv.at(b, h) + (long long)key * dv.rs + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dkr + dt * 8) =
          pack_bf16(dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + dt * 8) =
          pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = launched).
template <int HD>
static int launch_flash_bwd(int batch, int n, int heads, void* stream, Rows<const bf16> q,
                            Rows<const bf16> k, Rows<const bf16> v, Rows<const bf16> dout,
                            const float* lse, const float* delta, Rows<float> dq_acc,
                            Rows<bf16> dk, Rows<bf16> dv, float sm_scale) {
  constexpr int bytes = FbSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + FB_TILE - 1) / FB_TILE, heads, batch);
  flash_bwd_kernel<HD><<<grid, FB_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, dq_acc, dk, dv, n, sm_scale, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
