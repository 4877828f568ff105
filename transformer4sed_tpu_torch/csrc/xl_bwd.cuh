// Fused Transformer-XL attention backward for Hopper (sm_90a): the device code
// shared by the heads-in-lanes entry point (xl_attention_bwd.cu) and the
// head-major one (xl_attention_hm_bwd.cu).
//
// With the forward's saved output O and row log-sum-exp L, and
// delta = rowsum(dO * O) per head computed beforehand:
//   S[i,j]  = scale * (qu_i . k_j + qv_i . P[T-1-i+j])     (band-masked)
//   A       = exp(S - L),  dS = A * (dO V^T - delta)       (dS rounded to bf16)
//   dV      = A^T dO                                       (A rounded to bf16)
//   dK      = scale * dS^T qu
//   dQu_i   = scale * sum_j dS[i,j] k_j
//   dQv_i   = scale * sum_j dS[i,j] P[T-1-i+j]
//   dP[m]  += scale * sum_{(i,j): T-1-i+j = m} dS[i,j] qv_i   (summed over batch)
// Every operand comes as a base pointer with batch, head and row strides
// (Rows, xl.cuh). With BIAS, qu and qv are one tensor q and the kernel forms
// bf16(q + u) and bf16(q + v) from the f32 pos_bias_u / pos_bias_v [H, d];
// without it they are two operands that arrive already summed, and the block
// stages a second query tile for qv. dQu and dQv (f32 workspaces with their
// own strides) and dP [H, 2T-1, d] f32 are summed into by atomicAdd; the
// caller zeroes them and forms what it needs from them in f32. HD is the
// head dim, a multiple of 16 up to 64; shared memory is 202 KB at HD = 64
// with BIAS, 211 KB without, 147 KB at HD = 32 without.
//
// What bounds it: eight products of 2*T^2*d per (batch, head) (content and
// position scores, dO V^T, dV, dK, dQu, dQv, dP), 98 GFLOP at B=8, T=1000,
// H=12, d=64, far above the H100's ~295 FLOP/byte ridge: the tensor cores
// bound it, at d = 32 as at d = 64.
// Design: as flash_attention_bwd.cu, one block of 4 warps owns one 64-key
// tile of one (batch, head), keeps K and V in shared memory and its dK/dV
// sums in registers, and walks the 64-row query tiles. The rel-shift is
// index arithmetic, as in xl.cuh's forward: for a (query tile i0, key tile
// j0) the needed P rows T-1-i+j form one strip of 127 rows from
// s0 = T - i0 - 64 + j0, staged in shared memory (row-major and transposed),
// zero outside [0, 2T-1). Each warp recomputes its 16 rows' position scores
// against the 80 strip rows it reaches and reads element [r][c + 15 - r].
// dS is also written skewed, D[r][63 - r + c] = dS[r][c], as a [64 x 128]
// strip matrix (and its transpose): dQv is then D P_strip and the strip's dP
// is D^T qv, two plain products. Consecutive query tiles' strips overlap by
// 64 rows, so each warp keeps the lower half of its dP strip tile in a
// shared carry and adds it into the next tile's upper half; a strip row
// goes to device memory (atomicAdd) once per block, when it leaves the
// window. The band mask is generated per element; rows with no valid key
// have zero weight. The strip geometry depends on the tile size only, not on
// HD. This is the plain first version: no TMA, no wgmma, scalar transposed
// stores, dQ and dP by atomics.
#pragma once

#include "xl.cuh"

namespace t4s {

constexpr int XB_TILE = 64;
constexpr int XB_WARPS = 4;
constexpr int XB_THREADS = 32 * XB_WARPS;
constexpr int XB_PAD = 8;
constexpr int XB_STRIP = 2 * XB_TILE;             // strip rows staged (127 used)
constexpr int XB_REACH = XB_TILE + 16;            // strip rows one warp reaches (79, rounded up)
constexpr int XB_SLD = XB_REACH + 4;              // pitch of a warp's f32 position scratch

template <int HD, bool BIAS>
struct XbSmem {
  static constexpr int LD = HD + XB_PAD;          // row-major [rows][HD]
  static constexpr int LDT = XB_TILE + XB_PAD;    // [HD][64] and [64][64] tiles
  static constexpr int LDS = XB_STRIP + XB_PAD;   // [HD][128] and [64][128] strips
  static constexpr int ROW = XB_TILE * LD * 2;
  static constexpr int TH = HD * LDT * 2;         // transposed [HD][64] tiles
  static constexpr int TT = XB_TILE * LDT * 2;    // [64][64] tiles
  static constexpr int K_OFF = 0;
  static constexpr int KT_OFF = K_OFF + ROW;
  static constexpr int V_OFF = KT_OFF + TH;
  static constexpr int Q_OFF = V_OFF + ROW;
  static constexpr int QUT_OFF = Q_OFF + ROW;
  static constexpr int QVT_OFF = QUT_OFF + TH;
  static constexpr int DO_OFF = QVT_OFF + TH;
  static constexpr int DOT_OFF = DO_OFF + ROW;
  static constexpr int PS_OFF = DOT_OFF + TH;
  static constexpr int PST_OFF = PS_OFF + XB_STRIP * LD * 2;
  static constexpr int PT_OFF = PST_OFF + HD * LDS * 2;
  static constexpr int DST_OFF = PT_OFF + TT;
  static constexpr int DF_OFF = DST_OFF + TT;
  static constexpr int DFT_OFF = DF_OFF + XB_TILE * LDS * 2;
  static constexpr int SC_OFF = DFT_OFF + XB_STRIP * LDT * 2;
  static constexpr int CARRY_OFF = SC_OFF + XB_WARPS * 16 * XB_SLD * 4;
  static constexpr int L_OFF = CARRY_OFF + XB_TILE * HD * 4;
  static constexpr int D_OFF = L_OFF + XB_TILE * 4;
  static constexpr int QV_OFF = D_OFF + XB_TILE * 4;  // the qv tile, without BIAS only
  static constexpr int BYTES = QV_OFF + (BIAS ? 0 : ROW);
};

template <int HD, bool BIAS>
__global__ void __launch_bounds__(XB_THREADS)
xl_bwd_kernel(Rows<const bf16> qu_in, Rows<const bf16> qv_in, Rows<const bf16> k,
              Rows<const bf16> v, Rows<const bf16> dout, const float* __restrict__ bias_u,
              const float* __restrict__ bias_v, const bf16* __restrict__ p, long long p_hs,
              long long p_rs, const int* __restrict__ band, const float* __restrict__ lse,
              const float* __restrict__ delta, Rows<float> dqu_acc, Rows<float> dqv_acc,
              float* __restrict__ dp_acc, Rows<bf16> dk, Rows<bf16> dv, int n, float scale,
              float scale_log2) {
  using L = XbSmem<HD, BIAS>;
  constexpr int LD = L::LD, LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sKt = reinterpret_cast<bf16*>(smem + L::KT_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* sQu = reinterpret_cast<bf16*>(smem + L::Q_OFF);   // q itself with BIAS
  bf16* sQv = reinterpret_cast<bf16*>(smem + L::QV_OFF);  // without BIAS only
  bf16* sQuT = reinterpret_cast<bf16*>(smem + L::QUT_OFF);
  bf16* sQvT = reinterpret_cast<bf16*>(smem + L::QVT_OFF);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  bf16* sdOt = reinterpret_cast<bf16*>(smem + L::DOT_OFF);
  bf16* sPs = reinterpret_cast<bf16*>(smem + L::PS_OFF);
  bf16* sPsT = reinterpret_cast<bf16*>(smem + L::PST_OFF);
  bf16* sPt = reinterpret_cast<bf16*>(smem + L::PT_OFF);
  bf16* sdSt = reinterpret_cast<bf16*>(smem + L::DST_OFF);
  bf16* sDf = reinterpret_cast<bf16*>(smem + L::DF_OFF);
  bf16* sDfT = reinterpret_cast<bf16*>(smem + L::DFT_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::SC_OFF);
  float* sCarry = reinterpret_cast<float*>(smem + L::CARRY_OFF);
  float* sL = reinterpret_cast<float*>(smem + L::L_OFF);
  float* sD = reinterpret_cast<float*>(smem + L::D_OFF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * XB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int n_pos = 2 * n - 1;
  const bf16* qub = qu_in.at(b, h);
  const bf16* qvb = qv_in.at(b, h);
  const bf16* kb = k.at(b, h) + (long long)j0 * k.rs;
  const bf16* vb = v.at(b, h) + (long long)j0 * v.rs;
  const bf16* ob = dout.at(b, h);
  const bf16* pb = p + (long long)h * p_hs;
  const long long bh = (long long)b * gridDim.y + h;
  const float* lse_bh = lse + bh * n;
  const float* delta_bh = delta + bh * n;
  float* dp_h = dp_acc + (long long)h * n_pos * HD;
  const int half = band != nullptr ? band[h] / 2 : 0;

  load_rows<HD, XB_THREADS>(sK, LD, kb, k.rs, XB_TILE, n - j0);
  load_rows_transposed<HD, XB_THREADS>(sKt, LDT, kb, k.rs, XB_TILE, n - j0);
  load_rows<HD, XB_THREADS>(sV, LD, vb, v.rs, XB_TILE, n - j0);
  for (int c = threadIdx.x; c < XB_TILE * HD; c += XB_THREADS) sCarry[c] = 0.f;

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  float* scratch = sS + warp * 16 * XB_SLD;
  const int strip_off = 16 * (XB_WARPS - 1 - warp);  // first strip row this warp reaches
  const int r0 = warp * 16 + g;                       // this thread's query rows r0, r0 + 8
  int s0 = 0;
  for (int i0 = 0; i0 < n; i0 += XB_TILE) {
    s0 = n - i0 - XB_TILE + j0;
    __syncthreads();  // the previous tile's shared operands are consumed
    load_rows<HD, XB_THREADS>(sQu, LD, qub + (long long)i0 * qu_in.rs, qu_in.rs, XB_TILE, n - i0);
    if (!BIAS)
      load_rows<HD, XB_THREADS>(sQv, LD, qvb + (long long)i0 * qv_in.rs, qv_in.rs, XB_TILE,
                                n - i0);
    load_rows<HD, XB_THREADS>(sdO, LD, ob + (long long)i0 * dout.rs, dout.rs, XB_TILE, n - i0);
    load_rows_transposed<HD, XB_THREADS>(sdOt, LDT, ob + (long long)i0 * dout.rs, dout.rs,
                                         XB_TILE, n - i0);
    {
      // position strip: P rows [s0, s0 + 128), zero outside [0, 2T-1)
      constexpr int CH = HD / 8;
      for (int c = threadIdx.x; c < XB_STRIP * CH; c += XB_THREADS) {
        const int r = c / CH, cc = (c % CH) * 8, pr = s0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (pr >= 0 && pr < n_pos)
          val = *reinterpret_cast<const uint4*>(pb + (long long)pr * p_rs + cc);
        *reinterpret_cast<uint4*>(sPs + r * LD + cc) = val;
        const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) sPsT[(cc + i) * LDS + r] = e[i];
      }
      // the skewed dS strips start at zero
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int c = threadIdx.x; c < XB_TILE * LDS / 8; c += XB_THREADS)
        reinterpret_cast<uint4*>(sDf)[c] = z;
      for (int c = threadIdx.x; c < XB_STRIP * LDT / 8; c += XB_THREADS)
        reinterpret_cast<uint4*>(sDfT)[c] = z;
    }
    for (int r = threadIdx.x; r < XB_TILE; r += XB_THREADS) {
      const bool ok = i0 + r < n;
      sL[r] = ok ? lse_bh[i0 + r] * 1.4426950408889634f : INFINITY;
      sD[r] = ok ? delta_bh[i0 + r] : 0.f;
    }
    __syncthreads();

    // qu and qv fragments of this warp's rows (with BIAS: q+u and q+v, f32 add,
    // bf16 round), their transposes for the key-side and strip products, dO
    // fragments
    uint32_t qu[HD / 16][4], qv[HD / 16][4], of[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = r0 + 8 * (f & 1), col = kk * 16 + 2 * t + 8 * (f >> 1);
        if (BIAS) {
          const float* bu = bias_u + h * HD;
          const float* bv = bias_v + h * HD;
          const float x0 = __bfloat162float(sQu[row * LD + col]);
          const float x1 = __bfloat162float(sQu[row * LD + col + 1]);
          qu[kk][f] = pack_bf16(x0 + bu[col], x1 + bu[col + 1]);
          qv[kk][f] = pack_bf16(x0 + bv[col], x1 + bv[col + 1]);
        } else {
          qu[kk][f] = ld_b32(&sQu[row * LD + col]);
          qv[kk][f] = ld_b32(&sQv[row * LD + col]);
        }
        const bf16* u2 = reinterpret_cast<const bf16*>(&qu[kk][f]);
        const bf16* v2 = reinterpret_cast<const bf16*>(&qv[kk][f]);
        sQuT[col * LDT + row] = u2[0];
        sQuT[(col + 1) * LDT + row] = u2[1];
        sQvT[col * LDT + row] = v2[0];
        sQvT[(col + 1) * LDT + row] = v2[1];
        of[kk][f] = ld_b32(&sdO[row * LD + col]);
      }
    }

    // position scores of this warp's rows against its reachable strip rows
#pragma unroll
    for (int nt = 0; nt < XB_REACH / 8; ++nt) {
      float pr[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* sr = &sPs[(strip_off + nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_16816(pr, qv[kk], ld_b32(sr + kk * 16), ld_b32(sr + kk * 16 + 8));
      float* d0 = scratch + g * XB_SLD + nt * 8 + 2 * t;
      d0[0] = pr[0];
      d0[1] = pr[1];
      d0[8 * XB_SLD] = pr[2];
      d0[8 * XB_SLD + 1] = pr[3];
    }

    // content scores and dP = dO V^T
    float s[XB_TILE / 8][4], ds[XB_TILE / 8][4];
#pragma unroll
    for (int nt = 0; nt < XB_TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = ds[nt][e] = 0.f;
      const bf16* kr = &sK[(nt * 8 + g) * LD + 2 * t];
      const bf16* vr = &sV[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_16816(s[nt], qu[kk], ld_b32(kr + kk * 16), ld_b32(kr + kk * 16 + 8));
        mma_16816(ds[nt], of[kk], ld_b32(vr + kk * 16), ld_b32(vr + kk * 16 + 8));
      }
    }
    __syncwarp();

    // A = exp(S - L), dS = A (dP - delta); A^T, dS^T and the skewed dS to shared
    const float l2[2] = {sL[r0], sL[r0 + 8]}, dl[2] = {sD[r0], sD[r0 + 8]};
#pragma unroll
    for (int nt = 0; nt < XB_TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = g + 8 * (e >> 1), c = nt * 8 + 2 * t + (e & 1);
        const int rloc = warp * 16 + rl, row = i0 + rloc, col = j0 + c;
        bool ok = row < n && col < n && l2[e >> 1] != -INFINITY;
        if (band != nullptr) ok = ok && ((col >= row - half && col < row + half) || col == row);
        const float pos = scratch[rl * XB_SLD + c + 15 - rl];
        const float a = ok ? exp2f((s[nt][e] + pos) * scale_log2 - l2[e >> 1]) : 0.f;
        ds[nt][e] = a * (ds[nt][e] - dl[e >> 1]);
        const bf16 dsb = __float2bfloat16(ds[nt][e]);
        const int m = XB_TILE - 1 - rloc + c;
        sPt[c * LDT + rloc] = __float2bfloat16(a);
        sdSt[c * LDT + rloc] = dsb;
        sDf[rloc * LDS + m] = dsb;
        sDfT[m * LDT + rloc] = dsb;
      }
    }

    // dQu partial of this key tile: scale * dS K
    {
      float acc[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < XB_TILE / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
        a[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
        a[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
        a[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const bf16* kt = &sKt[(dt * 8 + g) * LDT + kk * 16 + 2 * t];
          mma_16816(acc[dt], a, ld_b32(kt), ld_b32(kt + 8));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = i0 + r0 + 8 * r;
        if (row >= n) continue;
        float* dst = dqu_acc.at(b, h) + (long long)row * dqu_acc.rs + 2 * t;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          atomicAdd(dst + dt * 8, acc[dt][2 * r] * scale);
          atomicAdd(dst + dt * 8 + 1, acc[dt][2 * r + 1] * scale);
        }
      }
    }
    __syncthreads();  // A^T, dS^T, the skewed strips and qu^T/qv^T are complete

    // dQv = scale * D P_strip over the 80 strip rows this warp's rows reach
    {
      float acc[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < XB_REACH / 16; ++kk) {
        const int c0 = strip_off + kk * 16 + 2 * t;
        uint32_t a[4];
        a[0] = ld_b32(&sDf[r0 * LDS + c0]);
        a[1] = ld_b32(&sDf[(r0 + 8) * LDS + c0]);
        a[2] = ld_b32(&sDf[r0 * LDS + c0 + 8]);
        a[3] = ld_b32(&sDf[(r0 + 8) * LDS + c0 + 8]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const bf16* pt = &sPsT[(dt * 8 + g) * LDS + c0];
          mma_16816(acc[dt], a, ld_b32(pt), ld_b32(pt + 8));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = i0 + r0 + 8 * r;
        if (row >= n) continue;
        float* dst = dqv_acc.at(b, h) + (long long)row * dqv_acc.rs + 2 * t;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          atomicAdd(dst + dt * 8, acc[dt][2 * r] * scale);
          atomicAdd(dst + dt * 8 + 1, acc[dt][2 * r + 1] * scale);
        }
      }
    }

    // dV += A^T dO and dK += dS^T qu for this warp's 16 keys
    {
      const int k0 = warp * 16 + g;
#pragma unroll
      for (int kk = 0; kk < XB_TILE / 16; ++kk) {
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
          const bf16* ut = &sQuT[(dt * 8 + g) * LDT + c0];
          mma_16816(dv_acc[dt], pa, ld_b32(ot), ld_b32(ot + 8));
          mma_16816(dk_acc[dt], sa, ld_b32(ut), ld_b32(ut + 8));
        }
      }
    }

    // strip dP = D^T qv: this warp's strip tiles warp + 4 (final once the
    // carry from the previous query tile is added) and warp (carried)
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int mt = pass == 0 ? warp + XB_WARPS : warp;
      float acc[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
      const int m0 = mt * 16 + g;
#pragma unroll
      for (int kk = 0; kk < XB_TILE / 16; ++kk) {
        const int c0 = kk * 16 + 2 * t;
        uint32_t a[4];
        a[0] = ld_b32(&sDfT[m0 * LDT + c0]);
        a[1] = ld_b32(&sDfT[(m0 + 8) * LDT + c0]);
        a[2] = ld_b32(&sDfT[m0 * LDT + c0 + 8]);
        a[3] = ld_b32(&sDfT[(m0 + 8) * LDT + c0 + 8]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const bf16* vt = &sQvT[(dt * 8 + g) * LDT + c0];
          mma_16816(acc[dt], a, ld_b32(vt), ld_b32(vt + 8));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* carry = sCarry + (warp * 16 + g + 8 * r) * HD + 2 * t;
        if (pass == 0) {
          const int grow = s0 + m0 + 8 * r;
          const bool live = grow >= 0 && grow < n_pos;
          float* dst = dp_h + (long long)grow * HD + 2 * t;
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt) {
            if (live) {
              atomicAdd(dst + dt * 8, (acc[dt][2 * r] + carry[dt * 8]) * scale);
              atomicAdd(dst + dt * 8 + 1, (acc[dt][2 * r + 1] + carry[dt * 8 + 1]) * scale);
            }
          }
        } else {
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt) {
            carry[dt * 8] = acc[dt][2 * r];
            carry[dt * 8 + 1] = acc[dt][2 * r + 1];
          }
        }
      }
    }
  }

  // the last query tile's carried strip rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int grow = s0 + warp * 16 + g + 8 * r;
    if (grow < 0 || grow >= n_pos) continue;
    const float* carry = sCarry + (warp * 16 + g + 8 * r) * HD + 2 * t;
    float* dst = dp_h + (long long)grow * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      atomicAdd(dst + dt * 8, carry[dt * 8] * scale);
      atomicAdd(dst + dt * 8 + 1, carry[dt * 8 + 1] * scale);
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
template <int HD, bool BIAS>
static int launch_xl_bwd(int batch, int n, int heads, void* stream, Rows<const bf16> qu,
                         Rows<const bf16> qv, Rows<const bf16> k, Rows<const bf16> v,
                         Rows<const bf16> dout, const float* bias_u, const float* bias_v,
                         const bf16* p, long long p_hs, long long p_rs, const int* band,
                         const float* lse, const float* delta, Rows<float> dqu_acc,
                         Rows<float> dqv_acc, float* dp_acc, Rows<bf16> dk, Rows<bf16> dv,
                         float sm_scale) {
  constexpr int bytes = XbSmem<HD, BIAS>::BYTES;
  static_assert(bytes <= 232448, "a block's shared memory on sm_90");
  cudaError_t err = cudaFuncSetAttribute(xl_bwd_kernel<HD, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + XB_TILE - 1) / XB_TILE, heads, batch);
  xl_bwd_kernel<HD, BIAS><<<grid, XB_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      qu, qv, k, v, dout, bias_u, bias_v, p, p_hs, p_rs, band, lse, delta, dqu_acc, dqv_acc,
      dp_acc, dk, dv, n, sm_scale, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s

