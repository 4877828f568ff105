// Fused Transformer-XL attention forward for Hopper (sm_90a) on mma.sync: the
// device code of the head-major entry points (xl_attention_hm.cu, rows 9 and
// 10). The heads-in-lanes ones (xl_attention.cu, rows 2 and 12) run
// xl_fwd.cuh, so the BIAS form here has no caller; this file goes when rows 9
// and 10 move to xl_fwd.cuh.
//
//   softmax(scale * (qu K^T + relshift(qv P^T))) V
// per (batch, head), P the projected position table [H, 2T-1, d] (offsets
// T-1 ... -(T-1)), and an optional per-head band: row i attends
// [i - w/2, i + w/2) plus i. Every operand comes as a base pointer with
// batch, head and row strides (Rows, mma.cuh), so a [B, T, H*d] projection slice and a
// [B, H, T, d] tensor are the same to the kernel. With BIAS, qu and qv are one
// tensor q and the kernel forms bf16(q + u) and bf16(q + v) from the f32
// pos_bias_u / pos_bias_v [H, d]; without it, qu and qv are two operands that
// arrive already summed. WITH_LSE also writes the natural-log row log-sum-exp
// lse [B, H, T] f32 for the backward (xl_bwd.cuh). HD is the head dim, a
// multiple of 16; the launchers build 64 (heads-in-lanes) and 32, 64
// (head-major).
//
// What bounds it: content and position products and P.V are 6*T^2*d
// operations per (batch, head) against (4*T + 2*T)*d*2 bytes, far above the
// H100's ~295 FLOP/byte ridge at T = 1000 for d = 32 as for d = 64: the tensor
// cores bound it, and the naive form would instead be bound by the
// [B,H,T,2T-1] position scores and their skewed copy in device memory.
// Design: the rel-shift is index arithmetic. For a (64-row query tile at
// i0, 64-key tile at j0) the needed P rows (T-1) - i + j form one strip of
// 64 + 64 - 1 rows starting at T - i0 - 64 + j0; the block stages 128 strip
// rows in shared memory. Each warp (16 query rows) multiplies its qv
// fragments by the 80 strip rows it can reach (mma.sync, f32 accumulate),
// parks that 16 x 80 product in its own shared scratch, and reads element
// [r][c + 15 - r] back onto the content scores of row r, column c. Content
// and position scores then share one f32 online softmax over the key tiles
// (any T, ragged tails masked) and the P.V product, as in flash_attention.cu.
// No [B,H,T,T] or [B,H,T,2T-1] tensor reaches device memory; the band mask
// is generated per element. The strip geometry depends on the tile sizes
// only, not on HD; the shared-memory pitch HD + 8 keeps the fragment loads
// conflict-free at HD = 32 (20-word rows) as at 64 (36-word rows).
#pragma once

#include "mma.cuh"

namespace t4s {

constexpr int XL_BQ = 64;
constexpr int XL_BK = 64;
constexpr int XL_WARPS = 4;
constexpr int XL_THREADS = 32 * XL_WARPS;
constexpr int XL_PAD = 8;
constexpr int XL_STRIP = XL_BK + 16;             // strip columns a warp reaches (79, rounded up)
constexpr int XL_PROWS = XL_BQ - 16 + XL_STRIP;  // strip rows the block stages (128)
constexpr int XL_SLD = XL_STRIP + 4;             // pitch of a warp's f32 scratch

template <int HD>
struct XlSmem {
  static constexpr int LD = HD + XL_PAD;
  static constexpr int LDV = XL_BK + XL_PAD;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + XL_BK * LD * 2;
  static constexpr int P_OFF = V_OFF + HD * LDV * 2;
  static constexpr int S_OFF = P_OFF + XL_PROWS * LD * 2;
  static constexpr int BYTES = S_OFF + XL_WARPS * 16 * XL_SLD * 4;
  static_assert(2 * XL_BQ * LD * 2 <= XL_WARPS * 16 * XL_SLD * 4,
                "the qu and qv tiles alias the scratch");
};

template <int HD, bool WITH_LSE, bool BIAS>
__global__ void __launch_bounds__(XL_THREADS)
xl_fwd_kernel(Rows<const bf16> qu_in, Rows<const bf16> qv_in, Rows<const bf16> k,
              Rows<const bf16> v, const float* __restrict__ bias_u,
              const float* __restrict__ bias_v, const bf16* __restrict__ p, long long p_hs,
              long long p_rs, const int* __restrict__ band, Rows<bf16> o,
              float* __restrict__ lse, int n, float scale_log2) {
  using L = XlSmem<HD>;
  constexpr int LD = L::LD, LDV = L::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sVt = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sQu = reinterpret_cast<bf16*>(smem + L::S_OFF);  // only before the key loop
  bf16* sQv = sQu + XL_BQ * LD;                           // (without BIAS)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * XL_BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_pos = 2 * n - 1;
  const bf16* kb = k.at(b, h);
  const bf16* vb = v.at(b, h);
  const bf16* pb = p + (long long)h * p_hs;
  const int half = band != nullptr ? band[h] / 2 : 0;

  load_rows<HD, XL_THREADS>(sQu, LD, qu_in.at(b, h) + (long long)i0 * qu_in.rs, qu_in.rs, XL_BQ,
                            n - i0);
  if (!BIAS)
    load_rows<HD, XL_THREADS>(sQv, LD, qv_in.at(b, h) + (long long)i0 * qv_in.rs, qv_in.rs,
                              XL_BQ, n - i0);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qu[HD / 16][4], qv[HD / 16][4];
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
    }
  }

  float* scratch = sS + warp * 16 * XL_SLD;
  const int strip_off = 16 * (XL_WARPS - 1 - warp);  // first strip row this warp reaches
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j0 = 0; j0 < n; j0 += XL_BK) {
    __syncthreads();  // previous tile consumed, Q fragments built
    load_rows<HD, XL_THREADS>(sK, LD, kb + (long long)j0 * k.rs, k.rs, XL_BK, n - j0);
    load_rows_transposed<HD, XL_THREADS>(sVt, LDV, vb + (long long)j0 * v.rs, v.rs, XL_BK, n - j0);
    {
      // position strip: P rows [s0, s0 + XL_PROWS), zero outside [0, 2T-1)
      const int s0 = n - i0 - XL_BQ + j0;
      constexpr int CH = HD / 8;
      for (int c = threadIdx.x; c < XL_PROWS * CH; c += XL_THREADS) {
        const int r = c / CH, cc = (c % CH) * 8, pr = s0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (pr >= 0 && pr < n_pos)
          val = *reinterpret_cast<const uint4*>(pb + (long long)pr * p_rs + cc);
        *reinterpret_cast<uint4*>(sP + r * LD + cc) = val;
      }
    }
    __syncthreads();

    // position product of this warp's rows against its reachable strip
#pragma unroll
    for (int nt = 0; nt < XL_STRIP / 8; ++nt) {
      float pr[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* sr = &sP[(strip_off + nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_16816(pr, qv[kk], ld_b32(sr + kk * 16), ld_b32(sr + kk * 16 + 8));
      float* d0 = scratch + g * XL_SLD + nt * 8 + 2 * t;
      d0[0] = pr[0];
      d0[1] = pr[1];
      d0[8 * XL_SLD] = pr[2];
      d0[8 * XL_SLD + 1] = pr[3];
    }

    float s[XL_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < XL_BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = &sK[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_16816(s[nt], qu[kk], ld_b32(kr + kk * 16), ld_b32(kr + kk * 16 + 8));
    }
    __syncwarp();

    // rel-shift: score (r, c) takes the strip product at (r, c + 15 - r)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < XL_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = g + 8 * (e >> 1), c = nt * 8 + 2 * t + (e & 1);
        const int row = i0 + warp * 16 + rl, col = j0 + c;
        bool ok = col < n;
        if (band != nullptr) ok = ok && ((col >= row - half && col < row + half) || col == row);
        const float pos = scratch[rl * XL_SLD + c + 15 - rl];
        s[nt][e] = ok ? (s[nt][e] + pos) * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // band rows with no key in this tile yet
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < XL_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
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
#pragma unroll
    for (int kk = 0; kk < XL_BK / 16; ++kk) {
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
    // m_run is in the scaled log2 domain; a row with no valid key keeps
    // -inf (never NaN), and the backward gives it zero weight
    if (WITH_LSE && t == 0)
      lse[((long long)b * gridDim.y + h) * n + row] =
          l_run[r] > 0.f ? (m_run[r] + log2f(l_run[r])) * 0.6931471805599453f : -INFINITY;
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = launched).
template <int HD, bool WITH_LSE, bool BIAS>
static int launch_xl_fwd(int batch, int n, int heads, void* stream, Rows<const bf16> qu,
                         Rows<const bf16> qv, Rows<const bf16> k, Rows<const bf16> v,
                         const float* bias_u, const float* bias_v, const bf16* p, long long p_hs,
                         long long p_rs, const int* band, Rows<bf16> o, float* lse,
                         float sm_scale) {
  constexpr int bytes = XlSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(xl_fwd_kernel<HD, WITH_LSE, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + XL_BQ - 1) / XL_BQ, heads, batch);
  xl_fwd_kernel<HD, WITH_LSE, BIAS><<<grid, XL_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      qu, qv, k, v, bias_u, bias_v, p, p_hs, p_rs, band, o, lse, n,
      sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
