// Fused heads-in-lanes Transformer-XL attention forward for Hopper (sm_90a),
// two entry points.
//
// t4s_xl_nhd_fwd replaces the Pallas TPU kernel
// transformer4sed_tpu/kernels/xl_attention.py:_xl_nhd_forward (line 648,
// kernel body _xl_row_nhd_kernel line 613 with _row_scores :180, _valid_mask
// :161, _roll_rows_left :143, _geometry :399); t4s_xl_nhd_fwd_lse replaces
// :_xl_nhd_forward_lse (line 734, body _xl_row_nhd_lse_kernel line 701): the
// same kernel with WITH_LSE, which also writes the natural-log row
// log-sum-exp lse [B, H, T] f32 for the backward (xl_attention_bwd.cu).
//   softmax(scale * ((q+u) K^T + relshift((q+v) P^T))) V
// with q/k/v as [B, T, H*d] lane slices, u/v = pos_bias_u/pos_bias_v [H, d]
// added in f32 in-kernel and rounded to bf16, P the projected position
// table [H, 2T-1, d] (offsets T-1 ... -(T-1)), and an optional per-head
// band: row i attends [i - w/2, i + w/2) plus i.
//
// What bounds it: at the MAT-SED decoder shape (B=8, T=1000, H=12, d=64)
// the content and position products are 36.9 GFLOP against ~52 MB of
// q/k/v/o/P, far above the H100's ~295 FLOP/byte ridge: the tensor cores
// bound it, and the naive form would instead be bound by the [B,H,T,2T-1]
// position scores and their skewed copy in device memory.
// Design: the rel-shift is index arithmetic. For a (64-row query tile at
// i0, 64-key tile at j0) the needed P rows (T-1) - i + j form one strip of
// 64 + 64 - 1 rows starting at T - i0 - 64 + j0; the block stages 128 strip
// rows in shared memory. Each warp (16 query rows) multiplies its q+v
// fragments by the 80 strip rows it can reach (mma.sync, f32 accumulate),
// parks that 16 x 80 product in its own shared scratch, and reads element
// [r][c + 15 - r] back onto the content scores of row r, column c. Content
// and position scores then share one f32 online softmax and the P.V
// product, as in flash_attention.cu. No [B,H,T,T] or [B,H,T,2T-1] tensor
// reaches device memory; the band mask is generated per element.

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
  static_assert(XL_BQ * LD * 2 <= XL_WARPS * 16 * XL_SLD * 4, "Q tile aliases the scratch");
};

template <int HD, bool WITH_LSE>
__global__ void __launch_bounds__(XL_THREADS)
xl_nhd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ bias_u,
              const float* __restrict__ bias_v, const bf16* __restrict__ p,
              const int* __restrict__ band, bf16* __restrict__ o,
              float* __restrict__ lse, int n,
              long long q_bs, long long q_rs, long long k_bs, long long k_rs,
              long long v_bs, long long v_rs, long long p_hs, long long p_rs,
              long long o_bs, long long o_rs, float scale_log2) {
  using L = XlSmem<HD>;
  constexpr int LD = L::LD, LDV = L::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sVt = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::S_OFF);  // only before the key loop

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * XL_BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_pos = 2 * n - 1;
  const bf16* kb = k + b * k_bs + (long long)h * HD;
  const bf16* vb = v + b * v_bs + (long long)h * HD;
  const bf16* pb = p + (long long)h * p_hs;
  const float* bu = bias_u + h * HD;
  const float* bv = bias_v + h * HD;
  const int half = band != nullptr ? band[h] / 2 : 0;

  load_rows<HD, XL_THREADS>(sQ, LD, q + b * q_bs + (long long)h * HD + (long long)i0 * q_rs,
                            q_rs, XL_BQ, n - i0);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qu[HD / 16][4], qv[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = r0 + 8 * (f & 1), col = kk * 16 + 2 * t + 8 * (f >> 1);
      const float x0 = __bfloat162float(sQ[row * LD + col]);
      const float x1 = __bfloat162float(sQ[row * LD + col + 1]);
      qu[kk][f] = pack_bf16(x0 + bu[col], x1 + bu[col + 1]);
      qv[kk][f] = pack_bf16(x0 + bv[col], x1 + bv[col + 1]);
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
    load_rows<HD, XL_THREADS>(sK, LD, kb + (long long)j0 * k_rs, k_rs, XL_BK, n - j0);
    load_rows_transposed<HD, XL_THREADS>(sVt, LDV, vb + (long long)j0 * v_rs, v_rs, XL_BK, n - j0);
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
    bf16* orow = o + b * o_bs + (long long)row * o_rs + (long long)h * HD;
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

template <int HD, bool WITH_LSE>
static int launch_xl(const dim3& grid, cudaStream_t st, const bf16* q, const bf16* k,
                     const bf16* v, const float* bu, const float* bv, const bf16* p,
                     const int* band, bf16* o, float* lse, int n, long long q_bs,
                     long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                     long long v_rs, long long p_hs, long long p_rs, long long o_bs,
                     long long o_rs, float scale_log2) {
  constexpr int bytes = XlSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(xl_nhd_kernel<HD, WITH_LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  xl_nhd_kernel<HD, WITH_LSE><<<grid, XL_THREADS, bytes, st>>>(
      q, k, v, bu, bv, p, band, o, lse, n, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, p_hs, p_rs, o_bs,
      o_rs, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s

// q/k/v: bf16 [B, T, H*d] views with d = 64 (unit lane stride, strides in
// elements, multiples of 8); bias_u/bias_v: f32 [H, d] contiguous; p: bf16 [H, 2T-1, d]
// with head/row strides; band: int32 [H] widths on the device, or null for
// full attention; o: bf16 [B, T, H*d]; lse (the _lse entry point only): f32
// [B, H, T] contiguous. Returns cudaGetLastError() after the launch
// (0 = launched).
static int xl_fwd(const void* q, const void* k, const void* v, const void* bias_u,
                  const void* bias_v, const void* p, const void* band, void* o, void* lse,
                  int batch, int n, int heads, int head_dim, long long q_bs, long long q_rs,
                  long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                  long long p_hs, long long p_rs, long long o_bs, long long o_rs,
                  float sm_scale, void* stream) {
  using namespace t4s;
  const dim3 grid((n + XL_BQ - 1) / XL_BQ, heads, batch);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *pp = static_cast<const bf16*>(p);
  const float *bu = static_cast<const float*>(bias_u), *bv = static_cast<const float*>(bias_v);
  const int* bw = static_cast<const int*>(band);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (lp != nullptr)
    return launch_xl<64, true>(grid, st, qp, kp, vp, bu, bv, pp, bw, op, lp, n, q_bs, q_rs, k_bs,
                               k_rs, v_bs, v_rs, p_hs, p_rs, o_bs, o_rs, scale_log2);
  return launch_xl<64, false>(grid, st, qp, kp, vp, bu, bv, pp, bw, op, lp, n, q_bs, q_rs, k_bs,
                              k_rs, v_bs, v_rs, p_hs, p_rs, o_bs, o_rs, scale_log2);
}

extern "C" int t4s_xl_nhd_fwd(const void* q, const void* k, const void* v, const void* bias_u,
                              const void* bias_v, const void* p, const void* band, void* o,
                              int batch, int n, int heads, int head_dim, long long q_bs,
                              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                              long long v_rs, long long p_hs, long long p_rs, long long o_bs,
                              long long o_rs, float sm_scale, void* stream) {
  return xl_fwd(q, k, v, bias_u, bias_v, p, band, o, nullptr, batch, n, heads, head_dim, q_bs,
                q_rs, k_bs, k_rs, v_bs, v_rs, p_hs, p_rs, o_bs, o_rs, sm_scale, stream);
}

extern "C" int t4s_xl_nhd_fwd_lse(const void* q, const void* k, const void* v,
                                  const void* bias_u, const void* bias_v, const void* p,
                                  const void* band, void* o, void* lse, int batch, int n,
                                  int heads, int head_dim, long long q_bs, long long q_rs,
                                  long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                                  long long p_hs, long long p_rs, long long o_bs, long long o_rs,
                                  float sm_scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return xl_fwd(q, k, v, bias_u, bias_v, p, band, o, lse, batch, n, heads, head_dim, q_bs, q_rs,
                k_bs, k_rs, v_bs, v_rs, p_hs, p_rs, o_bs, o_rs, sm_scale, stream);
}
