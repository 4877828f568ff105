// Heads-in-lanes flash attention forward for Hopper (sm_90a), two entry points.
//
// t4s_flash_nhd_fwd replaces the Pallas TPU kernel
// transformer4sed_tpu/kernels/flash_attention.py:_flash_nhd_forward (line 507,
// kernel body _flash_nhd_kernel line 482): softmax(scale * Q K^T) V per head,
// no mask, with q/k/v read as [B, N, H*d] lane slices of the qkv projection
// (no head transposes). t4s_flash_nhd_fwd_lse replaces
// :_flash_nhd_forward_lse (line 579, body _flash_nhd_lse_kernel line 560): the
// same kernel with WITH_LSE, which also writes the natural-log row
// log-sum-exp lse [B, H, N] f32 that the backward (flash_attention_bwd.cu)
// recomputes the probabilities from.
//
// What bounds it: at the PaSST shape (B=8, N=1190, H=12, d=64) the two
// products are 34.8 GFLOP against 58.5 MB of q/k/v/o, about 600 FLOP per
// byte, above the H100's ~295 FLOP/byte ridge: the tensor cores bound it.
// Design: scores and probabilities never leave registers. One block of
// 4 warps owns 64 query rows of one (batch, head); each warp keeps its
// 16 rows' Q fragments in registers and runs mma.sync m16n8k16 (bf16 in,
// f32 accumulate) over 64-key K/V tiles staged in shared memory, with an
// f32 online softmax (exp2, running max and sum per row). The ragged key
// tail (N = 1190 is not a multiple of 64) is masked to -inf in-kernel; no
// operand is padded or copied. This is the plain first version: no TMA,
// no wgmma, no double buffering of the K/V tiles.

#include "mma.cuh"

namespace t4s {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 128;
constexpr int FA_PAD = 8;

template <int HD, bool WITH_LSE>
__global__ void __launch_bounds__(FA_THREADS)
flash_nhd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int n,
                 long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                 long long v_bs, long long v_rs, long long o_bs, long long o_rs,
                 float scale_log2) {
  constexpr int LD = HD + FA_PAD;      // pitch of the Q and K tiles
  constexpr int LDV = FA_BK + FA_PAD;  // pitch of the transposed V tile
  __shared__ __align__(16) unsigned char smem[(2 * FA_BQ * LD + HD * LDV) * sizeof(bf16)];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + FA_BQ * LD;
  bf16* sVt = sK + FA_BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * q_bs + (long long)h * HD;
  const bf16* kb = k + b * k_bs + (long long)h * HD;
  const bf16* vb = v + b * v_bs + (long long)h * HD;

  load_rows<HD, FA_THREADS>(sQ, LD, qb + (long long)i0 * q_rs, q_rs, FA_BQ, n - i0);
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

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j0 = 0; j0 < n; j0 += FA_BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD, FA_THREADS>(sK, LD, kb + (long long)j0 * k_rs, k_rs, FA_BK, n - j0);
    load_rows_transposed<HD, FA_THREADS>(sVt, LDV, vb + (long long)j0 * v_rs, v_rs, FA_BK, n - j0);
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

    // scale into the exp2 domain, mask the ragged key tail, row maxima
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < n ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // rows with no valid key yet
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
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

}  // namespace t4s

// q/k/v: bf16, [B, N, H*64] views with unit stride along the lane dim and
// batch/row strides in elements (multiples of 8); o: bf16 [B, N, H*d].
// Returns cudaGetLastError() after the launch (0 = launched).
// lse: null, or f32 [B, H, N] contiguous (natural log).
static int launch_flash(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch, int n, int heads, int head_dim, long long q_bs,
                        long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                        long long v_rs, long long o_bs, long long o_rs, float sm_scale,
                        void* stream) {
  using namespace t4s;
  const dim3 grid((n + FA_BQ - 1) / FA_BQ, heads, batch);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (lp != nullptr)
    flash_nhd_kernel<64, true><<<grid, FA_THREADS, 0, st>>>(
        qp, kp, vp, op, lp, n, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale_log2);
  else
    flash_nhd_kernel<64, false><<<grid, FA_THREADS, 0, st>>>(
        qp, kp, vp, op, lp, n, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int t4s_flash_nhd_fwd(const void* q, const void* k, const void* v, void* o,
                                 int batch, int n, int heads, int head_dim,
                                 long long q_bs, long long q_rs, long long k_bs,
                                 long long k_rs, long long v_bs, long long v_rs,
                                 long long o_bs, long long o_rs, float sm_scale,
                                 void* stream) {
  return launch_flash(q, k, v, o, nullptr, batch, n, heads, head_dim, q_bs, q_rs, k_bs, k_rs,
                      v_bs, v_rs, o_bs, o_rs, sm_scale, stream);
}

extern "C" int t4s_flash_nhd_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int batch, int n, int heads, int head_dim,
                                     long long q_bs, long long q_rs, long long k_bs,
                                     long long k_rs, long long v_bs, long long v_rs,
                                     long long o_bs, long long o_rs, float sm_scale,
                                     void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_flash(q, k, v, o, lse, batch, n, heads, head_dim, q_bs, q_rs, k_bs, k_rs,
                      v_bs, v_rs, o_bs, o_rs, sm_scale, stream);
}
