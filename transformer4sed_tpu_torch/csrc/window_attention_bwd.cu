// Swin window attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/window_attention.py
// :_window_backward (line 260, kernel body _window_backward_kernel line 198).
// No log-sum-exp is saved: per window and head the scores and the softmax are
// recomputed, and from the saved forward output O and the cotangent G
//   P     = softmax(scale * Q K^T + bias[h] + shift[w mod nW])      (f32)
//   delta = rowsum(G * O)                                            (f32)
//   dV    = P^T G                       (P rounded to bf16)
//   dS    = P * (G V^T - delta)         (f32)
//   dQ    = scale * dS K,  dK = scale * dS^T Q   (dS rounded to bf16)
//   dbias[h] = sum over all windows of dS, dshift[r] = sum over heads and over
//   the windows w with w mod nW = r of dS   (from the f32 dS)
// with the TPU kernel's rounding points. q, k, v, o, g are [B*nW, 64, H, 24]
// views read by stride; dq, dk, dv are written contiguous.
//
// What bounds it: five 64 x 64 x 24 products against ~27 KB of operands and
// results per (window, head), under 40 FLOP/byte: the bytes bound it.
// Design: the TPU kernel revisits dbias/dshift accumulators along its
// sequential grid; Hopper blocks run in no order, so one block owns one head
// and one window position r and walks over a slice of the images. Every window
// it sees adds its dS to the same [64][64] slice of dbias[h] and of dshift[r],
// so that sum is carried in registers (32 floats per thread) and added to
// device memory once per block with f32 atomicAdd: 4096 adds per tensor and
// block instead of per window. Within a window each of the 4 warps recomputes
// its 16 query rows of S and G V^T with mma.sync m16n8k16 (head dim padded
// 24 -> 32 with zeros in shared memory), forms P and dS in registers,
// multiplies dS K straight from them, and parks P^T and dS^T in shared memory,
// from which each warp multiplies its 16 keys' rows into dV and dK. This is the
// plain first version: no TMA, no wgmma, scalar transposed stores.

#include "window.cuh"

namespace t4s {

constexpr int WB_ROW_TILE = WA_N * WA_LD * 2;  // bytes of a row-major [64][40] tile
constexpr int WB_T_TILE = WA_D * WA_LDT * 2;   // transposed [24][72]
constexpr int WB_S_TILE = WA_N * WA_LDT * 2;   // P^T / dS^T [64][72]
constexpr int WB_Q_OFF = 0;
constexpr int WB_K_OFF = WB_Q_OFF + WB_ROW_TILE;
constexpr int WB_V_OFF = WB_K_OFF + WB_ROW_TILE;
constexpr int WB_G_OFF = WB_V_OFF + WB_ROW_TILE;
constexpr int WB_QT_OFF = WB_G_OFF + WB_ROW_TILE;
constexpr int WB_KT_OFF = WB_QT_OFF + WB_T_TILE;
constexpr int WB_GT_OFF = WB_KT_OFF + WB_T_TILE;
constexpr int WB_PT_OFF = WB_GT_OFF + WB_T_TILE;
constexpr int WB_DST_OFF = WB_PT_OFF + WB_S_TILE;
constexpr int WB_D_OFF = WB_DST_OFF + WB_S_TILE;
constexpr int WB_BYTES = WB_D_OFF + WA_N * 4;
// blocks aimed at per launch: a few waves of the card's 132 SMs
constexpr int WB_TARGET_BLOCKS = 2048;

__global__ void __launch_bounds__(WA_THREADS)
window_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ bias,
                  const float* __restrict__ shift, bf16* __restrict__ dq, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ dbias, float* __restrict__ dshift,
                  int heads, int n_w, int n_per, int n_chunks, long long q_ws, long long q_rs,
                  long long k_ws, long long k_rs, long long v_ws, long long v_rs, long long o_ws,
                  long long o_rs, long long g_ws, long long g_rs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + WB_Q_OFF);
  bf16* sK = reinterpret_cast<bf16*>(smem + WB_K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + WB_V_OFF);
  bf16* sG = reinterpret_cast<bf16*>(smem + WB_G_OFF);
  bf16* sQt = reinterpret_cast<bf16*>(smem + WB_QT_OFF);
  bf16* sKt = reinterpret_cast<bf16*>(smem + WB_KT_OFF);
  bf16* sGt = reinterpret_cast<bf16*>(smem + WB_GT_OFF);
  bf16* sPt = reinterpret_cast<bf16*>(smem + WB_PT_OFF);
  bf16* sdSt = reinterpret_cast<bf16*>(smem + WB_DST_OFF);
  float* sD = reinterpret_cast<float*>(smem + WB_D_OFF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.x % heads;
  const int r = (blockIdx.x / heads) % n_w;      // window position inside the image
  const int chunk = blockIdx.x / (heads * n_w);  // slice of the images
  const long long lane0 = (long long)hh * WA_D;
  const long long out_rs = (long long)heads * WA_D;  // dq/dk/dv are contiguous [B*nW, 64, H*24]
  const float* bias_h = bias + (long long)hh * WA_N * WA_N;
  const float* shift_w = shift != nullptr ? shift + (long long)r * WA_N * WA_N : nullptr;

  zero_pad_lanes(sQ);
  zero_pad_lanes(sK);
  zero_pad_lanes(sV);
  zero_pad_lanes(sG);

  float ds_sum[WA_N / 8][4];  // this block's share of dbias[hh] and dshift[r]
#pragma unroll
  for (int nt = 0; nt < WA_N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds_sum[nt][e] = 0.f;

  const int r0 = warp * 16 + g;  // this thread's query rows r0, r0 + 8, and its keys below
  const float scale2[2] = {scale, scale}, one2[2] = {1.f, 1.f};
  for (int i = chunk; i < n_per; i += n_chunks) {
    const long long w = r + (long long)n_w * i;
    const bf16* qw = q + w * q_ws + lane0;
    const bf16* kw = k + w * k_ws + lane0;
    const bf16* gw = dout + w * g_ws + lane0;
    const bf16* ow = o + w * o_ws + lane0;
    __syncthreads();  // the previous window's tiles are consumed
    load_rows<WA_D, WA_THREADS>(sQ, WA_LD, qw, q_rs, WA_N, WA_N);
    load_rows_transposed<WA_D, WA_THREADS>(sQt, WA_LDT, qw, q_rs, WA_N, WA_N);
    load_rows<WA_D, WA_THREADS>(sK, WA_LD, kw, k_rs, WA_N, WA_N);
    load_rows_transposed<WA_D, WA_THREADS>(sKt, WA_LDT, kw, k_rs, WA_N, WA_N);
    load_rows<WA_D, WA_THREADS>(sV, WA_LD, v + w * v_ws + lane0, v_rs, WA_N, WA_N);
    load_rows<WA_D, WA_THREADS>(sG, WA_LD, gw, g_rs, WA_N, WA_N);
    load_rows_transposed<WA_D, WA_THREADS>(sGt, WA_LDT, gw, g_rs, WA_N, WA_N);
    for (int row = threadIdx.x; row < WA_N; row += WA_THREADS) {
      const bf16* gr = gw + (long long)row * g_rs;
      const bf16* orow = ow + (long long)row * o_rs;
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < WA_D; ++j) d += __bfloat162float(gr[j]) * __bfloat162float(orow[j]);
      sD[row] = d;
    }
    __syncthreads();

    // P = softmax(S) and dP = G V^T for this warp's 16 query rows
    float s[WA_N / 8][4], l[2];
    window_scores(s, sQ, sK, bias_h, shift_w, r0, g, t, scale);
    window_softmax(s, l);
    uint32_t gf[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      gf[kk][0] = ld_b32(&sG[r0 * WA_LD + c0]);
      gf[kk][1] = ld_b32(&sG[(r0 + 8) * WA_LD + c0]);
      gf[kk][2] = ld_b32(&sG[r0 * WA_LD + c0 + 8]);
      gf[kk][3] = ld_b32(&sG[(r0 + 8) * WA_LD + c0 + 8]);
    }
    float ds[WA_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < WA_N / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = 0.f;
      const bf16* vr = &sV[(nt * 8 + g) * WA_LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_16816(ds[nt], gf[kk], ld_b32(vr + kk * 16), ld_b32(vr + kk * 16 + 8));
    }

    // dS = P (dP - delta) in f32; P^T and dS^T (bf16) to shared memory
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
    const float dl[2] = {sD[r0], sD[r0 + 8]};
#pragma unroll
    for (int nt = 0; nt < WA_N / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = r0 + 8 * (e >> 1), c = nt * 8 + 2 * t + (e & 1);
        const float p = s[nt][e] * inv[e >> 1];
        const float d = p * (ds[nt][e] - dl[e >> 1]);
        ds[nt][e] = d;
        ds_sum[nt][e] += d;
        sPt[c * WA_LDT + rl] = __float2bfloat16(p);
        sdSt[c * WA_LDT + rl] = __float2bfloat16(d);
      }
    }

    // dQ = scale * dS K for this warp's 16 query rows
    float acc[WA_D / 8][4];
#pragma unroll
    for (int dt = 0; dt < WA_D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WA_N / 16; ++kk) {
      uint32_t a[4];
      rows_to_a(a, ds, kk);
#pragma unroll
      for (int dt = 0; dt < WA_D / 8; ++dt) {
        const bf16* kt = &sKt[(dt * 8 + g) * WA_LDT + kk * 16 + 2 * t];
        mma_16816(acc[dt], a, ld_b32(kt), ld_b32(kt + 8));
      }
    }
    const long long out0 = (w * WA_N + r0) * out_rs + lane0;
    store_rows(dq + out0, out_rs, acc, scale2, t);
    __syncthreads();  // P^T and dS^T of all four warps are in place

    // dV = P^T G and dK = scale * dS^T Q for this warp's 16 keys
    float dk_acc[WA_D / 8][4];
#pragma unroll
    for (int dt = 0; dt < WA_D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = dk_acc[dt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WA_N / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      uint32_t pa[4], sa[4];
      pa[0] = ld_b32(&sPt[r0 * WA_LDT + c0]);
      pa[1] = ld_b32(&sPt[(r0 + 8) * WA_LDT + c0]);
      pa[2] = ld_b32(&sPt[r0 * WA_LDT + c0 + 8]);
      pa[3] = ld_b32(&sPt[(r0 + 8) * WA_LDT + c0 + 8]);
      sa[0] = ld_b32(&sdSt[r0 * WA_LDT + c0]);
      sa[1] = ld_b32(&sdSt[(r0 + 8) * WA_LDT + c0]);
      sa[2] = ld_b32(&sdSt[r0 * WA_LDT + c0 + 8]);
      sa[3] = ld_b32(&sdSt[(r0 + 8) * WA_LDT + c0 + 8]);
#pragma unroll
      for (int dt = 0; dt < WA_D / 8; ++dt) {
        const bf16* gt = &sGt[(dt * 8 + g) * WA_LDT + c0];
        const bf16* qt = &sQt[(dt * 8 + g) * WA_LDT + c0];
        mma_16816(acc[dt], pa, ld_b32(gt), ld_b32(gt + 8));
        mma_16816(dk_acc[dt], sa, ld_b32(qt), ld_b32(qt + 8));
      }
    }
    store_rows(dv + out0, out_rs, acc, one2, t);
    store_rows(dk + out0, out_rs, dk_acc, scale2, t);
  }

#pragma unroll
  for (int nt = 0; nt < WA_N / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = (r0 + 8 * (e >> 1)) * WA_N + nt * 8 + 2 * t + (e & 1);
      atomicAdd(dbias + (long long)hh * WA_N * WA_N + off, ds_sum[nt][e]);
      if (dshift != nullptr) atomicAdd(dshift + (long long)r * WA_N * WA_N + off, ds_sum[nt][e]);
    }
  }
}

}  // namespace t4s

// q/k/v/o/dout: bf16 [B*nW, 64, H, 24] views (unit lane stride, head stride
// 24, window and row strides in elements, multiples of 8); bias: f32
// [H, 64, 64]; shift: f32 [nW, 64, 64] or null (then n_windows is not read and
// every window is alike); dq/dk/dv: bf16 [B*nW, 64, H, 24] contiguous; dbias:
// f32 [H, 64, 64] and dshift: f32 [nW, 64, 64] (null exactly when shift is),
// both zeroed by the caller (summed into with atomics). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int t4s_window_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* bias, const void* shift, void* dq,
                              void* dk, void* dv, void* dbias, void* dshift, int bnw, int n,
                              int heads, int head_dim, int n_windows, long long q_ws,
                              long long q_rs, long long k_ws, long long k_rs, long long v_ws,
                              long long v_rs, long long o_ws, long long o_rs, long long g_ws,
                              long long g_rs, float sm_scale, void* stream) {
  using namespace t4s;
  if (n != WA_N || head_dim != WA_D || bnw < 1 || heads < 1 ||
      (shift == nullptr) != (dshift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_w = shift != nullptr ? n_windows : 1;
  if (n_w < 1 || bnw % n_w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_per = bnw / n_w;
  const long long groups = (long long)heads * n_w;
  long long n_chunks = (WB_TARGET_BLOCKS + groups - 1) / groups;
  if (n_chunks > n_per) n_chunks = n_per;
  cudaError_t err = cudaFuncSetAttribute(window_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WB_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_bwd_kernel<<<static_cast<unsigned>(groups * n_chunks), WA_THREADS, WB_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(bias), static_cast<const float*>(shift), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dbias),
      static_cast<float*>(dshift), heads, n_w, n_per, static_cast<int>(n_chunks), q_ws, q_rs,
      k_ws, k_rs, v_ws, v_rs, o_ws, o_rs, g_ws, g_rs, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
