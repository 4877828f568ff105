// Swin window attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/window_attention.py
// :_window_forward (line 145, kernel body _window_kernel line 88): per window
// and head
//   O = softmax(scale * Q K^T + bias[h] + shift[w mod nW]) V
// with scores and softmax in f32, exp(S - max) rounded to bf16 before the P V
// product and the row sum divided out afterwards, as the TPU kernel does.
// q, k, v are read as [B*nW, 64, H, 24] views by stride (the lane slices of the
// qkv projection, no transpose); bias is [H, 64, 64] f32, shift [nW, 64, 64]
// f32 (0 / -100, additive, finite) or absent.
//
// What bounds it: 393 KFLOP against 12 KB of q, k, v, o per (window, head),
// 32 FLOP/byte, far below the H100's ~295 FLOP/byte ridge: the bytes bound it.
// Design: the TPU kernel packs eight windows into a 512-row tile for its matrix
// unit and masks the cross-window scores; here one block of 4 warps takes one
// (window, head) pair, so no cross-window score is ever formed and bias and
// shift are read from the small unexpanded tensors. Blocks of neighbouring
// heads run next to each other (head is the fast grid index), so the 48-byte
// head slices of one 64-token row share their L2 sectors. Each warp owns 16
// query rows: S with mma.sync m16n8k16 over the head dim padded 24 -> 32 with
// zeros in shared memory, the softmax in registers (a full row lives in one
// quad), then P V over V staged transposed. This is the plain first version:
// no TMA, no wgmma, one window per block.

#include "window.cuh"

namespace t4s {

__global__ void __launch_bounds__(WA_THREADS)
window_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ shift, bf16* __restrict__ o, int heads,
                  int n_windows, long long q_ws, long long q_rs, long long k_ws, long long k_rs,
                  long long v_ws, long long v_rs, long long o_ws, long long o_rs, float scale) {
  __shared__ __align__(16) bf16 sQ[WA_N * WA_LD];
  __shared__ __align__(16) bf16 sK[WA_N * WA_LD];
  __shared__ __align__(16) bf16 sVt[WA_D * WA_LDT];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.x % heads;
  const long long w = blockIdx.x / heads;
  const long long lane0 = (long long)hh * WA_D;

  zero_pad_lanes(sQ);
  zero_pad_lanes(sK);
  load_rows<WA_D, WA_THREADS>(sQ, WA_LD, q + w * q_ws + lane0, q_rs, WA_N, WA_N);
  load_rows<WA_D, WA_THREADS>(sK, WA_LD, k + w * k_ws + lane0, k_rs, WA_N, WA_N);
  load_rows_transposed<WA_D, WA_THREADS>(sVt, WA_LDT, v + w * v_ws + lane0, v_rs, WA_N, WA_N);
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's query rows r0, r0 + 8
  float s[WA_N / 8][4], l[2];
  window_scores(s, sQ, sK, bias + (long long)hh * WA_N * WA_N,
                shift != nullptr ? shift + (w % n_windows) * WA_N * WA_N : nullptr, r0, g, t,
                scale);
  window_softmax(s, l);

  float acc[WA_D / 8][4];
#pragma unroll
  for (int dt = 0; dt < WA_D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WA_N / 16; ++kk) {
    uint32_t a[4];
    rows_to_a(a, s, kk);
#pragma unroll
    for (int dt = 0; dt < WA_D / 8; ++dt) {
      const bf16* vt = &sVt[(dt * 8 + g) * WA_LDT + kk * 16 + 2 * t];
      mma_16816(acc[dt], a, ld_b32(vt), ld_b32(vt + 8));
    }
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  store_rows(o + w * o_ws + (long long)r0 * o_rs + lane0, o_rs, acc, inv, t);
}

}  // namespace t4s

// q/k/v/o: bf16 [B*nW, 64, H, 24] views (unit lane stride, head stride 24,
// window and row strides in elements, multiples of 8); bias: f32 [H, 64, 64]
// contiguous; shift: f32 [nW, 64, 64] contiguous or null, window w uses
// shift[w mod n_windows]. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int t4s_window_fwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* shift, void* o, int bnw, int n, int heads, int head_dim,
                              int n_windows, long long q_ws, long long q_rs, long long k_ws,
                              long long k_rs, long long v_ws, long long v_rs, long long o_ws,
                              long long o_rs, float sm_scale, void* stream) {
  using namespace t4s;
  if (n != WA_N || head_dim != WA_D || bnw < 1 || heads < 1 || n_windows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)bnw * heads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  window_fwd_kernel<<<static_cast<unsigned>(blocks), WA_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(shift), static_cast<bf16*>(o),
      heads, n_windows, q_ws, q_rs, k_ws, k_rs, v_ws, v_rs, o_ws, o_rs, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
