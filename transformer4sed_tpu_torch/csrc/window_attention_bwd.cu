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
// with the TPU kernel's rounding points.
//
// What bounds it: five 64 x 64 x 24 products against ~24 KB of operands and
// results per (window, head), under 40 FLOP/byte: the bytes bound it. The TPU
// kernel revisits its dbias / dshift accumulators along its sequential grid;
// Hopper blocks run in no order. Here window.cuh's body (design there) gives
// a block one window position and group of heads over a slice of the images,
// so that every window it sees adds its dS to the same slices of dbias and
// dshift: the sum is carried in registers and added once a block by TMA
// reductions. q, k, v, o and g come by TMA as rows two steps ahead, laid out
// for wgmma by the producer warpgroup into a ring of two stages; the five
// products run on wgmma; dq, dk and dv go out by TMA stores.

#include "window.cuh"

namespace t4s {

constexpr int WB_RAW = 2;    // raw stages: steps whose rows are loading
constexpr int WB_CANON = 2;  // canonical stages
constexpr int WB_NIN = 5;    // q, k, v, o, g
constexpr int WB_CANON_OFF = WB_RAW * WB_NIN * WA_RAW;
// P and dS, 8 KB each a warpgroup
constexpr int WB_PS_OFF = WB_CANON_OFF + WB_CANON * WB_NIN * WA_OP;
constexpr int WB_OUT_OFF = WB_PS_OFF + 4 * 8192;  // 2 x 2 buffers of staged dq, dk, dv rows
constexpr int WB_BAR_OFF = WB_OUT_OFF + 12 * WA_ROWS;
// raw_full[RAW], full[CANON], empty[CANON]; then slack to align the base
constexpr int WB_BYTES = WB_BAR_OFF + (WB_RAW + 2 * WB_CANON) * 8 + 1024;

__global__ void __launch_bounds__(WA_THREADS, 1)
window_bwd_kernel(const __grid_constant__ WaMaps<WB_NIN, 3> maps, const float* __restrict__ bias,
                  const float* __restrict__ shift, WaPlan plan, int fault, float scale,
                  float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* canon = smem + WB_CANON_OFF;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + WB_BAR_OFF);
  uint64_t* full = raw_full + WB_RAW;
  uint64_t* empty = full + WB_CANON;
  const WaWalk wk(plan);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_RAW; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < WB_CANON; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  wa_zero_pad<WB_NIN, WB_CANON>(canon);
  fence_proxy_async();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= WA_CONSUMERS / 32) {
    setmaxnreg_dec<WA_PRODUCER_REGS>();
    wa_produce<WB_NIN, WB_RAW, WB_CANON>(smem, canon, maps.in, raw_full, full, empty, wk,
                                         threadIdx.x - WA_CONSUMERS);
    return;
  }

  setmaxnreg_inc<WA_CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores and reductions
  const int head = wk.head(wg);
  const int k_slot = fault == WA_FAULT_SLOT ? wg ^ 1 : wg;
  unsigned char* sP = smem + WB_PS_OFF + wg * 16384;
  unsigned char* sDS = sP + 8192;
  float bl[32];
  wa_bias(bl, bias + (long long)head * WA_N * WA_N,
          shift != nullptr ? shift + (long long)wk.r * WA_N * WA_N : nullptr, wl, g, t);
  float dsum[32];  // this warpgroup's share of dbias[head] and dshift[r]
#pragma unroll
  for (int i = 0; i < 32; ++i) dsum[i] = 0.f;
  const float scale2[2] = {scale, scale}, one2[2] = {1.f, 1.f};
  // stmatrix: this lane's row r of matrix mi, in the warp's 16 rows of P and dS
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t p_row = smem_u32(sP) + (wl * 16 + (mi & 1) * 8 + mr) * 128;
  const uint32_t ds_row = p_row + 8192;

  for (int st = 0; st < wk.steps; ++st) {
    const int s = st % WB_CANON;
    const int k = wk.index(st, wg);
    if (k < 0) {  // G = 1 and an odd count: no window in this slot
      // the step's loads first, so that the arrival falls in this step's
      // phase of empty[s], not in that of the step WB_CANON steps before,
      // which the other warpgroup may still be reading
      if (issuer) {
        mbar_wait(&full[s], (st / WB_CANON) & 1);
        mbar_arrive(&empty[s]);
      }
      continue;
    }
    const unsigned char* stage = canon + s * WB_NIN * WA_OP;
    const unsigned char* sq = stage + wg * WA_SLOT;
    const unsigned char* sk = stage + WA_OP + k_slot * WA_SLOT;
    const unsigned char* sv = stage + 2 * WA_OP + wg * WA_SLOT;
    const unsigned char* so = stage + 3 * WA_OP + wg * WA_SLOT;
    const unsigned char* sg = stage + 4 * WA_OP + wg * WA_SLOT;
    mbar_wait(&full[s], (st / WB_CANON) & 1);
    __syncwarp();

    // S = Q K^T and dP = G V^T, while delta is summed from the o and g slots
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_ss<0, 0>(sc, lanes_k(sq, kk), lanes_k(sk, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_ss<0, 0>(dp, lanes_k(sg, kk), lanes_k(sv, kk), kk);
    wgmma_commit();
    float dl[2];
    wa_delta(dl, so, sg, wl, g, t);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P = softmax(S), dS = P (dP - delta) in f32; the f32 dS into the sums
    float l[2];
    wa_softmax(sc, bl, scale_log2, l);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      sc[i] *= inv[rr];
      dp[i] = sc[i] * (dp[i] - dl[rr]);
      dsum[i] += dp[i];
    }
    uint32_t pa[4][4], sa[4][4];
    acc_to_a(sc, pa);
    acc_to_a(dp, sa);

    // P and dS (bf16) to shared memory, [64 queries][64 keys], 128-byte swizzle
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t chunk = ((2 * kk + (mi >> 1)) ^ mr) << 4;
      stmatrix_x4(p_row + chunk, pa[kk]);
      stmatrix_x4(ds_row + chunk, sa[kk]);
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);

    // dQ = dS K (dS from registers), dV = P^T G and dK = dS^T Q (P and dS
    // read MN-major); K, G and Q read with their rows as K
    float dq[12], dv[12], dk[12];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, sa[kk], rows_k(sk, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(dv, desc(sP + kk * 2048, 1024, SWIZZLE_128B), rows_k(sg, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(dk, desc(sDS + kk * 2048, 1024, SWIZZLE_128B), rows_k(sq, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(sa);
    if (issuer) mbar_arrive(&empty[s]);  // the slot's q, k, v, o and g are consumed

    // dq, dk, dv rows to this step's staging buffer, then three TMA stores;
    // the stores of the step before have read the other buffer before the barrier
    unsigned char* out = smem + WB_OUT_OFF + (2 * wg + (st & 1)) * 3 * WA_ROWS;
    wa_stage(out, dq, scale2, wl, g, t);
    wa_stage(out + WA_ROWS, dk, scale2, wl, g, t);
    wa_stage(out + 2 * WA_ROWS, dv, one2, wl, g, t);
    fence_proxy_async();
    if (issuer) bulk_wait_read<0>();
    bar_sync(2 + wg, 128);
    if (issuer) {
      const int w = wk.window(k);
#pragma unroll
      for (int i = 0; i < 3; ++i) tma_store_3d(&maps.out[i], out + i * WA_ROWS, head * WA_D, 0, w);
      bulk_commit();
    }
  }

  // the sums, as two f32 boxes of 64 rows x 32 columns in the P and dS
  // buffers, added to dbias[head] and dshift[r]
  bar_sync(2 + wg, 128);  // every warp's last products have read P and dS
  if (!(fault == WA_FAULT_SKIP_REDUCE && wk.chunk == plan.n_chunks - 1)) {
    stage_box<64>(reinterpret_cast<float*>(sP), reinterpret_cast<const float(&)[16]>(dsum[0]),
                  wl, g, t);
    stage_box<64>(reinterpret_cast<float*>(sDS), reinterpret_cast<const float(&)[16]>(dsum[16]),
                  wl, g, t);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (issuer) {
      tma_reduce_add_2d(&maps.sums[0], sP, 0, head * WA_N);
      tma_reduce_add_2d(&maps.sums[0], sDS, 32, head * WA_N);
      if (shift != nullptr) {
        tma_reduce_add_2d(&maps.sums[1], sP, 0, wk.r * WA_N);
        tma_reduce_add_2d(&maps.sums[1], sDS, 32, wk.r * WA_N);
      }
      bulk_commit();
    }
  }
  if (issuer) bulk_wait_all();
}

}  // namespace t4s

// q/k/v/o/dout: bf16 [B*nW, 64, H, 24] lane views (unit lane stride, head
// stride 24, window and row strides in elements, multiples of 8); bias: f32
// [H, 64, 64]; shift: f32 [nW, 64, 64] or null (then n_windows is 1: every
// window is alike); dq/dk/dv: bf16 [B*nW, 64, H, 24] contiguous out; dbias:
// f32 [H, 64, 64] and dshift: f32 [nW, 64, 64] (null exactly when shift is),
// both zeroed by the caller (summed into by TMA reductions). fault as for
// t4s_window_fwd. Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a shape or a stride the kernel does
// not take.
extern "C" int t4s_window_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* bias, const void* shift, void* dq,
                              void* dk, void* dv, void* dbias, void* dshift, int bnw, int n,
                              int heads, int head_dim, int n_windows, int fault, long long q_ws,
                              long long q_rs, long long k_ws, long long k_rs, long long v_ws,
                              long long v_rs, long long o_ws, long long o_rs, long long g_ws,
                              long long g_rs, float sm_scale, void* stream) {
  using namespace t4s;
  WaPlan plan;
  if ((shift == nullptr) != (dshift == nullptr) ||
      !wa_plan(&plan, bnw, n, heads, head_dim, shift != nullptr ? n_windows : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long out_rs = (long long)heads * WA_D, out_ws = WA_N * out_rs;
  WaMaps<WB_NIN, 3> maps;
  if (!row_map(encode, &maps.in[0], q, bnw, heads, q_ws, q_rs, plan.group) ||
      !row_map(encode, &maps.in[1], k, bnw, heads, k_ws, k_rs, plan.group) ||
      !row_map(encode, &maps.in[2], v, bnw, heads, v_ws, v_rs, plan.group) ||
      !row_map(encode, &maps.in[3], o, bnw, heads, o_ws, o_rs, plan.group) ||
      !row_map(encode, &maps.in[4], dout, bnw, heads, g_ws, g_rs, plan.group) ||
      !row_map(encode, &maps.out[0], dq, bnw, heads, out_ws, out_rs, 1) ||
      !row_map(encode, &maps.out[1], dk, bnw, heads, out_ws, out_rs, 1) ||
      !row_map(encode, &maps.out[2], dv, bnw, heads, out_ws, out_rs, 1) ||
      !hopper::f32_box_map(encode, &maps.sums[0], static_cast<float*>(dbias),
                           (long long)heads * WA_N, WA_N, 32) ||
      (dshift != nullptr &&
       !hopper::f32_box_map(encode, &maps.sums[1], static_cast<float*>(dshift),
                            (long long)n_windows * WA_N, WA_N, 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(WB_BYTES <= 232448, "a block's shared memory on sm_90");
  cudaError_t err = cudaFuncSetAttribute(window_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WB_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(plan.n_groups * plan.n_r * plan.n_chunks);
  window_bwd_kernel<<<grid, WA_THREADS, WB_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(bias), static_cast<const float*>(shift), plan, fault,
      sm_scale, sm_scale * WA_LOG2E);
  return static_cast<int>(cudaGetLastError());
}
