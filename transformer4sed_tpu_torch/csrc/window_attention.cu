// Swin window attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/window_attention.py
// :_window_forward (line 145, kernel body _window_kernel line 88): per window
// and head
//   O = softmax(scale * Q K^T + bias[h] + shift[w mod nW]) V
// with scores and softmax in f32, exp(S - max) rounded to bf16 before the P V
// product and the row sum divided out afterwards, as the TPU kernel does.
//
// What bounds it: 393 KFLOP (two 64 x 64 x 24 products) against 12 KB of q,
// k, v and o per (window, head), 32 FLOP/byte, far below the H100's ~295
// FLOP/byte ridge: the bytes bound it. The TPU kernel packs eight windows
// into a 512-row tile for its matrix unit and masks the cross-window scores.
// Here window.cuh's body (design there) runs one window and head a consumer
// warpgroup: the bias on chip, q, k and v by TMA as rows three steps ahead,
// laid out for wgmma by the producer warpgroup into a ring of three stages,
// S = Q K^T and O = P V on wgmma (P from registers), O out by TMA.

#include "window.cuh"

namespace t4s {

constexpr int WF_RAW = 3;    // raw stages: steps whose rows are loading
constexpr int WF_CANON = 3;  // canonical stages
constexpr int WF_NIN = 3;    // q, k, v
constexpr int WF_CANON_OFF = WF_RAW * WF_NIN * WA_RAW;
constexpr int WF_OUT_OFF = WF_CANON_OFF + WF_CANON * WF_NIN * WA_OP;  // 2 x 2 staged O rows
constexpr int WF_BAR_OFF = WF_OUT_OFF + 4 * WA_ROWS;
// raw_full[RAW], full[CANON], empty[CANON]; then slack to align the base
constexpr int WF_BYTES = WF_BAR_OFF + (WF_RAW + 2 * WF_CANON) * 8 + 1024;

__global__ void __launch_bounds__(WA_THREADS, 1)
window_fwd_kernel(const __grid_constant__ WaMaps<WF_NIN, 1> maps, const float* __restrict__ bias,
                  const float* __restrict__ shift, WaPlan plan, int fault, float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* canon = smem + WF_CANON_OFF;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + WF_BAR_OFF);
  uint64_t* full = raw_full + WF_RAW;
  uint64_t* empty = full + WF_CANON;
  const WaWalk wk(plan);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WF_RAW; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < WF_CANON; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  wa_zero_pad<WF_NIN, WF_CANON>(canon);
  fence_proxy_async();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= WA_CONSUMERS / 32) {
    setmaxnreg_dec<WA_PRODUCER_REGS>();
    wa_produce<WF_NIN, WF_RAW, WF_CANON>(smem, canon, maps.in, raw_full, full, empty, wk,
                                         threadIdx.x - WA_CONSUMERS);
    return;
  }

  setmaxnreg_inc<WA_CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const int head = wk.head(wg);
  const int k_slot = fault == WA_FAULT_SLOT ? wg ^ 1 : wg;
  float bl[32];
  wa_bias(bl, bias + (long long)head * WA_N * WA_N,
          shift != nullptr ? shift + (long long)wk.r * WA_N * WA_N : nullptr, wl, g, t);

  for (int st = 0; st < wk.steps; ++st) {
    const int s = st % WF_CANON;
    const int k = wk.index(st, wg);
    if (k < 0) {  // G = 1 and an odd count: no window in this slot
      // the step's loads first, so that the arrival falls in this step's
      // phase of empty[s], not in that of the step WF_CANON steps before,
      // which the other warpgroup may still be reading
      if (issuer) {
        mbar_wait(&full[s], (st / WF_CANON) & 1);
        mbar_arrive(&empty[s]);
      }
      continue;
    }
    const unsigned char* stage = canon + s * WF_NIN * WA_OP;
    const unsigned char* sq = stage + wg * WA_SLOT;
    const unsigned char* sk = stage + WA_OP + k_slot * WA_SLOT;
    const unsigned char* sv = stage + 2 * WA_OP + wg * WA_SLOT;
    mbar_wait(&full[s], (st / WF_CANON) & 1);
    __syncwarp();

    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_ss<0, 0>(sc, lanes_k(sq, kk), lanes_k(sk, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    float l[2];
    wa_softmax(sc, bl, scale_log2, l);
    uint32_t pa[4][4];
    acc_to_a(sc, pa);
    float o[12];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[kk], rows_k(sv, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (issuer) mbar_arrive(&empty[s]);  // q, k and v of this slot are consumed

    // O / l to this step's staging rows, then one TMA store; the store of
    // the step before has read the other buffer before the barrier
    unsigned char* out = smem + WF_OUT_OFF + (2 * wg + (st & 1)) * WA_ROWS;
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    wa_stage(out, o, inv, wl, g, t);
    fence_proxy_async();
    if (issuer) bulk_wait_read<0>();
    bar_sync(2 + wg, 128);
    if (issuer) {
      tma_store_3d(&maps.out[0], out, head * WA_D, 0, wk.window(k));
      bulk_commit();
    }
  }
  if (issuer) bulk_wait_all();
}

}  // namespace t4s

// q/k/v: bf16 [B*nW, 64, H, 24] lane views (unit lane stride, head stride
// 24, window and row strides in elements, multiples of 8); bias: f32
// [H, 64, 64] contiguous; shift: f32 [nW, 64, 64] contiguous or null, window w
// uses shift[w mod n_windows] (n_windows = 1 without one); o: bf16
// [B*nW, 64, H, 24] contiguous out; fault: a planted fault (WaFault; 0 on
// every real path). Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a shape or a stride the kernel does
// not take.
extern "C" int t4s_window_fwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* shift, void* o, int bnw, int n, int heads, int head_dim,
                              int n_windows, int fault, long long q_ws, long long q_rs,
                              long long k_ws, long long k_rs, long long v_ws, long long v_rs,
                              long long o_ws, long long o_rs, float sm_scale, void* stream) {
  using namespace t4s;
  WaPlan plan;
  if (!wa_plan(&plan, bnw, n, heads, head_dim, shift != nullptr ? n_windows : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  WaMaps<WF_NIN, 1> maps;
  if (!row_map(encode, &maps.in[0], q, bnw, heads, q_ws, q_rs, plan.group) ||
      !row_map(encode, &maps.in[1], k, bnw, heads, k_ws, k_rs, plan.group) ||
      !row_map(encode, &maps.in[2], v, bnw, heads, v_ws, v_rs, plan.group) ||
      !row_map(encode, &maps.out[0], o, bnw, heads, o_ws, o_rs, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(WF_BYTES <= 232448, "a block's shared memory on sm_90");
  cudaError_t err = cudaFuncSetAttribute(window_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WF_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(plan.n_groups * plan.n_r * plan.n_chunks);
  window_fwd_kernel<<<grid, WA_THREADS, WF_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(bias), static_cast<const float*>(shift), plan, fault,
      sm_scale * WA_LOG2E);
  return static_cast<int>(cudaGetLastError());
}
