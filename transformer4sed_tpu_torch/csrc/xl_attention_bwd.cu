// Transformer-XL attention backward for Hopper (sm_90a): one entry point for
// both layouts, and the two passes around it.
//
// Replaces two Pallas TPU kernels of transformer4sed_tpu/kernels/xl_attention.py:
// * :_xl_nhd_backward (line 886, kernel body _xl_bwd_nhd_kernel line 795): dq,
//   dk, dv, dpos_bias_u, dpos_bias_v and dP from the saved output O and row
//   log-sum-exp L, with k, v and dO read as [B, T, H*64] lane slices. The XLA
//   code around it (delta = rowsum(dO * O), lines 912-916; dq = dQu + dQv, the
//   bias gradients as their (b, t) sums and the dP slice, lines 978-983)
//   becomes the pre- and post-pass here. The pre-pass also forms
//   qu = bf16(q + u) and qv = bf16(q + v) once, so that the main kernel runs
//   in its SUMQ form: dQu + dQv summed in the block, their column sums kept
//   for the bias gradients.
// * :_xl_backward (line 458, kernel body _xl_bwd_dq_kernel line 243): dqu,
//   dqv, dk, dv and dP on head-major operands qu, qv, k, v, dO [B, H, T, d],
//   each with its own batch, head and row strides (qu and qv arrive already
//   summed with pos_bias_u / pos_bias_v), head dims 32 and 64. dQu and dQv
//   stay apart, in the two halves of the f32 workspace; the passes serve the
//   XLA code around that kernel too (delta, line 476, and the casts).
// The main kernel is xl_bwd.cuh's (formulas and design there).
//
// What bounds it: eight products of 2*T^2*d per (batch, head), 295 GFLOP at
// B=24, T=1000, H=12, d=64, against ~160 MB of operands and results: 0.298 ms
// at the H100's bf16 tensor-core rate, far above its ~295 FLOP/byte ridge, so
// the tensor cores bound it (at PMAM's B=18, d=32: 110.6 GFLOP, 0.112 ms). The
// design keeps them fed: wgmma on TMA-loaded tiles behind a producer
// warpgroup, the position strip loaded once a block by TMA, dQ and dP added
// by TMA reductions (no atomics).

#include "xl_bwd.cuh"

// qu, qv, k, v, dout: bf16 [B, H, T, d] views (row 13: qu and qv the
// pre-pass's, k, v and dout views of [B, T, H*64] lane slices); p: bf16
// [H, 2T-1, d] view; every stride in elements, a multiple of 8, 16-byte
// aligned. band: int32 [H] widths on the device, or null. side, dq_acc,
// dp_acc: the pre-pass's [B, H, T_pad, 2], [B, H, T_pad, ws_cols] and
// [H, 2T + 256, d] f32 (T_pad = T rounded up to 64). colsum: f32
// [B, H, ceil(T / 128), 2, 64] out for row 13 (dQu + dQv summed into dq_acc,
// ws_cols = 64; head dim 64 only), or null for row 11 (dQu and dQv apart,
// ws_cols = 2d; head dims 32 and 64). dk, dv: bf16 [B, H, T, d] views.
// fault: a planted fault (XbFault; 0 on every real path). Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for a head dim not built.
extern "C" int t4s_xl_bwd(const void* qu, const void* qv, const void* k, const void* v,
                          const void* dout, const void* p, const void* band, const void* side,
                          void* dq_acc, void* dp_acc, void* colsum, void* dk, void* dv, int batch,
                          int n, int heads, int head_dim, int fault, long long qu_bs,
                          long long qu_hs, long long qu_rs, long long qv_bs, long long qv_hs,
                          long long qv_rs, long long k_bs, long long k_hs, long long k_rs,
                          long long v_bs, long long v_hs, long long v_rs, long long do_bs,
                          long long do_hs, long long do_rs, long long p_hs, long long p_rs,
                          long long dk_bs, long long dk_hs, long long dk_rs, long long dv_bs,
                          long long dv_hs, long long dv_rs, float sm_scale, void* stream) {
  using namespace t4s;
  using R = Rows<const bf16>;
  const R qur{static_cast<const bf16*>(qu), qu_bs, qu_hs, qu_rs};
  const R qvr{static_cast<const bf16*>(qv), qv_bs, qv_hs, qv_rs};
  const R kr{static_cast<const bf16*>(k), k_bs, k_hs, k_rs};
  const R vr{static_cast<const bf16*>(v), v_bs, v_hs, v_rs};
  const R gr{static_cast<const bf16*>(dout), do_bs, do_hs, do_rs};
  const R pr{static_cast<const bf16*>(p), p_hs * heads, p_hs, p_rs};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, dk_hs, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, dv_hs, dv_rs};
  const int* bp = static_cast<const int*>(band);
  const float* sp = static_cast<const float*>(side);
  float* qa = static_cast<float*>(dq_acc);
  float* pa = static_cast<float*>(dp_acc);
  float* cs = static_cast<float*>(colsum);
  if (cs != nullptr && head_dim == 64)
    return launch_xl_bwd<64, true>(batch, n, heads, stream, qur, qvr, kr, vr, gr, pr, bp, sp, qa,
                                   pa, cs, dkr, dvr, fault, sm_scale);
  if (cs == nullptr && head_dim == 32)
    return launch_xl_bwd<32, false>(batch, n, heads, stream, qur, qvr, kr, vr, gr, pr, bp, sp, qa,
                                    pa, cs, dkr, dvr, fault, sm_scale);
  if (cs == nullptr && head_dim == 64)
    return launch_xl_bwd<64, false>(batch, n, heads, stream, qur, qvr, kr, vr, gr, pr, bp, sp, qa,
                                    pa, cs, dkr, dvr, fault, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The pre-pass of both XL backwards. o, dout: bf16 [B, H, T, d] views; lse:
// f32 [B, H, T] contiguous; side: f32 [B, H, T_pad, 2] out; ws: the f32
// workspaces, B * H * T_pad * ws_cols floats (dq_acc; ws_cols = d for row
// 13, 2d for row 11) then H * (2T + 256) * d (dp_acc), zeroed. With q (a
// bf16 [B, H, T, d] view) and the f32 biases [H, d]: qu, qv bf16 [B, H, T, d]
// contiguous out. Head dims 32 and 64 (with q: 64).
extern "C" int t4s_xl_bwd_prepass(const void* o, const void* dout, const void* lse, void* side,
                                  void* ws, const void* q, const void* bias_u, const void* bias_v,
                                  void* qu, void* qv, int batch, int n, int heads, int head_dim,
                                  int ws_cols, long long o_bs, long long o_hs, long long o_rs,
                                  long long do_bs, long long do_hs, long long do_rs,
                                  long long q_bs, long long q_hs, long long q_rs, void* stream) {
  using namespace t4s;
  using R = Rows<const bf16>;
  const R orr{static_cast<const bf16*>(o), o_bs, o_hs, o_rs};
  const R gr{static_cast<const bf16*>(dout), do_bs, do_hs, do_rs};
  const R qr{static_cast<const bf16*>(q), q_bs, q_hs, q_rs};
  const float* lp = static_cast<const float*>(lse);
  float* sp = static_cast<float*>(side);
  float* wp = static_cast<float*>(ws);
  const float* bu = static_cast<const float*>(bias_u);
  const float* bv = static_cast<const float*>(bias_v);
  bf16* up = static_cast<bf16*>(qu);
  bf16* vp = static_cast<bf16*>(qv);
  if (q != nullptr && head_dim == 64)
    return launch_xl_bwd_prepass<64, true>(batch, n, heads, ws_cols, stream, orr, gr, lp, sp, wp,
                                           qr, bu, bv, up, vp);
  if (q == nullptr && head_dim == 32)
    return launch_xl_bwd_prepass<32, false>(batch, n, heads, ws_cols, stream, orr, gr, lp, sp, wp,
                                            qr, bu, bv, up, vp);
  if (q == nullptr && head_dim == 64)
    return launch_xl_bwd_prepass<64, false>(batch, n, heads, ws_cols, stream, orr, gr, lp, sp, wp,
                                            qr, bu, bv, up, vp);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The post-pass of both XL backwards, sm_scale applied: with colsum (row 13,
// d = 64), dq = bf16(dq_acc[:, :, :T]) and dbias f32 [2, H, d] (dbu, dbv) =
// the sums of colsum over batch and key tiles; without (row 11), dq and dqv
// = bf16 of dq_acc's two column halves. dp = bf16(dp_acc rows 64 .. 2T + 62).
// dq, dqv: bf16 [B, H, T, d] views; dp: a bf16 [H, 2T-1, d] view (strides in
// elements, multiples of 8).
extern "C" int t4s_xl_bwd_postpass(const void* dq_acc, const void* dp_acc, const void* colsum,
                                   void* dq, void* dqv, void* dp, void* dbias, int batch, int n,
                                   int heads, int head_dim, long long dq_bs, long long dq_hs,
                                   long long dq_rs, long long dqv_bs, long long dqv_hs,
                                   long long dqv_rs, long long dp_hs, long long dp_rs,
                                   float sm_scale, void* stream) {
  using namespace t4s;
  const float* qa = static_cast<const float*>(dq_acc);
  const float* pa = static_cast<const float*>(dp_acc);
  const float* cs = static_cast<const float*>(colsum);
  const Rows<bf16> dqr{static_cast<bf16*>(dq), dq_bs, dq_hs, dq_rs};
  const Rows<bf16> dqvr{static_cast<bf16*>(dqv), dqv_bs, dqv_hs, dqv_rs};
  const Rows<bf16> dpr{static_cast<bf16*>(dp), 0, dp_hs, dp_rs};
  float* db = static_cast<float*>(dbias);
  if (cs != nullptr && head_dim == 64)
    return launch_xl_bwd_postpass<64, true>(batch, n, heads, stream, qa, pa, cs, dqr, dqvr, dpr,
                                            db, sm_scale);
  if (cs == nullptr && head_dim == 32)
    return launch_xl_bwd_postpass<32, false>(batch, n, heads, stream, qa, pa, cs, dqr, dqvr, dpr,
                                             db, sm_scale);
  if (cs == nullptr && head_dim == 64)
    return launch_xl_bwd_postpass<64, false>(batch, n, heads, stream, qa, pa, cs, dqr, dqvr, dpr,
                                             db, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
