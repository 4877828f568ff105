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
// with q/k/v as [B, T, H*d] lane slices (head h at lane offset h*d: a head
// stride of d), u/v = pos_bias_u/pos_bias_v [H, d] added in f32 in-kernel and
// rounded to bf16, P the projected position
// table [H, 2T-1, d] (offsets T-1 ... -(T-1)), and an optional per-head
// band. The kernel (xl_fwd.cuh's XF_BIAS mode) and its design are in
// xl_fwd.cuh.
// What bounds it: at the MAT-SED decoder shape (B=8, T=1000, H=12, d=64) the
// content and position products and P.V are 36.9 GFLOP against ~52 MB of
// q/k/v/o/P, far above the H100's ~295 FLOP/byte ridge: the tensor cores.
// The design feeds them: wgmma on TMA tiles behind a producer warpgroup, the
// position strip by TMA in 128-row tiles that both consumers share, the skew
// in registers by quad shuffles onto the score accumulators.

#include "xl_fwd.cuh"

// q/k/v: bf16 [B, T, H*d] views with d = 64 (unit lane stride, strides in
// elements, multiples of 8, 16-byte aligned); bias_u/bias_v: f32 [H, d]
// contiguous; p: bf16 [H, 2T-1, d] with head/row strides (multiples of 8);
// band: int32 [H] widths on the device, or null for full attention; o: bf16
// [B, T, H*d]; lse (the _lse entry point only): f32 [B, H, T] contiguous.
// fault: a planted fault (XfFault; 0 on every real path). Returns
// cudaGetLastError() after the launch (0 = launched).
static int xl_fwd(const void* q, const void* k, const void* v, const void* bias_u,
                  const void* bias_v, const void* p, const void* band, void* o, void* lse,
                  int batch, int n, int heads, int head_dim, int fault, long long q_bs,
                  long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                  long long p_hs, long long p_rs, long long o_bs, long long o_rs, float sm_scale,
                  void* stream) {
  using namespace t4s;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, 64, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, 64, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, 64, v_rs};
  const Rows<const bf16> pr{static_cast<const bf16*>(p), p_hs * heads, p_hs, p_rs};
  const Rows<bf16> orr{static_cast<bf16*>(o), o_bs, 64, o_rs};
  return launch_xl_fwd<64, XF_BIAS>(batch, n, heads, stream, qr, qr, kr, vr,
                                   static_cast<const float*>(bias_u),
                                   static_cast<const float*>(bias_v), pr,
                                   static_cast<const int*>(band), orr, static_cast<float*>(lse),
                                   fault, sm_scale);
}

extern "C" int t4s_xl_nhd_fwd(const void* q, const void* k, const void* v, const void* bias_u,
                              const void* bias_v, const void* p, const void* band, void* o,
                              int batch, int n, int heads, int head_dim, int fault,
                              long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                              long long v_bs, long long v_rs, long long p_hs, long long p_rs,
                              long long o_bs, long long o_rs, float sm_scale, void* stream) {
  return xl_fwd(q, k, v, bias_u, bias_v, p, band, o, nullptr, batch, n, heads, head_dim, fault,
                q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, p_hs, p_rs, o_bs, o_rs, sm_scale, stream);
}

extern "C" int t4s_xl_nhd_fwd_lse(const void* q, const void* k, const void* v,
                                  const void* bias_u, const void* bias_v, const void* p,
                                  const void* band, void* o, void* lse, int batch, int n,
                                  int heads, int head_dim, int fault, long long q_bs,
                                  long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                  long long v_rs, long long p_hs, long long p_rs, long long o_bs,
                                  long long o_rs, float sm_scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return xl_fwd(q, k, v, bias_u, bias_v, p, band, o, lse, batch, n, heads, head_dim, fault, q_bs,
                q_rs, k_bs, k_rs, v_bs, v_rs, p_hs, p_rs, o_bs, o_rs, sm_scale, stream);
}
