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
// recomputes the probabilities from. The kernel is flash_fwd.cuh's (design
// there), given head stride d.
//
// What bounds it: at the PaSST shape (B=8, N=1190, H=12, d=64) the two
// products are 34.8 GFLOP against 58.5 MB of q/k/v/o, about 600 FLOP per
// byte, above the H100's ~295 FLOP/byte ridge: the tensor cores bound it,
// and after them the exps (one per score on the MUFU units). The design
// feeds the tensor cores: wgmma on 128-key K/V tiles that a producer
// warpgroup keeps in flight by TMA, the softmax in the accumulator registers,
// V read by the second product as it lies (no transposed copy).

#include "flash_fwd.cuh"

// q/k/v: bf16, [B, N, H*64] views with unit stride along the lane dim and
// batch/row strides in elements (multiples of 8, 16-byte aligned); o: bf16
// [B, N, H*d]. lse: null, or f32 [B, H, N] contiguous (natural log).
// skip_tail_mask: 1 leaves the last key tile unmasked (only a planted fault
// sets it). Returns cudaGetLastError() after the launch (0 = launched).
static int launch_flash_nhd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int n, int heads, int head_dim, int skip_tail_mask,
                            long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                            long long v_bs, long long v_rs, long long o_bs, long long o_rs,
                            float sm_scale, void* stream) {
  using namespace t4s;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, 64, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, 64, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, 64, v_rs};
  const Rows<bf16> orr{static_cast<bf16*>(o), o_bs, 64, o_rs};
  return launch_flash_fwd<64, FF_EXP2>(batch, n, heads, stream, qr, kr, vr, orr,
                                       static_cast<float*>(lse), Rows<const float>{},
                                       skip_tail_mask, sm_scale);
}

extern "C" int t4s_flash_nhd_fwd(const void* q, const void* k, const void* v, void* o,
                                 int batch, int n, int heads, int head_dim, int skip_tail_mask,
                                 long long q_bs, long long q_rs, long long k_bs,
                                 long long k_rs, long long v_bs, long long v_rs,
                                 long long o_bs, long long o_rs, float sm_scale,
                                 void* stream) {
  return launch_flash_nhd(q, k, v, o, nullptr, batch, n, heads, head_dim, skip_tail_mask, q_bs,
                          q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, sm_scale, stream);
}

extern "C" int t4s_flash_nhd_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int batch, int n, int heads, int head_dim,
                                     int skip_tail_mask, long long q_bs, long long q_rs,
                                     long long k_bs, long long k_rs, long long v_bs,
                                     long long v_rs, long long o_bs, long long o_rs,
                                     float sm_scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_flash_nhd(q, k, v, o, lse, batch, n, heads, head_dim, skip_tail_mask, q_bs,
                          q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, sm_scale, stream);
}
