// Fused head-major Transformer-XL attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/xl_attention.py
// :_xl_backward (line 458, kernel body _xl_bwd_dq_kernel): the kernel of
// xl_bwd.cuh without BIAS (formulas and design there) on head-major
// operands qu, qv, k, v, dO [B, H, T, d], each with its own batch, head and
// row strides. qu and qv arrive already summed with pos_bias_u / pos_bias_v,
// and dQu and dQv are returned apart: they and dP [H, 2T-1, d] go to f32
// workspaces by atomicAdd (dP summed over batch and across query tiles);
// dK and dV are written once, in bf16.
// What bounds it: at the PMAM decoder shape (B=18, T=1000, H=12, d=32) the
// eight products of 2*T^2*d per (batch, head) are 110.6 GFLOP against ~141 MB
// of operands and results: the tensor cores.
// Head dims built: 32 and 64.

#include "xl_bwd.cuh"

// qu/qv/k/v/dout: bf16 [B, H, T, d] views (unit stride along d; strides in
// elements, multiples of 8); p: bf16 [H, 2T-1, d] with head/row strides;
// band: int32 [H] widths on the device, or null; lse, delta: f32 [B, H, T]
// contiguous; dqu_acc, dqv_acc: f32 [B, H, T, d] views of one layout (the dq
// strides) and dp_acc: f32 [H, 2T-1, d] contiguous, all zeroed by the caller
// (summed into with atomics); dk/dv: bf16 [B, H, T, d] views. Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for a head dim not built.
extern "C" int t4s_xl_hm_bwd(const void* qu, const void* qv, const void* k, const void* v,
                             const void* dout, const void* p, const void* band, const void* lse,
                             const void* delta, void* dqu_acc, void* dqv_acc, void* dp_acc,
                             void* dk, void* dv, int batch, int n, int heads, int head_dim,
                             long long qu_bs, long long qu_hs, long long qu_rs, long long qv_bs,
                             long long qv_hs, long long qv_rs, long long k_bs, long long k_hs,
                             long long k_rs, long long v_bs, long long v_hs, long long v_rs,
                             long long do_bs, long long do_hs, long long do_rs, long long p_hs,
                             long long p_rs, long long dq_bs, long long dq_hs, long long dq_rs,
                             long long dk_bs, long long dk_hs, long long dk_rs, long long dv_bs,
                             long long dv_hs, long long dv_rs,
                             float sm_scale, void* stream) {
  using namespace t4s;
  const Rows<const bf16> qur{static_cast<const bf16*>(qu), qu_bs, qu_hs, qu_rs};
  const Rows<const bf16> qvr{static_cast<const bf16*>(qv), qv_bs, qv_hs, qv_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, k_hs, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, v_hs, v_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, do_hs, do_rs};
  const Rows<float> dqur{static_cast<float*>(dqu_acc), dq_bs, dq_hs, dq_rs};
  const Rows<float> dqvr{static_cast<float*>(dqv_acc), dq_bs, dq_hs, dq_rs};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, dk_hs, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, dv_hs, dv_rs};
#define T4S_XL_HM_BWD(HD)                                                                      \
  launch_xl_bwd<HD, false>(batch, n, heads, stream, qur, qvr, kr, vr, gr, nullptr, nullptr,    \
                           static_cast<const bf16*>(p), p_hs, p_rs,                            \
                           static_cast<const int*>(band), static_cast<const float*>(lse),      \
                           static_cast<const float*>(delta), dqur, dqvr,                       \
                           static_cast<float*>(dp_acc), dkr, dvr, sm_scale)
  if (head_dim == 32) return T4S_XL_HM_BWD(32);
  if (head_dim == 64) return T4S_XL_HM_BWD(64);
#undef T4S_XL_HM_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
