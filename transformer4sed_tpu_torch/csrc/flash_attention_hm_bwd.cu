// Head-major flash attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/flash_attention.py
// :_flash_backward (line 401), which runs two kernels: _bwd_dq_kernel (line
// 328, launched at 419) and _bwd_dkv_kernel (line 346, launched at 435). Here
// one kernel computes dq, dk and dv from the saved output O and row
// log-sum-exp L, with delta = rowsum(dO * O) computed beforehand, on
// head-major operands q, k, v, dO [B, H, T, d], each with its own batch, head
// and row strides: dq goes to an f32 workspace by atomicAdd, dk and dv are
// written once, in bf16. The kernel is flash_bwd.cuh's (formulas and design
// there).
// What bounds it: at the PaSST shape (B=8, T=1190, H=12, d=64) the five
// products are 87 GFLOP against ~100 MB of operands and results: the tensor
// cores.
// Head dims built: 32 and 64.

#include "flash_bwd.cuh"

// q/k/v/dout: bf16 [B, H, T, d] views (unit stride along d; strides in
// elements, multiples of 8); lse, delta: f32 [B, H, T] contiguous; dq_acc:
// f32 [B, H, T, d] view, zeroed by the caller (summed into with atomics);
// dk/dv: bf16 [B, H, T, d] views. Returns cudaGetLastError() after the launch
// (0 = launched), cudaErrorInvalidValue for a head dim not built.
extern "C" int t4s_flash_hm_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq_acc, void* dk,
                                void* dv, int batch, int n, int heads, int head_dim,
                                long long q_bs, long long q_hs, long long q_rs, long long k_bs,
                                long long k_hs, long long k_rs, long long v_bs, long long v_hs,
                                long long v_rs, long long do_bs, long long do_hs,
                                long long do_rs, long long dq_bs, long long dq_hs,
                                long long dq_rs, long long dk_bs, long long dk_hs,
                                long long dk_rs, long long dv_bs, long long dv_hs,
                                long long dv_rs, float sm_scale, void* stream) {
  using namespace t4s;
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, q_hs, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, k_hs, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, v_hs, v_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, do_hs, do_rs};
  const Rows<float> dqr{static_cast<float*>(dq_acc), dq_bs, dq_hs, dq_rs};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, dk_hs, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, dv_hs, dv_rs};
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  if (head_dim == 32)
    return launch_flash_bwd<32>(batch, n, heads, stream, qr, kr, vr, gr, lp, dp, dqr, dkr, dvr,
                                sm_scale);
  if (head_dim == 64)
    return launch_flash_bwd<64>(batch, n, heads, stream, qr, kr, vr, gr, lp, dp, dqr, dkr, dvr,
                                sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
