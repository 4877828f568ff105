// Head-major flash attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/flash_attention.py
// :_flash_backward (line 401), which runs two kernels: _bwd_dq_kernel (line
// 328, launched at 419) and _bwd_dkv_kernel (line 346, launched at 435). Here
// one kernel computes dq, dk and dv from the saved output O and row
// log-sum-exp L on head-major operands q, k, v, dO [B, H, T, d], each with its
// own batch, head and row strides: dk and dv are written once, in bf16; dq is
// summed in the f32 workspace of the pre-pass (t4s_flash_bwd_prepass in
// flash_attention_bwd.cu, which also computes delta = rowsum(dO * O)) and
// written by the post-pass. The kernel is flash_bwd.cuh's (formulas and
// design there).
// What bounds it: at the parallel train step's shape (B=24, T=1190, H=12,
// d=64) the five products are 261 GFLOP against ~200 MB of operands and
// results: 0.2639 ms at the H100's bf16 tensor-core rate, so the tensor
// cores. The design feeds them from TMA tiles behind a producer warpgroup,
// with wgmma and no transposed copy.
// Head dims built: 32 and 64.

#include "flash_bwd.cuh"

// q/k/v/dout: bf16 [B, H, T, d] views (unit stride along d; strides in
// elements, multiples of 8, 16-byte aligned); side, dq_acc: the pre-pass's
// f32 [B, H, T_pad, 2] and [B, H, T_pad, d]; dk/dv: bf16 [B, H, T, d] views.
// skip_dq_tile: a key tile whose dQ partial is left out (-1 for none; only a
// planted fault sets it). Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a head dim not built.
extern "C" int t4s_flash_hm_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* side, void* dq_acc, void* dk, void* dv, int batch,
                                int n, int heads, int head_dim, int skip_dq_tile, long long q_bs,
                                long long q_hs, long long q_rs, long long k_bs, long long k_hs,
                                long long k_rs, long long v_bs, long long v_hs, long long v_rs,
                                long long do_bs, long long do_hs, long long do_rs,
                                long long dk_bs, long long dk_hs, long long dk_rs,
                                long long dv_bs, long long dv_hs, long long dv_rs, float sm_scale,
                                void* stream) {
  using namespace t4s;
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, q_hs, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, k_hs, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, v_hs, v_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, do_hs, do_rs};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, dk_hs, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, dv_hs, dv_rs};
  const float* sp = static_cast<const float*>(side);
  float* wp = static_cast<float*>(dq_acc);
  if (head_dim == 32)
    return launch_flash_bwd<32>(batch, n, heads, stream, qr, kr, vr, gr, sp, wp, dkr, dvr,
                                skip_dq_tile, sm_scale);
  if (head_dim == 64)
    return launch_flash_bwd<64>(batch, n, heads, stream, qr, kr, vr, gr, sp, wp, dkr, dvr,
                                skip_dq_tile, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
