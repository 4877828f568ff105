// Heads-in-lanes flash attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/flash_attention.py
// :_flash_nhd_backward (line 670, kernel body _nhd_dqkv_kernel line 620): dq,
// dk, dv from the saved output O and row log-sum-exp L of the forward, with
// delta = rowsum(dO * O) per head computed beforehand (as the TPU wrapper does,
// lines 685-688), q/k/v/dO read as [B, N, H*d] lane slices, no head
// transposes. The kernel is flash_bwd.cuh's (formulas and design there),
// given head stride d.
//
// What bounds it: five products of 2*N^2*d per (batch, head), 87 GFLOP at
// B=8, N=1190, H=12, d=64 against ~100 MB of operands, far above the H100's
// ~295 FLOP/byte ridge: the tensor cores bound it.

#include "flash_bwd.cuh"

// q/k/v/dout: bf16 [B, N, H*64] views (unit lane stride, batch/row strides
// in elements, multiples of 8); lse, delta: f32 [B, H, N] contiguous;
// dq_acc: f32 [B, N, H*d], zeroed by the caller (summed into with atomics);
// dk/dv: bf16 [B, N, H*d]. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int t4s_flash_nhd_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq_acc, void* dk,
                                 void* dv, int batch, int n, int heads, int head_dim,
                                 long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                                 long long v_bs, long long v_rs, long long do_bs,
                                 long long do_rs, long long dq_bs, long long dq_rs,
                                 long long dk_bs, long long dk_rs, long long dv_bs,
                                 long long dv_rs, float sm_scale, void* stream) {
  using namespace t4s;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, 64, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, 64, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, 64, v_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, 64, do_rs};
  const Rows<float> dqr{static_cast<float*>(dq_acc), dq_bs, 64, dq_rs};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, 64, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, 64, dv_rs};
  return launch_flash_bwd<64>(batch, n, heads, stream, qr, kr, vr, gr,
                              static_cast<const float*>(lse), static_cast<const float*>(delta),
                              dqr, dkr, dvr, sm_scale);
}
