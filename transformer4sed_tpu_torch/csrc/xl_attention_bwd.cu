// Fused heads-in-lanes Transformer-XL attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/xl_attention.py
// :_xl_nhd_backward (line 886, kernel body _xl_bwd_nhd_kernel line 795): the
// BIAS form of the kernel in xl_bwd.cuh (formulas and design there) on
// q/k/v/dO as [B, T, H*d] lane slices (head h at lane offset h*d), with
// qu = bf16(q + u), qv = bf16(q + v) formed in-kernel. dQu, dQv [B, T, H*d]
// and dP [H, 2T-1, d] go to f32 workspaces by atomicAdd; the caller forms
// dq = dQu + dQv and the bias gradients (sums of dQu and dQv over batch and
// time) in f32, as the TPU wrapper does.
// What bounds it: eight products of 2*T^2*d per (batch, head), 98 GFLOP at
// B=8, T=1000, H=12, d=64, far above the H100's ~295 FLOP/byte ridge: the
// tensor cores.

#include "xl_bwd.cuh"

// q/k/v/dout: bf16 [B, T, H*64] views (unit lane stride, strides in elements,
// multiples of 8); bias_u/bias_v: f32 [H, d] contiguous; p: bf16 [H, 2T-1, d]
// with head/row strides; band: int32 [H] widths on the device, or null;
// lse, delta: f32 [B, H, T] contiguous; dqu_acc, dqv_acc: f32 [B, T, H*d]
// and dp_acc: f32 [H, 2T-1, d], contiguous and zeroed by the caller (summed
// into with atomics); dk/dv: bf16 [B, T, H*d]. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int t4s_xl_nhd_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* bias_u, const void* bias_v, const void* p,
                              const void* band, const void* lse, const void* delta,
                              void* dqu_acc, void* dqv_acc, void* dp_acc, void* dk, void* dv,
                              int batch, int n, int heads, int head_dim, long long q_bs,
                              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                              long long v_rs, long long do_bs, long long do_rs, long long p_hs,
                              long long p_rs, long long dk_bs, long long dk_rs, long long dv_bs,
                              long long dv_rs, float sm_scale, void* stream) {
  using namespace t4s;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long c = (long long)heads * 64;
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, 64, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, 64, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, 64, v_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, 64, do_rs};
  const Rows<float> dqur{static_cast<float*>(dqu_acc), n * c, 64, c};
  const Rows<float> dqvr{static_cast<float*>(dqv_acc), n * c, 64, c};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, 64, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, 64, dv_rs};
  return launch_xl_bwd<64, true>(
      batch, n, heads, stream, qr, qr, kr, vr, gr, static_cast<const float*>(bias_u),
      static_cast<const float*>(bias_v), static_cast<const bf16*>(p), p_hs, p_rs,
      static_cast<const int*>(band), static_cast<const float*>(lse),
      static_cast<const float*>(delta), dqur, dqvr, static_cast<float*>(dp_acc), dkr, dvr,
      sm_scale);
}
