// Heads-in-lanes flash attention backward for Hopper (sm_90a), and the two
// passes around both flash backwards.
//
// Replaces the Pallas TPU kernel transformer4sed_tpu/kernels/flash_attention.py
// :_flash_nhd_backward (line 670, kernel body _nhd_dqkv_kernel line 620): dq,
// dk, dv from the saved output O and row log-sum-exp L of the forward, with
// q/k/v/dO read as [B, N, H*d] lane slices, no head transposes. The XLA code
// around that kernel (delta = rowsum(dO * O), lines 685-688; the dq slice and
// cast, line 720) becomes the pre- and post-pass here, which the head-major
// backward (flash_attention_hm_bwd.cu) calls too. The kernels are
// flash_bwd.cuh's (formulas and design there), given head stride d.
//
// What bounds it: five products of 2*N^2*d per (batch, head), 261 GFLOP at
// B=24, N=1190, H=12, d=64, against ~200 MB of operands and results: 0.2639
// ms at the H100's bf16 tensor-core rate, far above its ~295 FLOP/byte
// ridge, so the tensor cores bound it. The design keeps them fed: wgmma on
// TMA-loaded tiles behind a producer warpgroup, no copy transposed, dQ summed
// over 128 keys a block before one TMA reduction adds it (no atomics).

#include "flash_bwd.cuh"

// q/k/v/dout: bf16 [B, N, H*64] views (unit lane stride, batch/row strides
// in elements, multiples of 8, 16-byte aligned); side, dq_acc: the pre-pass's
// f32 [B, H, N_pad, 2] and [B, H, N_pad, 64] (N_pad = N rounded up to 64);
// dk/dv: bf16 [B, N, H*64]. skip_dq_tile: a key tile whose dQ partial is left
// out (-1 for none; only a planted fault sets it). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int t4s_flash_nhd_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const void* side, void* dq_acc, void* dk, void* dv, int batch,
                                 int n, int heads, int head_dim, int skip_dq_tile, long long q_bs,
                                 long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                 long long v_rs, long long do_bs, long long do_rs,
                                 long long dk_bs, long long dk_rs, long long dv_bs,
                                 long long dv_rs, float sm_scale, void* stream) {
  using namespace t4s;
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, 64, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, 64, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, 64, v_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, 64, do_rs};
  const Rows<bf16> dkr{static_cast<bf16*>(dk), dk_bs, 64, dk_rs};
  const Rows<bf16> dvr{static_cast<bf16*>(dv), dv_bs, 64, dv_rs};
  return launch_flash_bwd<64>(batch, n, heads, stream, qr, kr, vr, gr,
                              static_cast<const float*>(side), static_cast<float*>(dq_acc), dkr,
                              dvr, skip_dq_tile, sm_scale);
}

// The pre-pass of both flash backwards. o/dout: bf16 [B, H, T, d] views
// (batch, head and row strides in elements, multiples of 8); lse: f32
// [B, H, T] contiguous; side: f32 [B, H, T_pad, 2] out, (L * log2 e, delta)
// per row, +inf and 0 past T and +inf where L is -inf; dq_acc: f32
// [B, H, T_pad, d], zeroed. Head dims 32 and 64.
extern "C" int t4s_flash_bwd_prepass(const void* o, const void* dout, const void* lse, void* side,
                                     void* dq_acc, int batch, int n, int heads, int head_dim,
                                     long long o_bs, long long o_hs, long long o_rs,
                                     long long do_bs, long long do_hs, long long do_rs,
                                     void* stream) {
  using namespace t4s;
  const Rows<const bf16> orr{static_cast<const bf16*>(o), o_bs, o_hs, o_rs};
  const Rows<const bf16> gr{static_cast<const bf16*>(dout), do_bs, do_hs, do_rs};
  const float* lp = static_cast<const float*>(lse);
  float* sp = static_cast<float*>(side);
  float* wp = static_cast<float*>(dq_acc);
  if (head_dim == 32)
    return launch_flash_bwd_prepass<32>(batch, n, heads, stream, orr, gr, lp, sp, wp);
  if (head_dim == 64)
    return launch_flash_bwd_prepass<64>(batch, n, heads, stream, orr, gr, lp, sp, wp);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The post-pass of both flash backwards: dq = bf16(sm_scale * dq_acc[:, :, :T]),
// dq a bf16 [B, H, T, d] view (strides in elements, multiples of 8).
extern "C" int t4s_flash_bwd_postpass(const void* dq_acc, void* dq, int batch, int n, int heads,
                                      int head_dim, long long dq_bs, long long dq_hs,
                                      long long dq_rs, float sm_scale, void* stream) {
  using namespace t4s;
  const Rows<bf16> out{static_cast<bf16*>(dq), dq_bs, dq_hs, dq_rs};
  const float* wp = static_cast<const float*>(dq_acc);
  if (head_dim == 32)
    return launch_flash_bwd_postpass<32>(batch, n, heads, stream, wp, out, sm_scale);
  if (head_dim == 64)
    return launch_flash_bwd_postpass<64>(batch, n, heads, stream, wp, out, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
