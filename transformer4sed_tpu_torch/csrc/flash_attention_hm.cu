// Head-major flash attention forward for Hopper (sm_90a), two entry points.
//
// t4s_flash_hm_fwd replaces the Pallas TPU kernel
// transformer4sed_tpu/kernels/flash_attention.py:_flash_forward (line 96,
// kernel body _flash_kernel line 58); t4s_flash_hm_fwd_lse replaces
// :_flash_forward_lse (line 368, body _fwd_lse_kernel line 300), which also
// writes the natural-log row log-sum-exp lse [B, H, T] f32 for the backward
// (flash_attention_hm_bwd.cu).
//   softmax(scale * Q K^T) V
// on head-major operands q, k, v [B, H, T, d], each with its own batch, head
// and row strides: a contiguous tensor and a [B, T, 3*H*d] projection viewed
// as [B, H, T, d] (head stride d, row stride 3*H*d) go in without a copy. The
// TPU kernels pad T to their block size and mask the padded keys; this one
// masks the ragged key tail in-kernel and pads nothing. The kernel is
// flash_fwd.cuh's (design there).
// What bounds it: at the PaSST shape under head-parallel attention (B=8,
// T=1190, H=12, d=64) the two products are 34.8 GFLOP against 58.5 MB of
// q/k/v/o, about 600 FLOP per byte, above the H100's ~295 FLOP/byte ridge:
// the tensor cores, and after them the exps. The design feeds the tensor
// cores: wgmma on 128-key K/V tiles that a producer warpgroup keeps in
// flight by TMA, the softmax in the accumulator registers, V read by the
// second product as it lies (no transposed copy).
// Head dims built: 32 and 64.

#include "flash_fwd.cuh"

// q/k/v: bf16 [B, H, T, d] views (unit stride along d; batch, head and row
// strides in elements, multiples of 8, 16-byte aligned); o: bf16 [B, H, T, d]
// view with its strides; lse (the _lse entry point only): f32 [B, H, T]
// contiguous. skip_tail_mask: 1 leaves the last key tile unmasked (only a
// planted fault sets it). Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a head dim not built.
static int flash_hm_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch, int n, int heads, int head_dim, int skip_tail_mask,
                        const long long* s, float sm_scale, void* stream) {
  using namespace t4s;
  const Rows<const bf16> qr{static_cast<const bf16*>(q), s[0], s[1], s[2]};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), s[3], s[4], s[5]};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), s[6], s[7], s[8]};
  const Rows<bf16> orr{static_cast<bf16*>(o), s[9], s[10], s[11]};
  float* lp = static_cast<float*>(lse);
  if (head_dim == 32)
    return launch_flash_fwd<32, FF_EXP2>(batch, n, heads, stream, qr, kr, vr, orr, lp,
                                         Rows<const float>{}, skip_tail_mask, sm_scale);
  if (head_dim == 64)
    return launch_flash_fwd<64, FF_EXP2>(batch, n, heads, stream, qr, kr, vr, orr, lp,
                                         Rows<const float>{}, skip_tail_mask, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int t4s_flash_hm_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                int n, int heads, int head_dim, int skip_tail_mask,
                                long long q_bs, long long q_hs, long long q_rs, long long k_bs,
                                long long k_hs, long long k_rs, long long v_bs, long long v_hs,
                                long long v_rs, long long o_bs, long long o_hs, long long o_rs,
                                float sm_scale, void* stream) {
  const long long s[12] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs};
  return flash_hm_fwd(q, k, v, o, nullptr, batch, n, heads, head_dim, skip_tail_mask, s,
                      sm_scale, stream);
}

extern "C" int t4s_flash_hm_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int batch, int n, int heads, int head_dim,
                                    int skip_tail_mask, long long q_bs, long long q_hs,
                                    long long q_rs, long long k_bs, long long k_hs,
                                    long long k_rs, long long v_bs, long long v_hs,
                                    long long v_rs, long long o_bs, long long o_hs,
                                    long long o_rs, float sm_scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[12] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs};
  return flash_hm_fwd(q, k, v, o, lse, batch, n, heads, head_dim, skip_tail_mask, s, sm_scale,
                      stream);
}
