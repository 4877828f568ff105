// Fused head-major Transformer-XL attention forward for Hopper (sm_90a), two
// entry points.
//
// t4s_xl_hm_fwd replaces the Pallas TPU kernel
// transformer4sed_tpu/kernels/xl_attention.py:_xl_forward (line 340; kernel
// bodies _xl_row_kernel line 112, whole key rows with an optional band, and
// _xl_kernel line 50, key blocks with an online softmax for long T);
// t4s_xl_hm_fwd_lse replaces :_xl_forward_lse (line 410, body
// _xl_row_lse_kernel), which also writes the natural-log row log-sum-exp
// lse [B, H, T] f32 for the backward (xl_attention_bwd.cu).
//   softmax(scale * (qu K^T + relshift(qv P^T))) V
// on head-major operands qu, qv, k, v [B, H, T, d], each with its own batch,
// head and row strides (a [B, T, H*d] projection slice viewed as [B, H, T, d]
// goes in without a copy), P the projected position table [H, 2T-1, d]
// (offsets T-1 ... -(T-1)) and an optional per-head band. qu and qv arrive
// already summed with pos_bias_u / pos_bias_v: no bias is added here (the
// kernel of xl.cuh without BIAS). One kernel covers both TPU bodies: it
// walks 64-key tiles with an online softmax whatever T is, and generates the
// band per element. The design is in xl.cuh.
// What bounds it: at the PMAM decoder shape (B=8, T=1000, H=12, d=32) the
// three products are 18.4 GFLOP against ~32 MB of qu/qv/k/v/o/P, above the
// H100's ~295 FLOP/byte ridge: the tensor cores.
// Head dims built: 32 and 64. 96 and 128 fit the shared-memory layout but are
// not built: their per-thread fragments (qu, qv, output) were not tried
// against the register limit.

#include "xl.cuh"

// qu/qv/k/v: bf16 [B, H, T, d] views (unit stride along d; batch, head and
// row strides in elements, multiples of 8); p: bf16 [H, 2T-1, d] with
// head/row strides; band: int32 [H] widths on the device, or null for full
// attention; o: bf16 [B, H, T, d] view with its strides; lse (the _lse entry
// point only): f32 [B, H, T] contiguous. Returns cudaGetLastError() after
// the launch (0 = launched), cudaErrorInvalidValue for a head dim not built.
static int xl_hm_fwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                     const void* band, void* o, void* lse, int batch, int n, int heads,
                     int head_dim, const long long* s, float sm_scale, void* stream) {
  using namespace t4s;
  const Rows<const bf16> qur{static_cast<const bf16*>(qu), s[0], s[1], s[2]};
  const Rows<const bf16> qvr{static_cast<const bf16*>(qv), s[3], s[4], s[5]};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), s[6], s[7], s[8]};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), s[9], s[10], s[11]};
  const bf16* pp = static_cast<const bf16*>(p);
  const long long p_hs = s[12], p_rs = s[13];
  const Rows<bf16> orr{static_cast<bf16*>(o), s[14], s[15], s[16]};
  const int* bw = static_cast<const int*>(band);
  float* lp = static_cast<float*>(lse);
#define T4S_XL_HM_FWD(HD)                                                                       \
  (lp != nullptr                                                                                \
       ? launch_xl_fwd<HD, true, false>(batch, n, heads, stream, qur, qvr, kr, vr, nullptr,     \
                                        nullptr, pp, p_hs, p_rs, bw, orr, lp, sm_scale)         \
       : launch_xl_fwd<HD, false, false>(batch, n, heads, stream, qur, qvr, kr, vr, nullptr,    \
                                         nullptr, pp, p_hs, p_rs, bw, orr, lp, sm_scale))
  if (head_dim == 32) return T4S_XL_HM_FWD(32);
  if (head_dim == 64) return T4S_XL_HM_FWD(64);
#undef T4S_XL_HM_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int t4s_xl_hm_fwd(const void* qu, const void* qv, const void* k, const void* v,
                             const void* p, const void* band, void* o, int batch, int n,
                             int heads, int head_dim, long long qu_bs, long long qu_hs,
                             long long qu_rs, long long qv_bs, long long qv_hs, long long qv_rs,
                             long long k_bs, long long k_hs, long long k_rs, long long v_bs,
                             long long v_hs, long long v_rs, long long p_hs, long long p_rs,
                             long long o_bs, long long o_hs, long long o_rs, float sm_scale,
                             void* stream) {
  const long long s[17] = {qu_bs, qu_hs, qu_rs, qv_bs, qv_hs, qv_rs, k_bs, k_hs, k_rs,
                           v_bs,  v_hs,  v_rs,  p_hs,  p_rs,  o_bs,  o_hs, o_rs};
  return xl_hm_fwd(qu, qv, k, v, p, band, o, nullptr, batch, n, heads, head_dim, s, sm_scale,
                   stream);
}

extern "C" int t4s_xl_hm_fwd_lse(const void* qu, const void* qv, const void* k, const void* v,
                                 const void* p, const void* band, void* o, void* lse, int batch,
                                 int n, int heads, int head_dim, long long qu_bs, long long qu_hs,
                                 long long qu_rs, long long qv_bs, long long qv_hs,
                                 long long qv_rs, long long k_bs, long long k_hs, long long k_rs,
                                 long long v_bs, long long v_hs, long long v_rs, long long p_hs,
                                 long long p_rs, long long o_bs, long long o_hs, long long o_rs,
                                 float sm_scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[17] = {qu_bs, qu_hs, qu_rs, qv_bs, qv_hs, qv_rs, k_bs, k_hs, k_rs,
                           v_bs,  v_hs,  v_rs,  p_hs,  p_rs,  o_bs,  o_hs, o_rs};
  return xl_hm_fwd(qu, qv, k, v, p, band, o, lse, batch, n, heads, head_dim, s, sm_scale, stream);
}
