// The flash-forward variants of the tail-masking experiment for Hopper (sm_90a).
//
// t4s_flash_variant_a_fwd and t4s_flash_variant_b_fwd replace the Pallas TPU
// kernel exps/flash_variants.py:flash_a (line 62, kernel body _kernel_a line
// 36), with use_exp2 False (A) and True (B):
//   softmax(scale * Q K^T) V
// on head-major q, k, v [B, H, T, d] (bf16, any batch, head and row strides),
// the function of row 3 (flash_attention_hm.cu), with only the ragged key
// tail masked. The TPU kernel holds a whole row of scores in one block, so it
// drops the full-tile -inf select and corrects only the row sum in the lane
// groups that cross T. Here the scores stream through 128-key tiles (K and V
// rows past T are zero-filled by TMA), and the select runs in the last,
// ragged tile only. A keeps the TPU kernel's natural-exp form: the scores
// scaled in the natural domain, then e^x as the card computes it,
// ex2.approx(x * log2 e), one FMUL a score more than B (flash_fwd.cuh's
// FF_EXP); B folds log2 e into the scale, one FFMA and one ex2.approx a score
// (FF_EXP2: the very kernel row 3 runs).
// What bounds it: as row 3, the tensor cores (at the script's [64, 12, 1190,
// 64] the two products are 278.5 GFLOP against 468 MB of q/k/v/o), and after
// them the exps.
// Design: flash_fwd.cuh's wgmma body (design there), each variant its own
// symbol and mode.
// Head dims built: 32 and 64.

#include "flash_fwd.cuh"

namespace t4s {

template <int MODE>
static int launch_flash_variant(const void* q, const void* k, const void* v, void* o, int batch,
                                int n, int heads, int head_dim, int skip_tail_mask,
                                const long long* s, float sm_scale, void* stream) {
  const Rows<const bf16> qr{static_cast<const bf16*>(q), s[0], s[1], s[2]};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), s[3], s[4], s[5]};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), s[6], s[7], s[8]};
  const Rows<bf16> orr{static_cast<bf16*>(o), s[9], s[10], s[11]};
  if (head_dim == 32)
    return launch_flash_fwd<32, MODE>(batch, n, heads, stream, qr, kr, vr, orr, nullptr,
                                      Rows<const float>{}, skip_tail_mask, sm_scale);
  if (head_dim == 64)
    return launch_flash_fwd<64, MODE>(batch, n, heads, stream, qr, kr, vr, orr, nullptr,
                                      Rows<const float>{}, skip_tail_mask, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace t4s

// q/k/v/o: bf16 [B, H, T, d] views (unit stride along d; batch, head and row
// strides in elements, multiples of 8, 16-byte aligned). skip_tail_mask: 1
// leaves the last key tile unmasked (only a planted fault sets it). Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for a head dim not built.
extern "C" int t4s_flash_variant_a_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int n, int heads, int head_dim,
                                       int skip_tail_mask, long long q_bs, long long q_hs,
                                       long long q_rs, long long k_bs, long long k_hs,
                                       long long k_rs, long long v_bs, long long v_hs,
                                       long long v_rs, long long o_bs, long long o_hs,
                                       long long o_rs, float sm_scale, void* stream) {
  const long long s[12] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs};
  return t4s::launch_flash_variant<t4s::FF_EXP>(q, k, v, o, batch, n, heads, head_dim,
                                                skip_tail_mask, s, sm_scale, stream);
}

extern "C" int t4s_flash_variant_b_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int n, int heads, int head_dim,
                                       int skip_tail_mask, long long q_bs, long long q_hs,
                                       long long q_rs, long long k_bs, long long k_hs,
                                       long long k_rs, long long v_bs, long long v_hs,
                                       long long v_rs, long long o_bs, long long o_hs,
                                       long long o_rs, float sm_scale, void* stream) {
  const long long s[12] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs};
  return t4s::launch_flash_variant<t4s::FF_EXP2>(q, k, v, o, batch, n, heads, head_dim,
                                                 skip_tail_mask, s, sm_scale, stream);
}
