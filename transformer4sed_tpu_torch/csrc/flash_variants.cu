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
// groups that cross T. Here the scores stream through 64-key tiles (K and V
// rows past T are zero-filled in shared memory), and the select runs in the
// last, ragged tile only (FA_TAIL_EXP / FA_TAIL_EXP2 of flash.cuh); A takes
// the natural exp with the plain scale, B folds log2(e) into the scale and
// takes exp2.
// What bounds it: as row 3, the tensor cores (at the script's [64, 12, 1190,
// 64] the two products are 278.5 GFLOP against 468 MB of q/k/v/o).
// Design: flash.cuh's mma.sync forward, each variant its own symbol and
// instantiation, four blocks an SM (FA_MIN_BLOCKS).
// Head dims built: 32 and 64.

#include "flash.cuh"

namespace t4s {

template <int HD, int MODE>
__global__ void __launch_bounds__(FA_THREADS, FA_MIN_BLOCKS)
flash_variant_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rows<bf16> o,
                     int n, float scale) {
  __shared__ __align__(16) unsigned char smem[fa_smem_bytes<HD>()];
  flash_fwd_body<HD, MODE>(smem, q, k, v, o, Rows<const float>{nullptr, 0, 0, 0}, n, scale);
}

template <int MODE>
static int launch_flash_variant(const void* q, const void* k, const void* v, void* o, int batch,
                                int n, int heads, int head_dim, const long long* s,
                                float sm_scale, void* stream) {
  const Rows<const bf16> qr{static_cast<const bf16*>(q), s[0], s[1], s[2]};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), s[3], s[4], s[5]};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), s[6], s[7], s[8]};
  const Rows<bf16> orr{static_cast<bf16*>(o), s[9], s[10], s[11]};
  const dim3 grid((n + FA_BQ - 1) / FA_BQ, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = MODE == FA_TAIL_EXP ? sm_scale : sm_scale * 1.4426950408889634f;
  if (head_dim == 32)
    flash_variant_kernel<32, MODE><<<grid, FA_THREADS, 0, st>>>(qr, kr, vr, orr, n, scale);
  else if (head_dim == 64)
    flash_variant_kernel<64, MODE><<<grid, FA_THREADS, 0, st>>>(qr, kr, vr, orr, n, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s

// q/k/v/o: bf16 [B, H, T, d] views (unit stride along d; batch, head and row
// strides in elements, multiples of 8). Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for a head dim not built.
extern "C" int t4s_flash_variant_a_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int n, int heads, int head_dim, long long q_bs,
                                       long long q_hs, long long q_rs, long long k_bs,
                                       long long k_hs, long long k_rs, long long v_bs,
                                       long long v_hs, long long v_rs, long long o_bs,
                                       long long o_hs, long long o_rs, float sm_scale,
                                       void* stream) {
  const long long s[12] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs};
  return t4s::launch_flash_variant<t4s::FA_TAIL_EXP>(q, k, v, o, batch, n, heads, head_dim, s,
                                                     sm_scale, stream);
}

extern "C" int t4s_flash_variant_b_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int n, int heads, int head_dim, long long q_bs,
                                       long long q_hs, long long q_rs, long long k_bs,
                                       long long k_hs, long long k_rs, long long v_bs,
                                       long long v_hs, long long v_rs, long long o_bs,
                                       long long o_hs, long long o_rs, float sm_scale,
                                       void* stream) {
  const long long s[12] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs};
  return t4s::launch_flash_variant<t4s::FA_TAIL_EXP2>(q, k, v, o, batch, n, heads, head_dim, s,
                                                      sm_scale, stream);
}
