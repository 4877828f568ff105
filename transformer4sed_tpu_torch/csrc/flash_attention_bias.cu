// Head-major flash attention forward with an additive score bias for Hopper
// (sm_90a).
//
// t4s_flash_bias_fwd replaces the Pallas TPU kernel
// transformer4sed_tpu/kernels/flash_attention.py:_flash_bias_forward (line
// 183, kernel body _flash_bias_kernel line 153):
//   softmax(scale * Q K^T + bias) V
// on head-major q, k, v [B, H, T, d] (bf16) with an f32 bias [B, H, T, T],
// each operand with its own batch, head and row strides: the XL attention's
// explicitly masked branch hands in strided [B, H, T, d] views of its
// [B, T, 3*H*d] projection, and a bias whose batch or head stride is 0 (an
// expanded view) is read without a copy. A blocked score comes in as -1e30,
// so a row blocked everywhere attends every key alike, as in JAX (in f32,
// -1e30 * log2 e absorbs the scaled product, so every weight is 1); only the
// ragged key tail beyond T is -inf. Nothing is padded: the TPU kernel pads T
// and the bias to its block size, this one masks the tail in the last key
// tile and reads no bias element past row or column T - 1.
//
// What bounds it: at the masked decoder's shape (B=8, H=12, T=1000, d=64) the
// bias is 384 MB against 49 MB of q/k/v/o, and the two products 24.6 GFLOP:
// about 57 FLOP per byte, below the H100's ~295 FLOP/byte ridge, so the bias
// read bounds it (0.13 ms at 3.35 TB/s). A 128 x 128 bias tile takes an SM
// about 4700 clocks to receive at its share of that rate, its two products
// and its exps about 1000 each: the math only has to stay out of the
// stream's way, and by Little's law some 25 KB must be in flight on every SM
// at all times.
// Design: flash_fwd.cuh's body in its FF_BIAS mode (design there): the
// producer warpgroup's 128 threads stream the bias through two 64-KB
// shared-memory stages with cp.async beside the K/V TMA ring, so one stage is
// always in flight and every bias byte is read once in whole lines (16
// bytes a lane where the bias's address and strides are 16-byte multiples,
// else 4: TMA would need that of every stride, and T = 37 breaks it); two
// consumer warpgroups run wgmma and read their bias
// elements from the tile in the accumulator's layout, handing the stage back
// at once.
// Head dims built: 32 (PMAM's decoder) and 64 (the flagship's).

#include "flash_fwd.cuh"

// q/k/v: bf16 [B, H, T, d] views (unit stride along d; batch, head and row
// strides in elements, multiples of 8, 16-byte aligned); bias: f32
// [B, H, T, T] view with unit column stride and any batch, head (0 allowed)
// and row strides; o: bf16 [B, H, T, d] view with its strides.
// skip_tail_mask: 1 leaves the last key tile unmasked (only a planted fault
// sets it). Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for a head dim not built.
extern "C" int t4s_flash_bias_fwd(const void* q, const void* k, const void* v, const void* bias,
                                  void* o, int batch, int n, int heads, int head_dim,
                                  int skip_tail_mask, long long q_bs, long long q_hs,
                                  long long q_rs, long long k_bs, long long k_hs, long long k_rs,
                                  long long v_bs, long long v_hs, long long v_rs, long long b_bs,
                                  long long b_hs, long long b_rs, long long o_bs, long long o_hs,
                                  long long o_rs, float sm_scale, void* stream) {
  using namespace t4s;
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, q_hs, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, k_hs, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, v_hs, v_rs};
  const Rows<const float> br{static_cast<const float*>(bias), b_bs, b_hs, b_rs};
  const Rows<bf16> orr{static_cast<bf16*>(o), o_bs, o_hs, o_rs};
  if (head_dim == 32)
    return launch_flash_fwd<32, FF_BIAS>(batch, n, heads, stream, qr, kr, vr, orr, nullptr, br,
                                         skip_tail_mask, sm_scale);
  if (head_dim == 64)
    return launch_flash_fwd<64, FF_BIAS>(batch, n, heads, stream, qr, kr, vr, orr, nullptr, br,
                                         skip_tail_mask, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
