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
// so a row blocked everywhere attends every key alike, as in JAX; only the
// ragged key tail beyond T is -inf. Nothing is padded: the TPU kernel pads T
// and the bias to its block size, this one masks the tail in-kernel.
//
// What bounds it: at the masked decoder's shape (B=8, H=12, T=1000, d=64) the
// bias is 384 MB against 49 MB of q/k/v/o, and the two products 24.6 GFLOP:
// about 57 FLOP per byte, below the H100's ~295 FLOP/byte ridge, so the bias
// read bounds it (0.13 ms at 3.35 TB/s).
// Design: flash.cuh's forward (one block of 4 warps per 64 query rows, K/V
// tiles of 64 keys in shared memory, mma.sync m16n8k16, f32 online softmax in
// exp2) with FA_BIAS: each thread reads its score fragments' bias elements of
// the [64 q x 64 k] tile straight from global memory into registers before
// the tile's first product, so the loads overlap the K/V staging and QK^T;
// one warp load covers 8 rows of 32 contiguous bytes, whole sectors. Every
// bias byte is read once. The 32 bias registers of a tile take the kernel past
// the 128-register budget of four blocks an SM, so it runs three
// (FA_BIAS_MIN_BLOCKS). The plain first version: no TMA, no wgmma, no double
// buffering.
// Head dims built: 32 (PMAM's decoder) and 64 (the flagship's).

#include "flash.cuh"

namespace t4s {

constexpr int FA_BIAS_MIN_BLOCKS = 3;

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, FA_BIAS_MIN_BLOCKS)
flash_bias_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rows<bf16> o,
                  Rows<const float> bias, int n, float scale_log2) {
  __shared__ __align__(16) unsigned char smem[fa_smem_bytes<HD>()];
  flash_fwd_body<HD, FA_BIAS>(smem, q, k, v, o, bias, n, scale_log2);
}

template <int HD>
static int launch_flash_bias(int batch, int n, int heads, void* stream, Rows<const bf16> q,
                             Rows<const bf16> k, Rows<const bf16> v, Rows<const float> bias,
                             Rows<bf16> o, float sm_scale) {
  const dim3 grid((n + FA_BQ - 1) / FA_BQ, heads, batch);
  flash_bias_kernel<HD><<<grid, FA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, bias, n, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s

// q/k/v: bf16 [B, H, T, d] views (unit stride along d; batch, head and row
// strides in elements, multiples of 8); bias: f32 [B, H, T, T] view with unit
// column stride and any batch, head (0 allowed) and row strides; o: bf16
// [B, H, T, d] view with its strides. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for a head dim not built.
extern "C" int t4s_flash_bias_fwd(const void* q, const void* k, const void* v, const void* bias,
                                  void* o, int batch, int n, int heads, int head_dim,
                                  long long q_bs, long long q_hs, long long q_rs, long long k_bs,
                                  long long k_hs, long long k_rs, long long v_bs, long long v_hs,
                                  long long v_rs, long long b_bs, long long b_hs, long long b_rs,
                                  long long o_bs, long long o_hs, long long o_rs, float sm_scale,
                                  void* stream) {
  using namespace t4s;
  const Rows<const bf16> qr{static_cast<const bf16*>(q), q_bs, q_hs, q_rs};
  const Rows<const bf16> kr{static_cast<const bf16*>(k), k_bs, k_hs, k_rs};
  const Rows<const bf16> vr{static_cast<const bf16*>(v), v_bs, v_hs, v_rs};
  const Rows<const float> br{static_cast<const float*>(bias), b_bs, b_hs, b_rs};
  const Rows<bf16> orr{static_cast<bf16*>(o), o_bs, o_hs, o_rs};
  if (head_dim == 32) return launch_flash_bias<32>(batch, n, heads, stream, qr, kr, vr, br, orr,
                                                   sm_scale);
  if (head_dim == 64) return launch_flash_bias<64>(batch, n, heads, stream, qr, kr, vr, br, orr,
                                                   sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
