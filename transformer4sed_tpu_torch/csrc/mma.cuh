// Warp-level bf16 tensor-core helpers shared by the attention kernels.
//
// mma.sync.m16n8k16 (row.col, bf16 in, f32 accumulate). Fragment layout,
// with g = lane / 4 and t = lane % 4:
//   A 16x16 (4 x b32): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B 16x8  (2 x b32): b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C 16x8  (4 x f32): c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// The C layout of two neighbouring 16x8 score tiles is exactly the A
// layout of one 16x16 slice, so softmax probabilities feed the P.V
// product straight from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t4s {

typedef __nv_bfloat16 bf16;

// One [B, H, T, d] operand: base pointer and batch / head / row strides in
// elements (unit stride along d).
template <typename T>
struct Rows {
  T* ptr;
  long long bs, hs, rs;
  __host__ __device__ __forceinline__ T* at(int b, int h) const {
    return ptr + (long long)b * bs + (long long)h * hs;
  }
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one b32 of bf16 (lo in the low half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy `rows` rows of HD bf16 from global (row stride `ld_g` elements)
// into shared memory (row pitch `ld_s`), 16 bytes per thread per step;
// rows with index >= `valid` are zero-filled.
template <int HD, int NTHREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld_s, const bf16* src,
                                          long long ld_g, int rows, int valid) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < rows * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (long long)r * ld_g + cc);
    *reinterpret_cast<uint4*>(dst + r * ld_s + cc) = val;
  }
}

// Same, but stores the tile transposed (dst[col][row]), so the P.V
// product reads V as the column-major B operand with 32-bit loads.
template <int HD, int NTHREADS>
__device__ __forceinline__ void load_rows_transposed(bf16* dst, int ld_s, const bf16* src,
                                                     long long ld_g, int rows, int valid) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < rows * CH; c += NTHREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (long long)r * ld_g + cc);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(cc + i) * ld_s + r] = e[i];
  }
}

}  // namespace t4s
