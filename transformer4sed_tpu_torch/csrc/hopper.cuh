// Hopper (sm_90a) building blocks of the flash attention forward
// (flash_fwd.cuh), the XL forward of both layouts (xl_fwd.cuh), the flash
// and XL backwards (flash_bwd.cuh, xl_bwd.cuh) and the Swin window
// attention (window.cuh):
// the operand views (Rows) and the quad reductions every body shares,
// warpgroup products (wgmma), their shared-memory descriptors, mbarriers,
// named barriers, TMA tile copies and reductions, bulk copies, cp.async copies
// that land on an mbarrier, and on the host the tensor maps those copies
// read.
//
// wgmma m64nNk16 (bf16 in, f32 accumulate), issued by one warpgroup of four
// warps. Accumulator layout, with w the warp in the group, g = lane / 4 and
// t = lane % 4: d[4j + e] holds D[16w + g + 8(e / 2)][8j + 2t + e % 2]. The
// A operand from registers (wgmma_rs), a[kk][f] for the k16 step kk, holds
// row 16w + g + 8(f % 2), columns 16kk + 2t + 8(f / 2) and the next, so the
// accumulator of one product, rounded to bf16 in pairs, is the A operand of
// the next (acc_to_a).
//
// Shared-memory operands are tiles that TMA wrote with a 128-byte (rows of
// 64 bf16) or 64-byte (rows of 32 bf16) swizzle, each tile 1024-byte
// aligned. A descriptor names the tile's start, the stride between groups
// of 8 rows (SBO) and the swizzle. Read "K-major" (the reduction dim along
// the row: trans 0) a k16 step is 32 bytes further along the row; read
// "MN-major" (the row is the M or N dim: trans 1) a k16 step is 16 rows
// further down. Without a swizzle (desc_ns) an operand is a grid of core
// matrices of 8 rows by 16 bytes, each 128 contiguous bytes, with strides of
// their own along K (leading offset) and along M or N (stride offset).
#pragma once

#include <cuda.h>
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

// Two floats -> one b32 of bf16 (lo in the low half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The max and the sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of copies that will complete on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Wait until the phase of parity `parity` has completed. A phase that has
// not completed after 10 s is a fault (a copy that never lands): trap, so
// that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > 10000000000ull) {
      __trap();
    }
  }
}

// -- TMA and bulk copies, completing on an mbarrier ------------------------------

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-D tensor map at coordinates (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from 16-byte aligned global memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes from global to shared memory (cp.async, through L1), of which the
// first `src_bytes` (4 or 0) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned (cp.async, past L1), of which the
// first `src_bytes` (0 to 16) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed (.noinc: the barrier's count includes these arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Add a shared-memory box into global memory at coordinates (c0, c1) of a
// 2-D f32 tensor map, in one bulk group of the calling thread.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}

// Write a shared-memory box to global memory at coordinates (c0, c1, c2) of
// a 3-D tensor map, in one bulk group of the calling thread.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Layout codes of the descriptor (bits 62-63) and the TMA swizzle that matches.
constexpr uint64_t SWIZZLE_128B = 1, SWIZZLE_64B = 2;

// Descriptor of a swizzled shared-memory operand starting at `p`; `sbo` is
// the byte stride between groups of 8 rows (8 rows of the tile, read
// K-major; 8 steps along K, read MN-major). The leading byte offset is 16
// (unused: every operand here is one swizzle atom wide).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// Descriptor of an operand without swizzle starting at `p`: `lbo` the byte
// stride between core matrices along K, `sbo` along M or N.
__device__ __forceinline__ uint64_t desc_ns(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// 2^x (the MUFU approximation, flushing subnormals; 2^-inf = 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The k16 step `kk` of an m64nN accumulator (N = 16 * KS columns), rounded to
// bf16, as the A operand of wgmma_rs (its K is the accumulator's N).
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// Four 8x8 bf16 matrices from registers to shared memory (`addr`: this
// lane's row of matrix lane / 8).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// Generic-proxy shared-memory writes (stmatrix) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup's m64n(HD/2) f32 accumulator (w the warp in the group) to shared
// memory as one TMA box of 64 rows by HD/2 floats, in the swizzle of the f32
// maps of f32_box_map (128-byte rows at HD = 64, 64-byte rows at HD = 32). At
// HD = 64 odd g store their column blocks in the order j ^ 2, so that the 16
// lanes of each 8-byte store hit 16 distinct bank pairs.
template <int HD>
__device__ __forceinline__ void stage_box(float* dst, const float (&acc)[HD / 4], int w, int g,
                                          int t) {
  constexpr int FLIP = HD == 64 ? 2 : 0;
  const bool flip = (g & 1) != 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w * 16 + g + 8 * r;
    const int swz = HD == 64 ? (row & 7) : ((row >> 1) & 3);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      const int j = flip ? k ^ FLIP : k;
      const float x = flip ? acc[4 * (k ^ FLIP) + 2 * r] : acc[4 * k + 2 * r];
      const float y = flip ? acc[4 * (k ^ FLIP) + 2 * r + 1] : acc[4 * k + 2 * r + 1];
      const int chunk = (2 * j + (t >> 1)) ^ swz;
      *reinterpret_cast<float2*>(dst + row * (HD / 2) + chunk * 4 + (t & 1) * 2) =
          make_float2(x, y);
    }
  }
}

// The backwards' side pair of one query row: (L * log2 e, delta = rowsum(dO *
// O) in f32) for a row < T (`live`), +inf and 0 past T, +inf where L is -inf,
// so that the row's weights are 0 without a test. HD / 8 neighbouring lanes
// take one row, 16 bytes of O and dO each (`part`); part 0 writes the pair.
template <int HD>
__device__ __forceinline__ void side_pair(const bf16* o_row, const bf16* do_row, float l,
                                          bool live, int part, float* dst) {
  float acc = 0.f;
  if (live) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o_row + part * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(do_row + part * 8);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += __bfloat162float(oe[i]) * __bfloat162float(ge[i]);
  }
#pragma unroll
  for (int off = HD / 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0)
    *reinterpret_cast<float2*>(dst) =
        make_float2(!live || l == -INFINITY ? INFINITY : l * 1.4426950408889634f, acc);
}

// Hand registers back to (dec) or take them from (inc) the block's pool, for
// every thread of the calling warpgroup; N a multiple of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier over `threads` threads (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on a named barrier without waiting: counts toward the `threads`
// that a bar_sync of the same id waits for.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. wgmma_ss (N = 128, 64, 32,
// 24, 16): A and B from shared memory (descriptors; TA, TB: 1 = MN-major; at
// N = 128, SA = -1 negates A); wgmma_rs (N = 128, 64, 32, 24): A from
// registers, B from shared memory. acc = 0 overwrites D.
template <int TA, int TB, int SA = 1>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, %69, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB), "n"(SA));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[12], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, %15, %16;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[12], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// -- host side: tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no -lcuda).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The number of SMs of the current device (a persistent grid's size; 0 if
// it cannot be read).
static int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return count;
}

// A 4-D map (d, heads, rows, batch) over one [B, H, T, d] operand, boxes of
// `box_rows` rows of one (batch, head), swizzled as the wgmma descriptors read
// them; rows past T read as zeros.
static bool tensor_map(EncodeTiledFn encode, CUtensorMap* map, Rows<const bf16> x, int batch,
                       int heads, int n, int hd, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)x.hs * 2, (cuuint64_t)x.rs * 2, (cuuint64_t)x.bs * 2};
  const cuuint32_t box[4] = {(cuuint32_t)hd, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x.ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map (columns, rows) over a row-major f32 array [rows, cols], boxes of
// 64 rows by `box_cols` floats (32 or 16: one stage_box), swizzled as
// stage_box stores them; the target of the backwards' TMA reductions.
static bool f32_box_map(EncodeTiledFn encode, CUtensorMap* map, float* base, long long rows,
                        int cols, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, 64};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace t4s
