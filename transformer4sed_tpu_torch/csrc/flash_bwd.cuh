// Flash attention backward for Hopper (sm_90a): the device code shared by the
// heads-in-lanes entry point (flash_attention_bwd.cu, row 8) and the
// head-major one (flash_attention_hm_bwd.cu, row 6), with the two passes
// around it.
//
// From the saved output O and row log-sum-exp L of the forward:
//   P  = exp(scale * Q K^T - L)
//   dV = P^T dO                      (P rounded to bf16)
//   dS = P * (dO V^T - delta)        (rounded to bf16), delta = rowsum(dO * O)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// Every operand is a [B, H, T, d] view with its own batch, head and row
// strides (Rows, mma.cuh): [B, N, H*d] lane slices and head-major views
// alike. HD is the head dim; 64 (rows 8 and 6) and 32 (row 6) are built.
//
// What bounds it: five products of 2*T^2*d per (batch, head), 261 GFLOP at
// B=24, T=1190, H=12, d=64, against ~200 MB of operands and results: 0.2639
// ms at the H100's 989 TFLOP/s, far above its ~295 FLOP/byte ridge, so the
// tensor cores bound it.
//
// Design.
// * The pre-pass (flash_bwd_prepass_kernel) reads dO and O once, in bf16
//   through their strides, and writes per query row the pair (L * log2 e,
//   delta) in f32 to a side buffer [B, H, T_pad, 2] (T_pad = T rounded up to
//   64; a padded row and a row whose L is -inf get +inf, so that its P is 0
//   without a test), and zeroes the f32 dQ workspace [B, H, T_pad, d] in the
//   same launch.
// * The main kernel runs one block per (128-key tile, head, batch): two
//   consumer warpgroups of 64 keys each and a producer warpgroup, one thread
//   of which issues every copy. It loads the block's K and V once and
//   streams 64-row query tiles of Q and dO (TMA, from 4-D tensor maps over
//   (d, heads, rows, batch) whose out-of-bounds fill zeroes the ragged tail)
//   with their side rows (a bulk copy) through a ring of FB_STAGES stages,
//   each guarded by a full and an empty mbarrier. Each consumer computes
//   S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory, forms P^T
//   (the MUFU's ex2.approx) and dS^T in the accumulator registers, and adds
//   dV += P^T dO and dK += dS^T Q with wgmma whose A is that accumulator
//   rounded to bf16 and whose B is the same dO and Q tiles read MN-major: no
//   operand is transposed by a copy. dS^T goes once to
//   shared memory (stmatrix, in the 128-byte swizzle); after a named barrier
//   over both warpgroups, each computes half of dQ = dS K over the block's
//   128 keys (wgmma, both operands from shared memory, MN-major), stores
//   that 64 x d/2 f32 partial to shared memory in the workspace's swizzled
//   layout, and one thread adds it to the workspace with one TMA reduction
//   (cp.reduce.async.bulk.tensor .add, double-buffered): no atomics, ten
//   partials per query row at T = 1190.
// * The post-pass (flash_bwd_postpass_kernel) writes dQ = scale * workspace
//   in bf16 through the caller's strides.
// One block an SM of three warpgroups: 168 registers a thread at launch,
// where the consumers need ~200 (dK, dV, S^T, dP^T accumulators and the dQ
// half). setmaxnreg moves the producer warpgroup down to 40 and the
// consumers up to 232; the block's register pool holds just that.
#pragma once

#include "hopper.cuh"

namespace t4s {

constexpr int FB_KEYS = 128;         // keys per block
constexpr int FB_QROWS = 64;         // query rows per stage
constexpr int FB_STAGES = 3;         // query tiles in flight
constexpr int FB_CONSUMERS = 256;    // two warpgroups
constexpr int FB_THREADS = FB_CONSUMERS + 128;  // and the producer warpgroup
// 384 threads at one block an SM start with 168 registers each; the producer
// warpgroup (one warp issues the copies, three idle) hands its share to the
// consumers: 128 * 40 + 256 * 232 = 384 * 168
constexpr int FB_PRODUCER_REGS = 40;
constexpr int FB_CONSUMER_REGS = 232;
constexpr int FB_SIDE_BYTES = FB_QROWS * 2 * 4;  // (L * log2 e, delta) per row
constexpr int FB_DS_BYTES = FB_KEYS * FB_QROWS * 2;  // dS^T [128 keys][64 queries] bf16
constexpr float FB_LOG2E = 1.4426950408889634f;

template <int HD>
struct FbSmem {
  static constexpr int ROW = HD * 2;  // bytes of one tile row
  static constexpr int KV_TILE = FB_KEYS * ROW;
  static constexpr int Q_TILE = FB_QROWS * ROW;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_TILE;
  static constexpr int Q_OFF = V_OFF + KV_TILE;
  static constexpr int DO_OFF = Q_OFF + FB_STAGES * Q_TILE;
  static constexpr int DS_OFF = DO_OFF + FB_STAGES * Q_TILE;  // two buffers
  static constexpr int DQ_TILE = FB_QROWS * HD / 2 * 4;  // one warpgroup's f32 dQ half
  static constexpr int DQ_OFF = DS_OFF + 2 * FB_DS_BYTES;   // two buffers of both halves
  static constexpr int SIDE_OFF = DQ_OFF + 2 * 2 * DQ_TILE;
  static constexpr int BAR_OFF = SIDE_OFF + FB_STAGES * FB_SIDE_BYTES;
  // kv_full, full[FB_STAGES], empty[FB_STAGES]; then slack to align the base to 1024
  static constexpr int BYTES = BAR_OFF + (1 + 2 * FB_STAGES) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(FB_THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdq, const float* __restrict__ side,
                 Rows<bf16> dk, Rows<bf16> dv, int n, int skip_dq_tile, float scale,
                 float scale_log2) {
  using namespace hopper;
  using L = FbSmem<HD>;
  constexpr int ROW = L::ROW;
  constexpr uint64_t SW = HD == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  static_assert(HD == 64 || HD == 32, "head dims 32 and 64 are built");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + FB_STAGES;

  const int j0 = blockIdx.x * FB_KEYS, h = blockIdx.y, b = blockIdx.z;
  const int nq = (n + FB_QROWS - 1) / FB_QROWS, n_pad = nq * FB_QROWS;
  const long long bh = (long long)b * gridDim.y + h;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < FB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= FB_CONSUMERS / 32) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<FB_PRODUCER_REGS>();
    if (warp == FB_CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_TILE);
      tma_load_4d(smem + L::K_OFF, &tk, kv_full, 0, h, j0, b);
      tma_load_4d(smem + L::V_OFF, &tv, kv_full, 0, h, j0, b);
      for (int it = 0; it < nq; ++it) {
        const int s = it % FB_STAGES;
        if (it >= FB_STAGES) mbar_wait(&empty[s], (it / FB_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::Q_TILE + FB_SIDE_BYTES);
        tma_load_4d(smem + L::Q_OFF + s * L::Q_TILE, &tq, &full[s], 0, h, it * FB_QROWS, b);
        tma_load_4d(smem + L::DO_OFF + s * L::Q_TILE, &tdo, &full[s], 0, h, it * FB_QROWS, b);
        bulk_load(smem + L::SIDE_OFF + s * FB_SIDE_BYTES,
                  side + (bh * n_pad + (long long)it * FB_QROWS) * 2, FB_SIDE_BYTES, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: keys wg*64 .. wg*64+63 of the block
  setmaxnreg_inc<FB_CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;  // issues the warpgroup's dQ reductions
  const unsigned char* sK = smem + L::K_OFF;
  const unsigned char* sKw = sK + wg * 64 * ROW;
  const unsigned char* sVw = smem + L::V_OFF + wg * 64 * ROW;
  const int key0 = j0 + wg * 64 + wl * 16 + g;  // this thread's keys: key0, key0 + 8
  const bool key_ok[2] = {key0 < n, key0 + 8 < n};

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[32], dpt[32], dq[HD / 4];
  uint32_t pa[4][4], sa[4][4];

  mbar_wait(kv_full, 0);
  __syncwarp();
  for (int it = 0; it < nq; ++it) {
    const int s = it % FB_STAGES;
    const unsigned char* sQ = smem + L::Q_OFF + s * L::Q_TILE;
    const unsigned char* sdO = smem + L::DO_OFF + s * L::Q_TILE;
    const float* sSide = reinterpret_cast<const float*>(smem + L::SIDE_OFF + s * FB_SIDE_BYTES);
    mbar_wait(&full[s], (it / FB_STAGES) & 1);
    __syncwarp();  // converged again for the .sync.aligned wgmma instructions

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, K-major operands
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(st, desc(sKw + kk * 32, 8 * ROW, SW), desc(sQ + kk * 32, 8 * ROW, SW), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(dpt, desc(sVw + kk * 32, 8 * ROW, SW), desc(sdO + kk * 32, 8 * ROW, SW),
                     kk);
    wgmma_commit();
    float4 ld[8];  // (L2, delta) of queries 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ld[j] = *reinterpret_cast<const float4*>(sSide + 2 * (8 * j + 2 * t));
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp2(scale log2e S^T - L2), dS^T = P^T (dP^T - delta); keys past n weigh 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = (e & 1) ? ld[j].z : ld[j].x;
        const float dl = (e & 1) ? ld[j].w : ld[j].y;
        const int i = 4 * j + e;
        const float p = key_ok[e >> 1] ? ex2_approx(st[i] * scale_log2 - l2) : 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - dl);
      }
    acc_to_a(st, pa);
    acc_to_a(dpt, sa);

    // dV += P^T dO, dK += dS^T Q: A from registers, B (dO, Q) read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dv_acc, pa[kk], desc(sdO + kk * 16 * ROW, 8 * ROW, SW), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(dk_acc, sa[kk], desc(sQ + kk * 16 * ROW, 8 * ROW, SW), 1);
    wgmma_commit();

    // dS^T [128 keys][64 queries] to shared memory, 128-byte swizzle; both halves
    unsigned char* sdS = smem + L::DS_OFF + (it & 1) * FB_DS_BYTES;
    {
      const int mi = lane >> 3, r = lane & 7;  // this lane's row r of matrix mi
      const uint32_t row = smem_u32(sdS) + (wg * 64 + wl * 16 + (mi & 1) * 8 + r) * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) stmatrix_x4(row + (((2 * kk + (mi >> 1)) ^ r) << 4), sa[kk]);
    }
    fence_proxy_async();
    if (issuer) bulk_wait_read<1>();  // the reduction two tiles back has left its buffer
    bar_sync(1, FB_CONSUMERS);

    // this warpgroup's d/2 columns of the dQ partial: dS (MN-major) times K (MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FB_KEYS / 16; ++kk)
      wgmma_ss<1, 1>(dq, desc(sdS + kk * 16 * 128, 1024, SWIZZLE_128B),
                     desc(sK + kk * 16 * ROW + wg * HD, 8 * ROW, SW), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(sa);
    if (issuer) mbar_arrive(&empty[s]);  // Q, dO and side rows consumed

    // the 64 x d/2 f32 partial to shared memory in the layout of the workspace's
    // tensor map (rows of d/2 floats, swizzled), then one TMA reduction adds it
    float* sdq = reinterpret_cast<float*>(smem + L::DQ_OFF + ((it & 1) * 2 + wg) * L::DQ_TILE);
    stage_box<HD>(sdq, dq, wl, g, t);
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (issuer && (int)blockIdx.x != skip_dq_tile) {
      tma_reduce_add_2d(&tdq, sdq, wg * (HD / 2), (int)(bh * n_pad) + it * FB_QROWS);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const int key = key0 + 8 * r;
    bf16* dkr = dk.at(b, h) + (long long)key * dk.rs + 2 * t;
    bf16* dvr = dv.at(b, h) + (long long)key * dv.rs + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
          pack_bf16(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * j) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// The pre-pass: per (batch, head, row < T_pad) the side pair (L * log2 e or
// +inf, delta = rowsum(dO * O) in f32, 0 past T) and a zeroed workspace row.
// HD / 8 threads a row, 16 bytes each; the grid covers B * H * T_pad rows
// exactly (T_pad is a multiple of 64).
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prepass_kernel(Rows<const bf16> o, Rows<const bf16> dout, const float* __restrict__ lse,
                         float* __restrict__ side, float* __restrict__ dq_acc, int n, int n_pad,
                         int heads) {
  constexpr int TPR = HD / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / TPR;
  const int part = idx % TPR;
  const int r = row % n_pad;
  const long long bh = row / n_pad;
  const int b = bh / heads, h = bh % heads;
  const bool live = r < n;
  hopper::side_pair<HD>(o.at(b, h) + (long long)r * o.rs, dout.at(b, h) + (long long)r * dout.rs,
                        live ? lse[bh * n + r] : 0.f, live, part, side + row * 2);
  float4* z = reinterpret_cast<float4*>(dq_acc + row * HD + part * 8);
  z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The post-pass: dq[b, h, r, :] = bf16(scale * workspace[b, h, r, :]) for r < T,
// 8 elements a thread.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_postpass_kernel(const float* __restrict__ dq_acc, Rows<bf16> dq, int n, int n_pad,
                          int heads, long long chunks, float scale) {
  constexpr int CPR = HD / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= chunks) return;
  const long long row = idx / CPR;
  const int part = idx % CPR;
  const int r = row % n;
  const long long bh = row / n;
  const int b = bh / heads, h = bh % heads;
  const float4* src = reinterpret_cast<const float4*>(dq_acc + (bh * n_pad + r) * HD + part * 8);
  const float4 lo = src[0], hi = src[1];
  uint4 out;
  out.x = pack_bf16(lo.x * scale, lo.y * scale);
  out.y = pack_bf16(lo.z * scale, lo.w * scale);
  out.z = pack_bf16(hi.x * scale, hi.y * scale);
  out.w = pack_bf16(hi.z * scale, hi.w * scale);
  *reinterpret_cast<uint4*>(dq.at(b, h) + (long long)r * dq.rs + part * 8) = out;
}

// -- host side ----------------------------------------------------------------------

static inline int padded_rows(int n) { return (n + FB_QROWS - 1) / FB_QROWS * FB_QROWS; }

// Launch the main kernel on `stream`; returns cudaGetLastError() after the
// launch (0 = launched). side and dq_acc come from the pre-pass; the key tile
// `skip_dq_tile` adds no dQ partial (-1: every tile adds its own).
template <int HD>
static int launch_flash_bwd(int batch, int n, int heads, void* stream, Rows<const bf16> q,
                            Rows<const bf16> k, Rows<const bf16> v, Rows<const bf16> dout,
                            const float* side, float* dq_acc, Rows<bf16> dk, Rows<bf16> dv,
                            int skip_dq_tile, float sm_scale) {
  using hopper::tensor_map;
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!tensor_map(encode, &tq, q, batch, heads, n, HD, FB_QROWS) ||
      !tensor_map(encode, &tk, k, batch, heads, n, HD, FB_KEYS) ||
      !tensor_map(encode, &tv, v, batch, heads, n, HD, FB_KEYS) ||
      !tensor_map(encode, &tdo, dout, batch, heads, n, HD, FB_QROWS) ||
      !hopper::f32_box_map(encode, &tdq, dq_acc, (long long)batch * heads * padded_rows(n), HD,
                               HD / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = FbSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + FB_KEYS - 1) / FB_KEYS, heads, batch);
  flash_bwd_kernel<HD><<<grid, FB_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, tdq, side, dk, dv, n, skip_dq_tile, sm_scale, sm_scale * FB_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
static int launch_flash_bwd_prepass(int batch, int n, int heads, void* stream,
                                    Rows<const bf16> o, Rows<const bf16> dout, const float* lse,
                                    float* side, float* dq_acc) {
  const int n_pad = padded_rows(n);
  const long long threads = (long long)batch * heads * n_pad * (HD / 8);  // a multiple of 256
  flash_bwd_prepass_kernel<HD><<<(unsigned)(threads / 256), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(o, dout, lse, side, dq_acc,
                                                                      n, n_pad, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
static int launch_flash_bwd_postpass(int batch, int n, int heads, void* stream,
                                     const float* dq_acc, Rows<bf16> dq, float sm_scale) {
  const long long chunks = (long long)batch * heads * n * (HD / 8);
  flash_bwd_postpass_kernel<HD><<<(unsigned)((chunks + 255) / 256), 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      dq_acc, dq, n, padded_rows(n), heads, chunks, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
