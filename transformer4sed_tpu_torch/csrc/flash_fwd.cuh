// Flash attention forward for Hopper (sm_90a): the device code shared by the
// heads-in-lanes entry points (flash_attention.cu, rows 1 and 7), the
// head-major ones (flash_attention_hm.cu, rows 3 and 5), the biased one
// (flash_attention_bias.cu, row 4) and the experiment's variants
// (flash_variants.cu, row 16), each a mode of the one body (FfMode).
//
//   softmax(scale * Q K^T [+ bias]) V  per (batch, head)
// Every operand is a [B, H, T, d] view with its own batch, head and row
// strides (Rows, hopper.cuh): [B, N, H*d] lane slices of a projection and
// head-major views alike. WITH_LSE also writes the natural-log row
// log-sum-exp lse [B, H, T] f32 that the backward (flash_bwd.cuh) recomputes
// the probabilities from: -inf for a row with no valid key, never NaN. HD is
// the head dim; 64 (rows 1, 3, 4, 5, 7, 16) and 32 (rows 3, 4, 5, 16) are built.
//
// What bounds it: the two products are 4*T^2*d operations per (batch, head)
// against 4*T*d*2 bytes of q/k/v/o, about T/2 operations per byte: some 600
// at T = 1190, above the H100's ~295 FLOP/byte ridge, so the tensor cores
// bound it (34.8 GFLOP at B=8, H=12, d=64: 0.0352 ms at 989 TFLOP/s). Next
// comes the exp: one per score, 16 a clock on an SM's MUFU units, against
// about 4096 bf16 operations (2048 multiply-adds) a clock on its tensor cores
// (989 TFLOP/s over 132 SMs at 1.83 GHz). A score costs the two products
// 2 * 2 * d operations, so at d = 64 the exps of a tile take as long as its
// two products, 1/16 clock a score each. FF_BIAS adds 4*T^2 bytes of f32
// bias: 57 operations a byte at d = 64, below the ridge, so the bias stream
// bounds it (flash_attention_bias.cu).
//
// Design. Work items of QROWS queries of one (batch, head); one block an SM
// walks them (w = blockIdx.x, + gridDim.x, ...), so that each item's loads
// start while the item before it finishes. A block is WGS consumer
// warpgroups of 64 query rows each and a producer warpgroup, one thread of
// which issues every TMA copy: the item's Q tile (once the last item's
// products have read it), then 128-key tiles of K and V (TMA, from 4-D tensor
// maps over (d, heads, rows, batch) whose out-of-bounds fill zeroes the ragged
// tail) through a ring of STAGES stages, each guarded by a full and an
// empty mbarrier. Every K/V tile is read from L2 once per item, so the
// item's 192 rows (not 128) cut that traffic by a third. Each consumer
// runs S = Q K^T as wgmma m64n128k16 from shared memory (both operands
// K-major; negated by the product itself for a negative scale), keeps the
// online softmax in the accumulator registers (scale * log2 e folded into
// one FFMA a score, row max and sum over the quad, ex2.approx; keys past T
// masked in the last tile only: earlier tiles are whole), and
// adds O += P V with a wgmma whose A is that accumulator rounded to bf16 and
// whose B is the V tile read MN-major: no operand is transposed by a copy.
// Tile j's P V is issued together with tile j+1's Q K^T, so one wait covers
// both, and the consumer warpgroups interleave their products and exps on
// their own. Rows past T are never written: in a [B, N, C] output, row T of
// batch b is row 0 of batch b+1. One block an SM of four warpgroups: 128
// registers a thread at launch; setmaxnreg moves the producer warpgroup down
// to 24 and the consumers up to 160 (S 64, O d/2, P 32 and the row state).
//
// FF_BIAS keeps the bias stream flowing: a bias tile (128 queries x 128 keys
// f32, 64 KB) a stage beside K and V, two stages; every thread of the
// producer warpgroup copies its share with cp.async (whole lines a warp
// request: 16 bytes a lane where the bias's address and strides allow it, as
// at the masked decoder's T = 1000, else 4; any row stride, a batch or head
// stride of 0 too; rows and columns past T zero-filled and never read), and
// each thread's copies arrive on the stage's bias mbarrier when they land.
// Two consumer warpgroups (128-query items) leave the shared memory for the
// two bias stages (2 x 68 KB, rows padded to 136 floats so that a warp's
// reads in the accumulator layout, 8 rows of 32 bytes, hit 32 banks) and
// registers for the copies and the softmax: 56 for the producer, 224 for
// the consumers. A consumer adds its
// bias elements to S straight from the tile (x = s * |scale| * log2 e +
// bias * log2 e, whose max is the row max: a bias does not commute with the
// scale) and hands the stage back at once, so that one stage is always in
// flight.
#pragma once

#include "hopper.cuh"

namespace t4s {

// What the scores get besides scale * Q K^T, chosen by the launcher (a
// template flag, one instantiation each):
//   FF_EXP2: nothing; exp2 with log2 e folded into the scale (rows 1, 3, 5, 7
//            and the experiment's variant B, row 16);
//   FF_EXP:  the same in the natural domain: the scaled score, then e^x as
//            ex2.approx(x * log2 e), one FMUL a score more (variant A, row 16);
//   FF_BIAS: an additive f32 bias [B, H, T, T] of any batch, head and row
//            strides (row 4), streamed through shared memory by the producer
//            warpgroup's 128 threads (cp.async), two consumer warpgroups.
enum FfMode { FF_EXP2, FF_EXP, FF_BIAS };

constexpr int FF_KEYS = 128;        // keys a stage
constexpr int FF_BIAS_PITCH = 136;  // floats a bias tile row: 8-row reads of 32 bytes hit 32 banks

template <int MODE>
struct FfShape {
  static constexpr int WGS = MODE == FF_BIAS ? 2 : 3;  // consumer warpgroups, 64 query rows each
  static constexpr int QROWS = 64 * WGS;               // query rows a work item
  static constexpr int STAGES = MODE == FF_BIAS ? 2 : 3;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  // the block's register pool: 128 * 24 + 384 * 160 = 512 * 126 (128 at
  // launch); FF_BIAS 128 * 56 + 256 * 224 = 384 * 168 (168 at launch)
  static constexpr int PRODUCER_REGS = MODE == FF_BIAS ? 56 : 24;
  static constexpr int CONSUMER_REGS = MODE == FF_BIAS ? 224 : 160;
};

template <int HD, int MODE>
struct FfSmem {
  using S = FfShape<MODE>;
  static constexpr int ROW = HD * 2;  // bytes of one tile row
  static constexpr int Q_TILE = S::QROWS * ROW;
  static constexpr int KV_TILE = FF_KEYS * ROW;
  static constexpr int B_TILE = MODE == FF_BIAS ? S::QROWS * FF_BIAS_PITCH * 4 : 0;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_TILE;
  static constexpr int V_OFF = K_OFF + S::STAGES * KV_TILE;
  static constexpr int B_OFF = V_OFF + S::STAGES * KV_TILE;
  static constexpr int BAR_OFF = B_OFF + S::STAGES * B_TILE;
  // q_full, q_empty, full[STAGES], empty[STAGES] (and, FF_BIAS, b_full[STAGES],
  // b_empty[STAGES]); then slack to align the base
  static constexpr int BARS = 2 + (MODE == FF_BIAS ? 4 : 2) * S::STAGES;
  static constexpr int BYTES = BAR_OFF + BARS * 8 + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block may have");
};

// FF_BIAS: the bias tile of stage `dst` (QROWS x 128 f32, rows FF_BIAS_PITCH
// apart) from rows i0.. and columns j0.. of one (batch, head)'s [T, T] bias
// `src` (row stride rs), copied by the producer warpgroup's thread pt: its
// warp takes every fourth row, and each warp request is whole lines: with
// `vec` (the bias's address and strides 16-byte multiples) 16 bytes a lane,
// a whole tile row a request; else 4 bytes a lane, 32 consecutive floats a
// request. Rows and columns past n are zero-filled and not read (the copy
// reads nothing at a valid address).
template <int QROWS>
__device__ __forceinline__ void ff_copy_bias(uint32_t dst, const float* src, long long rs, int i0,
                                             int j0, int n, int pt, bool vec) {
  const int lane = pt & 31, r0 = pt >> 5;
  const int rows = min(QROWS, n - i0);  // rows of the tile that exist
  const float* row = src + (long long)(i0 + r0) * rs + j0;
  dst += 4 * r0 * FF_BIAS_PITCH;
  if (vec) {
    const int bytes = 4 * max(0, min(4, n - j0 - 4 * lane));  // of this lane's 4 columns
    row += 4 * lane;
    dst += 16 * lane;
#pragma unroll 4
    for (int r = r0; r < QROWS; r += 4, row += 4 * rs, dst += 16 * FF_BIAS_PITCH) {
      const int got = r < rows ? bytes : 0;
      hopper::cp_async_16(dst, got ? row : src, got);
    }
    return;
  }
  const int cols = n - j0 - lane;  // this lane's column c exists while c < cols
  row += lane;
  dst += 4 * lane;
#pragma unroll 4
  for (int r = r0; r < QROWS; r += 4, row += 4 * rs, dst += 16 * FF_BIAS_PITCH) {
#pragma unroll
    for (int c = 0; c < FF_KEYS; c += 32) {
      const bool ok = r < rows && c < cols;
      hopper::cp_async_4(dst + 4 * c, ok ? row + c : src, ok ? 4 : 0);
    }
  }
}

// FF_BIAS: x = s * scale_log2 + bias * log2 e for this thread's part of a
// 64 x 128 score tile (the layout of ff_softmax), the bias read from the
// stage's tile at `bt`, this thread's first element (row g, column 2t).
__device__ __forceinline__ void ff_add_bias(float (&s)[64], const float* bt, float scale_log2) {
  constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 lo = *reinterpret_cast<const float2*>(bt + 8 * j);
    const float2 hi = *reinterpret_cast<const float2*>(bt + 8 * FF_BIAS_PITCH + 8 * j);
    s[4 * j] = fmaf(s[4 * j], scale_log2, lo.x * LOG2E);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale_log2, lo.y * LOG2E);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale_log2, hi.x * LOG2E);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale_log2, hi.y * LOG2E);
  }
}

// One 64 x 128 score tile of a consumer warpgroup, this thread's part: s[4j + e]
// is the score of row g + 8(e / 2) of its warp's 16 and key key0 + 8j + e % 2.
// Folds the tile into the running row max m_run of the raw scores (so
// scale >= 0: a negative scale comes as negated scores), leaving out keys
// >= n when RAGGED, and leaves in s the weights 2^(scale * (s - max))
// (FF_EXP2: one FFMA and one ex2 each; FF_EXP: e^(scale * (s - max)), one
// FFMA, one FMUL and one ex2; FF_BIAS: s comes as ff_add_bias's exponents,
// whose max does not commute with a scale, so scale is 1; 0 for a key left
// out), in alpha the factor that rescales what came before, and in l_run
// this thread's running share of the row sums (summed over the quad at the
// end).
template <int MODE, bool RAGGED>
__device__ __forceinline__ void ff_softmax(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                           float (&alpha)[2], int key0, int n, float scale) {
  const float c = MODE == FF_BIAS ? 1.f : scale;
  const float post = MODE == FF_EXP ? 1.4426950408889634f : 1.f;  // e^x = 2^(x log2 e)
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!RAGGED || key0 + 8 * j + (e & 1) < n) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;  // a row with no valid key yet
    // nothing came before while m_run is -inf (and -inf * 0 is no number)
    alpha[r] = m_run[r] == -INFINITY ? 0.f : hopper::ex2_approx((m_run[r] * c - base[r]) * post);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = hopper::ex2_approx(fmaf(s[i], c, -base[(i >> 1) & 1]) * post);
    if (RAGGED && key0 + 8 * (i >> 2) + (i & 1) >= n) s[i] = 0.f;
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
}

// The block walks the work items w = blockIdx.x, blockIdx.x + gridDim.x, ...
// (query tile w % nq of head (w / nq) % H of batch w / (nq * H)), so that the
// producer loads the next item's Q and first K/V tiles while the consumers
// finish this one. tail_mask 0 leaves the last key tile unmasked (a planted
// fault: TMA's zero-filled keys past T then count with score 0). NEG: the
// scale is negative, so S = -Q K^T (the product's own negation) and scale =
// |sm_scale| (* log2 e but for FF_EXP).
template <int HD, int MODE, bool WITH_LSE, bool NEG>
__global__ void __launch_bounds__(FfShape<MODE>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Rows<bf16> o, float* __restrict__ lse,
                 Rows<const float> bias, int n, int heads, int items, int tail_mask,
                 float scale) {
  using namespace hopper;
  using Sh = FfShape<MODE>;
  using L = FfSmem<HD, MODE>;
  constexpr bool BIAS = MODE == FF_BIAS;
  constexpr int STAGES = Sh::STAGES, WGS = Sh::WGS, QROWS = Sh::QROWS;
  constexpr int ROW = L::ROW;
  constexpr uint64_t SW = HD == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  static_assert(HD == 64 || HD == 32, "head dims 32 and 64 are built");
  static_assert(!WITH_LSE || MODE == FF_EXP2, "the LSE is built for FF_EXP2");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* b_full = empty + STAGES;  // FF_BIAS only
  uint64_t* b_empty = b_full + STAGES;

  const int nq = (n + QROWS - 1) / QROWS, nk = (n + FF_KEYS - 1) / FF_KEYS;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, WGS);  // one arrival per consumer warpgroup
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS);
      if (BIAS) {
        mbar_init(&b_full[s], 128);      // each producer thread's copies
        mbar_init(&b_empty[s], 4 * WGS);  // one arrival per consumer warp
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= Sh::CONSUMERS / 32) {  // the producer warpgroup
    setmaxnreg_dec<Sh::PRODUCER_REGS>();
    // one thread issues every TMA copy; FF_BIAS: all 128 copy the bias
    const int pt = threadIdx.x - Sh::CONSUMERS;
    if (!BIAS && pt != 0) return;
    const bool vec = ((reinterpret_cast<uintptr_t>(bias.ptr) |
                       static_cast<uintptr_t>(bias.bs | bias.hs | bias.rs) * 4) & 15) == 0;
    int c = 0;  // key tiles issued so far: stage c % STAGES, round c / STAGES
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const int i0 = w % nq * QROWS, h = w / nq % heads, b = w / nq / heads;
      for (int it = 0; it < nk; ++it, ++c) {
        const int s = c % STAGES;
        if constexpr (BIAS) {  // the bias first: its stage frees before the K/V stage
          if (c >= STAGES) mbar_wait(&b_empty[s], (c / STAGES - 1) & 1);
          ff_copy_bias<QROWS>(smem_u32(smem + L::B_OFF + s * L::B_TILE), bias.at(b, h), bias.rs,
                              i0, it * FF_KEYS, n, pt, vec);
          cp_async_mbar_arrive(&b_full[s]);
        }
        if (pt != 0) continue;
        if (it == 0) {
          if (k > 0) mbar_wait(q_empty, (k - 1) & 1);  // the last item's Q K^T are done
          mbar_expect_tx(q_full, L::Q_TILE);
          tma_load_4d(smem + L::Q_OFF, &tq, q_full, 0, h, i0, b);
        }
        if (c >= STAGES) mbar_wait(&empty[s], (c / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::KV_TILE);
        tma_load_4d(smem + L::K_OFF + s * L::KV_TILE, &tk, &full[s], 0, h, it * FF_KEYS, b);
        tma_load_4d(smem + L::V_OFF + s * L::KV_TILE, &tv, &full[s], 0, h, it * FF_KEYS, b);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows i0 + wg*64 .. i0 + wg*64 + 63 of each item
  setmaxnreg_inc<Sh::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // releases the warpgroup's stages
  const unsigned char* sQw = smem + L::Q_OFF + wg * 64 * ROW;
  // FF_BIAS: this thread's first element of a bias tile (row g of its warp's 16, column 2t)
  const float* sBt = reinterpret_cast<const float*>(smem + L::B_OFF) +
                     (wg * 64 + wl * 16 + g) * FF_BIAS_PITCH + 2 * t;
  const bool ragged = tail_mask && n % FF_KEYS != 0;

  float o_acc[HD / 2], s_acc[64];
  uint32_t pa[8][4];
  float m_run[2], l_run[2], alpha[2];
  int c = 0;  // K/V tiles consumed so far, as the producer counts them

  auto issue_s = [&](int stage) {  // S = Q K^T of the K tile in `stage`
    const unsigned char* sK = smem + L::K_OFF + stage * L::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0, NEG ? -1 : 1>(s_acc, desc(sQw + kk * 32, 8 * ROW, SW),
                                   desc(sK + kk * 32, 8 * ROW, SW), kk);
  };
  auto issue_pv = [&](int stage) {  // O += P V of the V tile in `stage`, read MN-major
    const unsigned char* sV = smem + L::V_OFF + stage * L::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < FF_KEYS / 16; ++kk)
      wgmma_rs<1>(o_acc, pa[kk], desc(sV + kk * 16 * ROW, 8 * ROW, SW), 1);
  };
  // Pin the registers the products read and write, so that no instruction
  // that defines them moves into a group of products in flight.
  auto fence_all = [&]() {
    fence_regs(s_acc);
    fence_regs(o_acc);
    fence_regs(pa);
  };
  // the softmax of key tile it (consumed as tile cc); FF_BIAS first adds the
  // tile's bias and hands its stage back at once, so that its refill runs
  // under this tile's exps, its P V and the next Q K^T
  auto softmax = [&](int it, int cc) {
    if constexpr (BIAS) {
      const int s = cc % STAGES;
      mbar_wait(&b_full[s], (cc / STAGES) & 1);
      ff_add_bias(s_acc, sBt + s * (L::B_TILE / 4), scale);
      fence_regs(s_acc);  // every bias element read before the stage is handed back
      __syncwarp();
      if (lane == 0) mbar_arrive(&b_empty[s]);
    }
    if (ragged && it == nk - 1)
      ff_softmax<MODE, true>(s_acc, m_run, l_run, alpha, it * FF_KEYS + 2 * t, n, scale);
    else
      ff_softmax<MODE, false>(s_acc, m_run, l_run, alpha, it * FF_KEYS + 2 * t, n, scale);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
  };
  auto wait_tile = [&](int cc) {
    mbar_wait(&full[cc % STAGES], (cc / STAGES) & 1);
    __syncwarp();  // converged again for the .sync.aligned wgmma instructions
  };

  for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
    const int i0 = w % nq * QROWS, h = w / nq % heads, b = w / nq / heads;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;

    mbar_wait(q_full, k & 1);
    wait_tile(c);
    fence_all();
    wgmma_fence();
    issue_s(c % STAGES);
    wgmma_commit();
    fence_all();
    wgmma_wait<0>();
    fence_all();
    if (nk == 1 && leader) mbar_arrive(q_empty);  // the item's last Q K^T is done
    softmax(0, c);
    acc_to_a(s_acc, pa);

    // every key tile but the last: P V of tile it with Q K^T of tile it+1
    for (int it = 0; it + 1 < nk; ++it, ++c) {
      wait_tile(c + 1);
      rescale_o();
      fence_all();
      wgmma_fence();
      issue_pv(c % STAGES);
      issue_s((c + 1) % STAGES);
      wgmma_commit();
      fence_all();
      wgmma_wait<0>();
      fence_all();
      if (leader) {
        mbar_arrive(&empty[c % STAGES]);  // K and V of tile it consumed
        if (it + 2 == nk) mbar_arrive(q_empty);
      }
      softmax(it + 1, c + 1);
      acc_to_a(s_acc, pa);
    }
    rescale_o();
    fence_all();
    wgmma_fence();
    issue_pv(c % STAGES);
    wgmma_commit();
    fence_all();
    wgmma_wait<0>();
    fence_all();
    if (leader) mbar_arrive(&empty[c % STAGES]);
    ++c;

    float l_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) l_row[r] = quad_sum(l_run[r]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + wg * 64 + wl * 16 + g + 8 * r;
      if (row >= n) continue;
      const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
      bf16* orow = o.at(b, h) + (long long)row * o.rs + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o_acc[4 * j + 2 * r] * inv, o_acc[4 * j + 2 * r + 1] * inv);
      // a row with no valid key keeps -inf (never NaN), and the backward
      // gives it zero weight
      if (WITH_LSE && t == 0)
        lse[((long long)b * heads + h) * n + row] =
            l_row[r] > 0.f ? (m_run[r] * scale + log2f(l_row[r])) * 0.6931471805599453f
                           : -INFINITY;
    }
  }
}

// Launch on `stream`: lse null for the plain forward (FF_EXP2 only takes
// one); bias (FF_BIAS only) a [B, H, T, T] f32 view with unit column stride;
// skip_tail_mask 1 only for a planted fault; any sm_scale, zero and negative
// too. Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for a tensor map that could not be encoded or an
// operand the mode does not take.
template <int HD, int MODE>
static int launch_flash_fwd(int batch, int n, int heads, void* stream, Rows<const bf16> q,
                            Rows<const bf16> k, Rows<const bf16> v, Rows<bf16> o, float* lse,
                            Rows<const float> bias, int skip_tail_mask, float sm_scale) {
  using hopper::tensor_map;
  using Sh = FfShape<MODE>;
  if ((lse != nullptr && MODE != FF_EXP2) || ((bias.ptr != nullptr) != (MODE == FF_BIAS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, batch, heads, n, HD, Sh::QROWS) ||
      !tensor_map(encode, &tk, k, batch, heads, n, HD, FF_KEYS) ||
      !tensor_map(encode, &tv, v, batch, heads, n, HD, FF_KEYS))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool neg = sm_scale < 0.f;
  auto kernel = neg ? &flash_fwd_kernel<HD, MODE, false, true>
                    : &flash_fwd_kernel<HD, MODE, false, false>;
  if constexpr (MODE == FF_EXP2) {
    if (lse != nullptr)
      kernel = neg ? &flash_fwd_kernel<HD, MODE, true, true>
                   : &flash_fwd_kernel<HD, MODE, true, false>;
  }
  constexpr int bytes = FfSmem<HD, MODE>::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int sms = hopper::sm_count();
  const int items = (n + Sh::QROWS - 1) / Sh::QROWS * heads * batch;
  const int grid = sms > 0 && sms < items ? sms : items;
  kernel<<<grid, Sh::THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, o, lse, bias, n, heads, items, skip_tail_mask ? 0 : 1,
      fabsf(sm_scale) * (MODE == FF_EXP ? 1.f : 1.4426950408889634f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
