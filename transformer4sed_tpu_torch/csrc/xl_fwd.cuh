// Transformer-XL attention forward for Hopper (sm_90a), heads in lanes: the
// device code of xl_attention.cu's two entry points, which replace the Pallas
// TPU kernels transformer4sed_tpu/kernels/xl_attention.py:_xl_nhd_forward
// (line 648, row 2) and :_xl_nhd_forward_lse (line 734, row 12).
//
//   softmax(scale * ((q+u) K^T + relshift((q+v) P^T))) V  per (batch, head)
// q, k, v and o are [B, T, H*64] lane slices (Rows, mma.cuh: batch and row
// strides, head stride 64), u and v the f32 pos_bias_u / pos_bias_v [H, 64],
// added in f32 and rounded to bf16 as the plain version rounds them, P the
// projected position table [H, 2T-1, 64] (offsets T-1 ... -(T-1)) with head
// and row strides, and an optional per-head band: row i attends
// [i - w/2, i + w/2) plus i. WITH_LSE also writes the natural-log row
// log-sum-exp lse [B, H, T] f32 that the backward (xl_bwd.cuh) reads: -inf
// for a row with no valid key, never NaN.
//
// What bounds it: the content and position products and P.V are 6*T^2*d
// operations per (batch, head), 36.9 GFLOP at B=8, T=1000, H=12, d=64
// (0.0373 ms at the H100's 989 TFLOP/s), against ~52 MB of q, k, v, o and P:
// far above the ~295 FLOP/byte ridge, so the tensor cores bound it. The
// naive form would be bound instead by the [B, H, T, 2T-1] position scores
// and their skewed copy in device memory.
//
// Design (flash_fwd.cuh's, changed where the position term needs it).
// * Work items of 128 query rows of one (batch, head), walked by persistent
//   blocks, one an SM. A producer warpgroup, one thread of which issues
//   every TMA copy: the item's q tile (once both consumers have read the
//   last one), then per 128-key step the K and V tiles (4-D maps over
//   (d, heads, rows, batch) whose out-of-bounds fill zeroes the ragged tail)
//   through a ring of three stages, each guarded by a full and an empty
//   mbarrier, and the position strip as 128-row tiles of P.
// * The rel-shift is index arithmetic. Consumer w (query rows
//   i0 + 64w .. +63) at the key tile j0 needs P rows T-1-i+j, the 191 strip
//   rows from T - (i0 + 64w) - 64 + j0: pieces 1-w, 2-w and 3-w (64 rows
//   each) of the strip tiles that start at T - i0 - 128 + j0 and 128 rows
//   later. So both consumers read one set of tiles, and each key step needs
//   one new tile (two for the first): tile t of an item, P rows from
//   T - i0 - 128 + 128 t, is loaded with key step t - 1 (tiles 0 and 1 with
//   step 0) into a ring of four and freed once step t's position products
//   are done (the last two after the last step). A start below row 0 or an
//   end past row 2T-2 reads as TMA's zero fill; such rows meet only query
//   rows past T. No clamp and no guard in the consumers.
// * Each consumer warpgroup builds qu = bf16(q + u) and qv = bf16(q + v)
//   once an item, in registers, from the TMA q tile and the f32 biases, as
//   the A operands of its products (the wgmma_rs layout). Per key step:
//   G = qv strip^T (three m64n64 wgmma, f32 accumulators) is issued with the
//   last step's O += P V (A the softmax weights rounded to bf16, V read
//   MN-major), under one wait. The skew stays in registers (xf_skew): score
//   (row r, key jl) takes G at strip column jl + 63 - r, which lies in the
//   same row, so in the same quad of lanes: a select of the block by the
//   shift's multiple of 8 (the warp's, made static by a switch), one quad
//   shuffle for the rest, and the result lands in the score accumulators;
//   then S += qu K^T (wgmma m64n128, K K-major) accumulates the content
//   scores onto them. Scores stay f32: content plus position in the
//   product's f32 accumulator. (The first design sent G through a per-warp
//   f32 buffer in shared memory and read it back skewed: slower, and it left
//   room for two stages only.)
// * The two consumer warpgroups take turns at the tensor cores (named
//   barriers), so that one's skew and softmax run under the other's
//   products.
// * The softmax is the flash forward's, on the accumulators: the row max and
//   sum over the quad, scale * log2 e folded into one FFMA a score,
//   ex2.approx; keys past T are masked in the last tile only, the band per
//   element; a row with no valid key in the tiles so far keeps a finite
//   base. A negative scale comes as negated qu and qv (rounding commutes
//   with the sign) and a zero one as the least normal float, so every score
//   meets a positive factor. The LSE is (m + log2 l) * ln 2.
// * Shared memory, 177 KB of the 227: the q tile 16 KB, three stages of K
//   and V 96, four strip tiles 64. One block an SM of three warpgroups: 168
//   registers a thread at launch; setmaxnreg moves the producer to 40 and the
//   consumers to 232 (G 96, P 32, O 32, qu and qv 32 while G is in flight).
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace t4s {

constexpr int XF_QROWS = 128;                   // query rows an item: two consumer warpgroups
constexpr int XF_KEYS = 128;                    // keys a step; rows a strip tile
constexpr int XF_STAGES = 3;                    // K/V stages in flight
constexpr int XF_TILES = XF_STAGES + 1;         // strip tiles in the ring
constexpr int XF_CONSUMERS = 256;               // two warpgroups
constexpr int XF_THREADS = XF_CONSUMERS + 128;  // and the producer warpgroup
constexpr int XF_PRODUCER_REGS = 40;            // 128 * 40 + 256 * 232 = 384 * 168
constexpr int XF_CONSUMER_REGS = 232;
constexpr float XF_LOG2E = 1.4426950408889634f;

// Planted faults, for the kernel check only (0 on every real path): the
// strip tiles' start clamped at P row 0 instead of zero-filled, the newest
// strip tile of a step read from the step before it, the skew one strip
// row off, pos_bias_u rounded to bf16 before the add.
enum XfFault {
  XF_FAULT_NONE = 0,
  XF_FAULT_CLAMP_STRIP,
  XF_FAULT_STALE_TILE,
  XF_FAULT_SKEW,
  XF_FAULT_ROUND_U
};

struct XfSmem {
  static constexpr int ROW = 128;  // bytes of one tile row (64 bf16)
  static constexpr int TILE = 128 * ROW;  // the q tile, a K or V tile, a strip tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + TILE;
  static constexpr int V_OFF = K_OFF + XF_STAGES * TILE;
  static constexpr int P_OFF = V_OFF + XF_STAGES * TILE;
  static constexpr int BAR_OFF = P_OFF + XF_TILES * TILE;
  // q_full, q_empty, full[STAGES], empty[STAGES], p_empty[TILES]; then slack
  // to align the base to 1024
  static constexpr int BYTES = BAR_OFF + (2 + 2 * XF_STAGES + XF_TILES) * 8 + 1024;
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// This thread's part of one 64 x 128 score tile of a consumer warpgroup:
// s[4j + e] is the raw score (content + position) of row row0 + 8(e / 2) and
// key key0 + 8j + e % 2. Leaves out keys >= n (RAGGED) and keys outside the
// band (half >= 0), folds the tile into the running raw row max m_run,
// and leaves in s the weights 2^(c * (s - max)), in alpha the factor that
// rescales what came before and in l_run this thread's running share of the
// row sums (summed over the quad at the end). c > 0.
template <bool RAGGED>
__device__ __forceinline__ void xf_softmax(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                           float (&alpha)[2], int key0, int row0, int n,
                                           int half, float c) {
  if (half >= 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = key0 + 8 * (i >> 2) + (i & 1), row = row0 + 8 * ((i >> 1) & 1);
      const bool ok = (!RAGGED || key < n) &&
                      ((key >= row - half && key < row + half) || key == row);
      if (!ok) s[i] = -INFINITY;
    }
  } else if (RAGGED) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (key0 + 8 * (i >> 2) + (i & 1) >= n) s[i] = -INFINITY;
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;  // a row with no valid key yet
    alpha[r] = m_run[r] == -INFINITY ? 0.f : hopper::ex2_approx(m_run[r] * c - base[r]);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = hopper::ex2_approx(fmaf(s[i], c, -base[(i >> 1) & 1]));  // 2^-inf = 0
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
}

// The skew, for one warp of a consumer warpgroup (SH0 = 7 - 2 wl, wl the
// warp in the group). g_acc holds G = qv strip^T, 64 rows by 192 strip
// columns: ga[pm][4i + 2h + e] is row g + 8h of the warp's 16, column
// 64 pm + 8i + 2t + e. Score (row r = g + 8h, key jl = 8j + 2t + par) takes
// G[r][jl + 63 - 16 wl - r] = G[r][8 (j + SH0 - h) + 2t + par + sl], sl =
// 7 - g (8 - g for the planted skew fault): column (2t + par + sl) % 8 of
// block j + SH0 - h, or of the next block where that sum passes 8, held by
// lane ((2t + par + sl) % 8) / 2 of the same quad (the same row). Each
// source lane picks the element and the block its reader needs (k = par +
// sl is the same across the quad, so the source knows the reader: lane
// t + k / 2, which needs the next block exactly when t < k / 2), and one
// shuffle a score moves it. G's blocks die as j grows, so its registers
// free up while the scores fill theirs.
template <int SH0>
__device__ __forceinline__ void xf_skew(const float (&ga)[3][32], float (&s)[64], int lane,
                                        int sl) {
  const int t = lane & 3, quad = lane & ~3;
  int src[2];
  bool odd[2], next[2];
#pragma unroll
  for (int par = 0; par < 2; ++par) {
    const int k = par + sl, m = k >> 1;
    odd[par] = (k & 1) != 0;
    next[par] = t < m;
    src[par] = quad | ((t + m) & 3);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int b0 = j + SH0 - h, b1 = b0 + 1;
        const int i0 = 4 * (b0 & 7) + 2 * h, i1 = 4 * (b1 & 7) + 2 * h;
        const float a0 = odd[par] ? ga[b0 >> 3][i0 + 1] : ga[b0 >> 3][i0];
        const float a1 = odd[par] ? ga[b1 >> 3][i1 + 1] : ga[b1 >> 3][i1];
        s[4 * j + 2 * h + par] = __shfl_sync(0xffffffffu, next[par] ? a1 : a0, src[par]);
      }
}

// The block walks the work items w = blockIdx.x, blockIdx.x + gridDim.x, ...
// (query tile w % nq of head (w / nq) % H of batch w / (nq * H)). sign is
// the scale's sign (-1 negates qu and qv), c = max(|scale| * log2 e, least
// normal float).
template <bool WITH_LSE>
__global__ void __launch_bounds__(XF_THREADS, 1)
xl_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tp,
              const float* __restrict__ bias_u, const float* __restrict__ bias_v,
              const int* __restrict__ band, Rows<bf16> o, float* __restrict__ lse, int n,
              int heads, int items, int fault, float sign, float c) {
  using namespace hopper;
  using L = XfSmem;
  constexpr int ROW = L::ROW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + XF_STAGES;
  uint64_t* p_empty = empty + XF_STAGES;

  const int nq = (n + XF_QROWS - 1) / XF_QROWS, nk = (n + XF_KEYS - 1) / XF_KEYS;
  const int tiles = nk + 1;  // strip tiles an item loads
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, XF_CONSUMERS / 32);  // one arrival per consumer warp
    for (int s = 0; s < XF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < XF_TILES; ++s) mbar_init(&p_empty[s], 2);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= XF_CONSUMERS / 32) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<XF_PRODUCER_REGS>();
    if (threadIdx.x != XF_CONSUMERS) return;
    int c_kv = 0;  // key steps issued so far: stage c_kv % STAGES, round c_kv / STAGES
    for (int w = blockIdx.x, k = 0, t0 = 0; w < items; w += gridDim.x, ++k, t0 += tiles) {
      const int i0 = w % nq * XF_QROWS, h = w / nq % heads, b = w / nq / heads;
      const int base = n - i0 - XF_QROWS;  // P row of the item's strip tile 0
      for (int it = 0; it < nk; ++it, ++c_kv) {
        const int s = c_kv % XF_STAGES;
        if (it == 0) {
          if (k > 0) mbar_wait(q_empty, (k - 1) & 1);  // both consumers hold the last q
          mbar_expect_tx(q_full, L::TILE);
          tma_load_4d(smem + L::Q_OFF, &tq, q_full, 0, h, i0, b);
        }
        if (c_kv >= XF_STAGES) mbar_wait(&empty[s], (c_kv / XF_STAGES - 1) & 1);
        const int first = it == 0 ? 0 : it + 1;  // strip tiles 0, 1 with step 0, then it + 1
        for (int t = first; t <= it + 1; ++t) {
          const int id = t0 + t;  // ring slot id % TILES, round id / TILES
          if (id >= XF_TILES) mbar_wait(&p_empty[id % XF_TILES], (id / XF_TILES - 1) & 1);
        }
        mbar_expect_tx(&full[s], (2 + it + 2 - first) * L::TILE);
        tma_load_4d(smem + L::K_OFF + s * L::TILE, &tk, &full[s], 0, h, it * XF_KEYS, b);
        tma_load_4d(smem + L::V_OFF + s * L::TILE, &tv, &full[s], 0, h, it * XF_KEYS, b);
        for (int t = first; t <= it + 1; ++t) {
          int row = base + t * XF_KEYS;
          if (fault == XF_FAULT_CLAMP_STRIP) row = max(row, 0);
          tma_load_4d(smem + L::P_OFF + (t0 + t) % XF_TILES * L::TILE, &tp, &full[s], 0, h, row,
                      0);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows i0 + wg*64 .. i0 + wg*64 + 63 of each item
  setmaxnreg_inc<XF_CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // releases the warpgroup's stages and tiles
  const int qrow = wg * 64 + wl * 16 + g;        // this thread's rows of the item: qrow, qrow + 8
  const int sl = 7 - g + (fault == XF_FAULT_SKEW ? 1 : 0);  // the skew's column within a block
  const bool ragged = n % XF_KEYS != 0;
  // The two warpgroups take turns at the tensor cores: each waits on its own
  // named barrier (1 + wg) before it issues a group of products and lets the
  // other one go (2 - wg) once it has; warpgroup 0 goes first.
  auto my_turn = [&]() { bar_sync(1 + wg, XF_CONSUMERS); };
  auto your_turn = [&]() { bar_arrive(2 - wg, XF_CONSUMERS); };
  if (wg == 1) your_turn();

  float o_acc[32], s_acc[64], g_acc[3][32];
  uint32_t qu[4][4], qv[4][4], pa[8][4];
  float m_run[2], l_run[2], alpha[2];
  int c_kv = 0;  // key steps consumed so far, as the producer counts them

  // Pin the registers a group of products reads and writes, so that no
  // instruction that defines them moves into the group in flight; each
  // group pins only its own, or the other group's would stay live too.
  auto fence_g = [&]() {  // the last step's P V and the position products
    fence_regs(o_acc);
    fence_regs(pa);
    fence_regs(qv);
    fence_regs(g_acc[0]);
    fence_regs(g_acc[1]);
    fence_regs(g_acc[2]);
  };
  auto fence_s = [&]() {  // the content products
    fence_regs(qu);
    fence_regs(s_acc);
  };
  auto fence_pv = [&]() {  // the item's last P V
    fence_regs(o_acc);
    fence_regs(pa);
  };
  auto issue_pv = [&](int stage) {  // O += P V of the V tile in `stage`, read MN-major
    const unsigned char* sV = smem + L::V_OFF + stage * L::TILE;
#pragma unroll
    for (int kk = 0; kk < XF_KEYS / 16; ++kk)
      wgmma_rs<1>(o_acc, pa[kk], desc(sV + kk * 16 * ROW, 8 * ROW, SWIZZLE_128B), 1);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
  };

  for (int w = blockIdx.x, k = 0, t0 = 0; w < items; w += gridDim.x, ++k, t0 += tiles) {
    const int i0 = w % nq * XF_QROWS, h = w / nq % heads, b = w / nq / heads;
    const int half = band != nullptr ? band[h] / 2 : -1;  // -1: no band

    // qu = bf16(q + u), qv = bf16(q + v) in the A layout: a[kk][f] holds row
    // qrow + 8 (f & 1), columns 16 kk + 2t + 8 (f / 2) and the next
    mbar_wait(q_full, k & 1);
    {
      const float* bu = bias_u + h * 64;
      const float* bv = bias_v + h * 64;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int row = qrow + 8 * (f & 1), col = 16 * kk + 2 * t + 8 * (f >> 1);
          const uint32_t x2 = *reinterpret_cast<const uint32_t*>(
              smem + L::Q_OFF + row * ROW + (((col >> 3) ^ (row & 7)) << 4) + 4 * t);
          const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x2));
          float2 u = *reinterpret_cast<const float2*>(bu + col);
          const float2 v2 = *reinterpret_cast<const float2*>(bv + col);
          if (fault == XF_FAULT_ROUND_U)
            u = make_float2(__bfloat162float(__float2bfloat16_rn(u.x)),
                            __bfloat162float(__float2bfloat16_rn(u.y)));
          qu[kk][f] = pack_bf16(sign * (xf.x + u.x), sign * (xf.y + u.y));
          qv[kk][f] = pack_bf16(sign * (xf.x + v2.x), sign * (xf.y + v2.y));
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);  // this warp's q rows read

#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;

    // one key step; FIRST, the item's step 0, has no P V of a step before it
    // (a branch inside a group of products would serialize them: C7515)
    auto step = [&](int it, auto first) {
      constexpr bool FIRST = decltype(first)::value;
      mbar_wait(&full[c_kv % XF_STAGES], (c_kv / XF_STAGES) & 1);
      __syncwarp();  // converged again for the .sync.aligned wgmma instructions

      // G = qv strip^T over this consumer's pieces 1-wg, 2-wg, 3-wg of strip
      // tiles it and it+1, issued with the last step's P V
      if constexpr (!FIRST) rescale_o();
      fence_g();
      my_turn();
      wgmma_fence();
      if constexpr (!FIRST) issue_pv((c_kv - 1) % XF_STAGES);
#pragma unroll
      for (int pm = 0; pm < 3; ++pm) {
        const int q = 1 - wg + pm;  // piece of the two strip tiles
        int tile = it + (q >> 1);
        if (!FIRST && fault == XF_FAULT_STALE_TILE && tile == it + 1) tile = it;
        const unsigned char* piece =
            smem + L::P_OFF + (t0 + tile) % XF_TILES * L::TILE + (q & 1) * 64 * ROW;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<0>(g_acc[pm], qv[kk], desc(piece + kk * 32, 8 * ROW, SWIZZLE_128B), kk);
      }
      wgmma_commit();
      your_turn();
      fence_g();
      wgmma_wait<0>();
      fence_g();
      if (leader) {
        if (!FIRST) mbar_arrive(&empty[(c_kv - 1) % XF_STAGES]);  // K, V of the last step done
        mbar_arrive(&p_empty[(t0 + it) % XF_TILES]);  // strip tile it: no later step reads it
        if (it == nk - 1) mbar_arrive(&p_empty[(t0 + nk) % XF_TILES]);
      }

      // the skew, in registers: each score starts as its position term
      switch (wl) {
        case 0: xf_skew<7>(g_acc, s_acc, lane, sl); break;
        case 1: xf_skew<5>(g_acc, s_acc, lane, sl); break;
        case 2: xf_skew<3>(g_acc, s_acc, lane, sl); break;
        default: xf_skew<1>(g_acc, s_acc, lane, sl); break;
      }

      // S += qu K^T onto the position scores
      const unsigned char* sK = smem + L::K_OFF + c_kv % XF_STAGES * L::TILE;
      fence_s();
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(s_acc, qu[kk], desc(sK + kk * 32, 8 * ROW, SWIZZLE_128B), 1);
      wgmma_commit();
      your_turn();
      fence_s();
      wgmma_wait<0>();
      fence_s();

      const int key0 = it * XF_KEYS + 2 * t, row0 = i0 + qrow;
      if (ragged && it == nk - 1)
        xf_softmax<true>(s_acc, m_run, l_run, alpha, key0, row0, n, half, c);
      else
        xf_softmax<false>(s_acc, m_run, l_run, alpha, key0, row0, n, half, c);
      acc_to_a(s_acc, pa);
    };
    step(0, std::true_type{});
    ++c_kv;
    for (int it = 1; it < nk; ++it, ++c_kv) step(it, std::false_type{});
    rescale_o();
    fence_pv();
    my_turn();
    wgmma_fence();
    issue_pv((c_kv - 1) % XF_STAGES);
    wgmma_commit();
    your_turn();
    fence_pv();
    wgmma_wait<0>();
    fence_pv();
    if (leader) mbar_arrive(&empty[(c_kv - 1) % XF_STAGES]);

    float l_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) l_row[r] = quad_sum(l_run[r]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + qrow + 8 * r;
      if (row >= n) continue;
      const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
      bf16* orow = o.at(b, h) + (long long)row * o.rs + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o_acc[4 * j + 2 * r] * inv, o_acc[4 * j + 2 * r + 1] * inv);
      // a row with no valid key keeps -inf (never NaN), and the backward
      // gives it zero weight
      if (WITH_LSE && t == 0)
        lse[((long long)b * heads + h) * n + row] =
            l_row[r] > 0.f ? (m_run[r] * c + log2f(l_row[r])) * 0.6931471805599453f : -INFINITY;
    }
  }
}

// Launch on `stream`: lse null for row 2, an f32 [B, H, T] for row 12; p a
// [H, 2T-1, 64] view; any sm_scale, zero and negative too; fault 0 but for
// a planted fault (XfFault). Returns cudaGetLastError() after the launch (0 =
// launched); cudaErrorInvalidValue for a tensor map that could not be encoded.
static int launch_xl_fwd_nhd(int batch, int n, int heads, void* stream, Rows<const bf16> q,
                             Rows<const bf16> k, Rows<const bf16> v, const float* bias_u,
                             const float* bias_v, Rows<const bf16> p, const int* band,
                             Rows<bf16> o, float* lse, int fault, float sm_scale) {
  using hopper::tensor_map;
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tp;
  if (!tensor_map(encode, &tq, q, batch, heads, n, 64, XF_QROWS) ||
      !tensor_map(encode, &tk, k, batch, heads, n, 64, XF_KEYS) ||
      !tensor_map(encode, &tv, v, batch, heads, n, 64, XF_KEYS) ||
      !tensor_map(encode, &tp, p, 1, heads, 2 * n - 1, 64, XF_KEYS))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lse != nullptr ? &xl_fwd_kernel<true> : &xl_fwd_kernel<false>;
  constexpr int bytes = XfSmem::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int sms = hopper::sm_count();
  const int items = (n + XF_QROWS - 1) / XF_QROWS * heads * batch;
  const int grid = sms > 0 && sms < items ? sms : items;
  const float c = fmaxf(fabsf(sm_scale) * XF_LOG2E, 1.17549435e-38f);
  kernel<<<grid, XF_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tp, bias_u, bias_v, band, o, lse, n, heads, items, fault,
      sm_scale < 0.f ? -1.f : 1.f, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
