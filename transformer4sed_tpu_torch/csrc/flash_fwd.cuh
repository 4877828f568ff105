// Flash attention forward for Hopper (sm_90a): the device code shared by the
// heads-in-lanes entry points (flash_attention.cu, rows 1 and 7) and the
// head-major ones (flash_attention_hm.cu, rows 3 and 5).
//
//   softmax(scale * Q K^T) V  per (batch, head)
// Every operand is a [B, H, T, d] view with its own batch, head and row
// strides (Rows, mma.cuh): [B, N, H*d] lane slices of a projection and
// head-major views alike. WITH_LSE also writes the natural-log row
// log-sum-exp lse [B, H, T] f32 that the backward (flash_bwd.cuh) recomputes
// the probabilities from: -inf for a row with no valid key, never NaN. HD is
// the head dim; 64 (rows 1, 3, 5, 7) and 32 (rows 3, 5) are built.
//
// What bounds it: the two products are 4*T^2*d operations per (batch, head)
// against 4*T*d*2 bytes of q/k/v/o, about T/2 operations per byte: some 600
// at T = 1190, above the H100's ~295 FLOP/byte ridge, so the tensor cores
// bound it (34.8 GFLOP at B=8, H=12, d=64: 0.0352 ms at 989 TFLOP/s). Next
// comes the exp: one per score, 16 a clock on an SM's MUFU units, against
// about 4096 bf16 operations (2048 multiply-adds) a clock on its tensor cores
// (989 TFLOP/s over 132 SMs at 1.83 GHz). A score costs the two products
// 2 * 2 * d operations, so at d = 64 the exps of a tile take as long as its
// two products, 1/16 clock a score each.
//
// Design. Work items of 192 queries of one (batch, head); one block an SM
// walks them (w = blockIdx.x, + gridDim.x, ...), so that each item's loads
// start while the item before it finishes. A block is three consumer
// warpgroups of 64 query rows each and a producer warpgroup, one thread of
// which issues every copy: the item's Q tile (once the last item's products
// have read it), then 128-key tiles of K and V (TMA, from 4-D tensor maps
// over (d, heads, rows, batch) whose out-of-bounds fill zeroes the ragged
// tail) through a ring of FF_STAGES stages, each guarded by a full and an
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
// both, and the three consumer warpgroups interleave their products and
// exps on their own. Rows past T are never written: in a [B, N, C] output,
// row T of batch b is row 0 of batch b+1. One block an SM of four
// warpgroups: 128 registers a thread at launch; setmaxnreg moves the
// producer warpgroup down to 24 and the consumers up to 160 (S 64, O d/2,
// P 32 and the row state).
#pragma once

#include "hopper.cuh"

namespace t4s {

constexpr int FF_WGS = 3;               // consumer warpgroups, 64 query rows each
constexpr int FF_QROWS = 64 * FF_WGS;   // query rows a work item
constexpr int FF_KEYS = 128;            // keys a stage
constexpr int FF_STAGES = 3;
constexpr int FF_CONSUMERS = 128 * FF_WGS;
constexpr int FF_THREADS = FF_CONSUMERS + 128;  // and the producer warpgroup
// the block's register pool: 128 * 24 + 384 * 160 = 512 * 126 (128 at launch)
constexpr int FF_PRODUCER_REGS = 24;
constexpr int FF_CONSUMER_REGS = 160;

template <int HD>
struct FfSmem {
  static constexpr int ROW = HD * 2;  // bytes of one tile row
  static constexpr int Q_TILE = FF_QROWS * ROW;
  static constexpr int KV_TILE = FF_KEYS * ROW;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_TILE;
  static constexpr int V_OFF = K_OFF + FF_STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + FF_STAGES * KV_TILE;
  // q_full, q_empty, full[FF_STAGES], empty[FF_STAGES]; then slack to align the base
  static constexpr int BYTES = BAR_OFF + (2 + 2 * FF_STAGES) * 8 + 1024;
};

// One 64 x 128 score tile of a consumer warpgroup, this thread's part: s[4j + e]
// is the score of row g + 8(e / 2) of its warp's 16 and key key0 + 8j + e % 2.
// Folds the tile into the running row max m_run of the raw scores (so
// scale_log2 >= 0: a negative scale comes as negated scores), leaving out keys
// >= n when RAGGED, and leaves in s the weights 2^(scale_log2 * (s - max))
// (one FFMA and one ex2 each; 0 for a key left out), in alpha the factor that
// rescales what came before, and in l_run this thread's running share of the
// row sums (summed over the quad at the end).
template <bool RAGGED>
__device__ __forceinline__ void ff_softmax(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                           float (&alpha)[2], int key0, int n, float scale_log2) {
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
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;  // a row with no valid key yet
    // nothing came before while m_run is -inf (and -inf * 0 is no number)
    alpha[r] = m_run[r] == -INFINITY ? 0.f : hopper::ex2_approx(m_run[r] * scale_log2 - base[r]);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = hopper::ex2_approx(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));
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
// scale is negative, so S = -Q K^T (the product's own negation) and
// scale_log2 = |scale| * log2 e.
template <int HD, bool WITH_LSE, bool NEG>
__global__ void __launch_bounds__(FF_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Rows<bf16> o, float* __restrict__ lse,
                 int n, int heads, int items, int tail_mask, float scale_log2) {
  using namespace hopper;
  using L = FfSmem<HD>;
  constexpr int ROW = L::ROW;
  constexpr uint64_t SW = HD == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  static_assert(HD == 64 || HD == 32, "head dims 32 and 64 are built");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + FF_STAGES;

  const int nq = (n + FF_QROWS - 1) / FF_QROWS, nk = (n + FF_KEYS - 1) / FF_KEYS;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, FF_WGS);  // one arrival per consumer warpgroup
    for (int s = 0; s < FF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FF_WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= FF_CONSUMERS / 32) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<FF_PRODUCER_REGS>();
    if (warp == FF_CONSUMERS / 32 && lane == 0) {
      int c = 0;  // K/V tiles issued so far: stage c % FF_STAGES, round c / FF_STAGES
      for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
        const int i0 = w % nq * FF_QROWS, h = w / nq % heads, b = w / nq / heads;
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);  // the last item's Q K^T are done
        mbar_expect_tx(q_full, L::Q_TILE);
        tma_load_4d(smem + L::Q_OFF, &tq, q_full, 0, h, i0, b);
        for (int it = 0; it < nk; ++it, ++c) {
          const int s = c % FF_STAGES;
          if (c >= FF_STAGES) mbar_wait(&empty[s], (c / FF_STAGES - 1) & 1);
          mbar_expect_tx(&full[s], 2 * L::KV_TILE);
          tma_load_4d(smem + L::K_OFF + s * L::KV_TILE, &tk, &full[s], 0, h, it * FF_KEYS, b);
          tma_load_4d(smem + L::V_OFF + s * L::KV_TILE, &tv, &full[s], 0, h, it * FF_KEYS, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows i0 + wg*64 .. i0 + wg*64 + 63 of each item
  setmaxnreg_inc<FF_CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // releases the warpgroup's stages
  const unsigned char* sQw = smem + L::Q_OFF + wg * 64 * ROW;
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
  auto softmax = [&](int it) {
    if (ragged && it == nk - 1)
      ff_softmax<true>(s_acc, m_run, l_run, alpha, it * FF_KEYS + 2 * t, n, scale_log2);
    else
      ff_softmax<false>(s_acc, m_run, l_run, alpha, it * FF_KEYS + 2 * t, n, scale_log2);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
  };
  auto wait_tile = [&](int cc) {
    mbar_wait(&full[cc % FF_STAGES], (cc / FF_STAGES) & 1);
    __syncwarp();  // converged again for the .sync.aligned wgmma instructions
  };

  for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
    const int i0 = w % nq * FF_QROWS, h = w / nq % heads, b = w / nq / heads;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;

    mbar_wait(q_full, k & 1);
    wait_tile(c);
    fence_all();
    wgmma_fence();
    issue_s(c % FF_STAGES);
    wgmma_commit();
    fence_all();
    wgmma_wait<0>();
    fence_all();
    if (nk == 1 && leader) mbar_arrive(q_empty);  // the item's last Q K^T is done
    softmax(0);
    acc_to_a(s_acc, pa);

    // every key tile but the last: P V of tile it with Q K^T of tile it+1
    for (int it = 0; it + 1 < nk; ++it, ++c) {
      wait_tile(c + 1);
      rescale_o();
      fence_all();
      wgmma_fence();
      issue_pv(c % FF_STAGES);
      issue_s((c + 1) % FF_STAGES);
      wgmma_commit();
      fence_all();
      wgmma_wait<0>();
      fence_all();
      if (leader) {
        mbar_arrive(&empty[c % FF_STAGES]);  // K and V of tile it consumed
        if (it + 2 == nk) mbar_arrive(q_empty);
      }
      softmax(it + 1);
      acc_to_a(s_acc, pa);
    }
    rescale_o();
    fence_all();
    wgmma_fence();
    issue_pv(c % FF_STAGES);
    wgmma_commit();
    fence_all();
    wgmma_wait<0>();
    fence_all();
    if (leader) mbar_arrive(&empty[c % FF_STAGES]);
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
            l_row[r] > 0.f ? (m_run[r] * scale_log2 + log2f(l_row[r])) * 0.6931471805599453f
                           : -INFINITY;
    }
  }
}

// The number of SMs of the current device (the persistent grid's size).
static int ff_sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return count;
}

// Launch on `stream`: lse null for the plain forward; skip_tail_mask 1 only
// for a planted fault; any sm_scale, zero and negative too. Returns
// cudaGetLastError() after the launch (0 = launched); cudaErrorInvalidValue
// for a tensor map that could not be encoded.
template <int HD>
static int launch_flash_fwd(int batch, int n, int heads, void* stream, Rows<const bf16> q,
                            Rows<const bf16> k, Rows<const bf16> v, Rows<bf16> o, float* lse,
                            int skip_tail_mask, float sm_scale) {
  using hopper::tensor_map;
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, batch, heads, n, HD, FF_QROWS) ||
      !tensor_map(encode, &tk, k, batch, heads, n, HD, FF_KEYS) ||
      !tensor_map(encode, &tv, v, batch, heads, n, HD, FF_KEYS))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool neg = sm_scale < 0.f;
  auto kernel = lse != nullptr ? (neg ? &flash_fwd_kernel<HD, true, true>
                                      : &flash_fwd_kernel<HD, true, false>)
                               : (neg ? &flash_fwd_kernel<HD, false, true>
                                      : &flash_fwd_kernel<HD, false, false>);
  constexpr int bytes = FfSmem<HD>::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int sms = ff_sm_count();
  const int items = (n + FF_QROWS - 1) / FF_QROWS * heads * batch;
  const int grid = sms > 0 && sms < items ? sms : items;
  kernel<<<grid, FF_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, o, lse, n, heads, items, skip_tail_mask ? 0 : 1,
      fabsf(sm_scale) * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t4s
