// Swin window attention for Hopper (sm_90a): the device code shared by the
// forward (window_attention.cu, row 14) and the backward
// (window_attention_bwd.cu, row 15).
//
// Per window w and head h, with Q, K, V, O and the cotangent G [64, 24]:
//   S = scale * Q K^T + bias[h] + shift[w mod nW]     (f32; shift optional)
//   forward:  O = softmax(S) V
//   backward: P = softmax(S), delta = rowsum(G * O), dV = P^T G,
//             dS = P * (G V^T - delta), dQ = scale dS K, dK = scale dS^T Q,
//             dbias[h] = the sum of dS over all windows, dshift[r] = the sum
//             over heads and over the windows w with w mod nW = r.
// Every operand is a [B*nW, 64, H, 24] lane view with its own window and row
// strides: the q, k, v slices of the qkv projection [B*nW, 64, 3, H, 24], or
// o, g and the outputs, contiguous.
//
// Design.
// * Items of (window position r, group of G neighbouring heads). One block
//   takes an item and a slice of the images (a chunk) and walks its windows
//   w = r + nW * i, i = chunk, chunk + n_chunks, ... (without a shift mask
//   every window is alike: r = 0, nW = 1). With an even head count G = 2 and
//   each of the two consumer warpgroups owns one head of every window; with
//   an odd one G = 1 and the two take the head's windows in turns. The plan
//   (G, chunks: wa_plan) fills the card's SMs with items times chunks.
// * The bias stays on chip. Each consumer thread loads its 32 scores'
//   bias[h] + shift[r], times log2 e, into registers once an item. The two
//   are added before the scores: (bias + shift) + scale QK^T, where the plain
//   version adds scale QK^T + bias, then the shift (an f32 rounding apart).
// * Every operand by TMA, as whole rows. One thread of the producer
//   warpgroup issues, RAW steps ahead, one TMA box an operand: the G heads'
//   24 G lanes of the window's 64 rows (96-byte rows at G = 2; G = 1, one box
//   of 48-byte rows a window), [64][24 G] bf16, from 3-D maps (lanes, rows,
//   windows). (A first design had TMA write wgmma's layout itself, boxes of
//   8 lanes: one 16-byte piece a row and lane group, its stores likewise,
//   and TMA moved those pieces far below the memory's rate.) The 128
//   producer threads copy each 16-byte piece to its place in a canonical
//   slot, [4 lane groups][64 rows][8 lanes] bf16 a (window, head): the core
//   matrices of wgmma's layout without swizzle, in a ring of CANON stages,
//   each guarded by a full and an empty mbarrier. The fourth lane group of
//   every slot is zeroed once and never written, so head dim 24 is padded to
//   wgmma's K = 32 with zeros, never with the next head's lanes.
// * Products on wgmma straight from the slots, read with the lanes as K
//   (Q K^T, G V^T: K = 32) or with the rows as K (P V, dS K, P^T G, dS^T Q:
//   N = 24); the softmax in the accumulator registers (ex2.approx; scores are
//   finite: the shift mask is -100, not -inf).
// * Outputs by TMA stores of 48-byte rows: a warpgroup stages its head's
//   [64][24] rows in shared memory (two buffers, in turns) and one thread
//   stores them as one box.
// * Backward: S and dP = G V^T, then P (normalised) and dS in registers;
//   dQ = dS K with dS from registers; P and dS, bf16, to shared memory once
//   each by stmatrix (128-byte swizzle) for dV = P^T G and dK = dS^T Q, read
//   as MN-major A operands; delta from the o and g slots. Each warpgroup
//   carries its head's dS sum over its windows in registers and adds it to
//   dbias[h] and dshift[r] once, at the end, by TMA reductions of two f32
//   boxes of 64 x 32: no atomics. The order of those sums varies from run
//   to run.
// 384 threads: two consumer warpgroups and the producer warpgroup, which
// setmaxnreg moves to 56 registers and the consumers to 224.
#pragma once

#include "hopper.cuh"

namespace t4s {

constexpr int WA_N = 64;                        // tokens of a window
constexpr int WA_D = 24;                        // head dim: 3 lane groups of 8
constexpr int WA_SLOT = 4 * WA_N * 16;          // [4 lane groups][64 rows][8 lanes] bf16
constexpr int WA_OP = 2 * WA_SLOT;              // an operand's two slots in a stage
constexpr int WA_ROWS = WA_N * WA_D * 2;        // a (window, head)'s [64][24] bf16 rows
constexpr int WA_RAW = 2 * WA_ROWS;             // an operand's rows in a raw stage
constexpr int WA_CONSUMERS = 256;               // two warpgroups
constexpr int WA_THREADS = WA_CONSUMERS + 128;  // and the producer warpgroup
constexpr int WA_PRODUCER_REGS = 56;            // 128 * 56 + 256 * 224 <= 384 * 168
constexpr int WA_CONSUMER_REGS = 224;
constexpr float WA_LOG2E = 1.4426950408889634f;

// Planted faults, for the kernel check only (0 on every real path): K read
// from the other consumer's slot (the group's other head, or with G = 1 the
// other window), and the last chunk's dbias and dshift reductions skipped.
enum WaFault { WA_FAULT_NONE = 0, WA_FAULT_SLOT, WA_FAULT_SKIP_REDUCE };

// The tensor maps of a launch: the operands read, the outputs written and,
// backward, the f32 sums (dbias, dshift).
template <int NIN, int NOUT>
struct WaMaps {
  CUtensorMap in[NIN];
  CUtensorMap out[NOUT];
  CUtensorMap sums[2];
};

// The launch's plan: G, H / G, window positions with items of their own
// (nW with a shift mask, else 1), windows a position, chunks an item.
struct WaPlan {
  int group, n_groups, n_r, n_per, n_chunks;
};

// One block's walk: its item and chunk, its windows k = 0 .. count - 1 and
// the steps that take them (one window a step for G = 2, two for G = 1).
struct WaWalk {
  int group, h0, r, chunk, n_chunks, n_r, count, steps;
  __device__ explicit WaWalk(const WaPlan& p) {
    int b = blockIdx.x;
    group = p.group;
    n_r = p.n_r;
    n_chunks = p.n_chunks;
    h0 = (b % p.n_groups) * p.group;
    b /= p.n_groups;
    r = b % p.n_r;
    chunk = b / p.n_r;
    count = (p.n_per - chunk + p.n_chunks - 1) / p.n_chunks;
    steps = group == 2 ? count : (count + 1) / 2;
  }
  // the window (k) that slot `sl` of step `st` holds, or -1 for none
  __device__ int index(int st, int sl) const {
    const int k = group == 2 ? st : 2 * st + sl;
    return k < count ? k : -1;
  }
  __device__ int window(int k) const { return r + n_r * (chunk + n_chunks * k); }
  __device__ int head(int sl) const { return h0 + (group == 2 ? sl : 0); }
};

// The producer warpgroup (tid 0 .. 127). Thread 0 issues the loads of
// step st into raw stage st % RAW (NIN operands of WA_RAW bytes: one box of
// [64][24 G] for G = 2, a box of [64][24] a window for G = 1). All threads
// copy step st's rows into canonical stage st % CANON (NIN operands of
// WA_OP bytes), each thread one row of the three lane groups of one slot,
// and thread 0 arrives on the stage's full barrier.
template <int NIN, int RAW, int CANON>
__device__ __forceinline__ void wa_produce(unsigned char* raw, unsigned char* canon,
                                           const CUtensorMap* maps, uint64_t* raw_full,
                                           uint64_t* full, uint64_t* empty, const WaWalk& wk,
                                           int tid) {
  using namespace hopper;
  auto issue = [&](int st) {
    unsigned char* dst = raw + (st % RAW) * NIN * WA_RAW;
    uint64_t* bar = &raw_full[st % RAW];
    const int k0 = wk.index(st, 0), k1 = wk.index(st, 1);
    if (wk.group == 2) {
      mbar_expect_tx(bar, NIN * WA_RAW);
      for (int i = 0; i < NIN; ++i)
        tma_load_3d(dst + i * WA_RAW, &maps[i], bar, wk.h0 * WA_D, 0, wk.window(k0));
    } else {
      mbar_expect_tx(bar, NIN * WA_ROWS * (k1 >= 0 ? 2 : 1));
      for (int sl = 0; sl < 2; ++sl) {
        const int k = sl == 0 ? k0 : k1;
        if (k < 0) continue;
        for (int i = 0; i < NIN; ++i)
          tma_load_3d(dst + i * WA_RAW + sl * WA_ROWS, &maps[i], bar, wk.h0 * WA_D, 0,
                      wk.window(k));
      }
    }
  };
  if (tid == 0)
    for (int st = 0; st < RAW && st < wk.steps; ++st) issue(st);
  const int row = tid & (WA_N - 1), sl = tid >> 6;  // this thread's row and slot
  // where the row's 48 bytes of slot sl start in a raw operand
  const int src0 = wk.group == 2 ? row * 2 * 48 + sl * 48 : sl * WA_ROWS + row * 48;
  for (int st = 0; st < wk.steps; ++st) {
    const int rs = st % RAW, cs = st % CANON;
    mbar_wait(&raw_full[rs], (st / RAW) & 1);
    if (st >= CANON) mbar_wait(&empty[cs], (st / CANON - 1) & 1);
    if (wk.index(st, sl) >= 0) {
      const unsigned char* src = raw + rs * NIN * WA_RAW + src0;
      unsigned char* dst = canon + cs * NIN * WA_OP + sl * WA_SLOT + row * 16;
#pragma unroll
      for (int i = 0; i < NIN; ++i) {
        uint4 x[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          x[j] = *reinterpret_cast<const uint4*>(src + i * WA_RAW + j * 16);
#pragma unroll
        for (int j = 0; j < 3; ++j) *reinterpret_cast<uint4*>(dst + i * WA_OP + j * 1024) = x[j];
      }
    }
    fence_proxy_async();
    bar_sync(1, 128);  // every thread has read raw stage rs and written canonical stage cs
    if (tid == 0) {
      mbar_arrive(&full[cs]);
      if (st + RAW < wk.steps) issue(st + RAW);
    }
  }
}

// Zero the fourth lane group of every canonical slot (CANON stages of NIN
// operands), once, by the whole block.
template <int NIN, int CANON>
__device__ __forceinline__ void wa_zero_pad(unsigned char* canon) {
  constexpr int PIECES = CANON * NIN * 2 * WA_N;  // 16-byte pieces: rows of the slots
  for (int i = threadIdx.x; i < PIECES; i += WA_THREADS)
    *reinterpret_cast<uint4*>(canon + (i / WA_N) * WA_SLOT + 3 * 1024 + (i % WA_N) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
}

// Descriptors of a slot's k16 step kk, read with the lanes as K (M or N the
// 64 rows; K = 32 in two steps) or with the rows as K (N the 24 lanes).
__device__ __forceinline__ uint64_t lanes_k(const unsigned char* slot, int kk) {
  return hopper::desc_ns(slot + kk * 2 * 1024, 1024, 128);
}

__device__ __forceinline__ uint64_t rows_k(const unsigned char* slot, int kk) {
  return hopper::desc_ns(slot + kk * 256, 128, 1024);
}

// This thread's 32 scores' (bias[h] + shift[r]) * log2 e in the accumulator
// layout of an m64n64 product (w the warp in the warpgroup); shift_r may be
// null (no shifted windows).
__device__ __forceinline__ void wa_bias(float (&b)[32], const float* __restrict__ bias_h,
                                        const float* __restrict__ shift_r, int w, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int off = (16 * w + g + 8 * rr) * WA_N + 8 * j + 2 * t;
      float2 x = *reinterpret_cast<const float2*>(bias_h + off);
      if (shift_r != nullptr) {
        const float2 m = *reinterpret_cast<const float2*>(shift_r + off);
        x.x += m.x;
        x.y += m.y;
      }
      b[4 * j + 2 * rr] = x.x * WA_LOG2E;
      b[4 * j + 2 * rr + 1] = x.y * WA_LOG2E;
    }
}

// In place, s -> 2^(scale log2e s + b - rowmax): exp(S - max), unnormalised;
// l = the sums of this thread's two rows (16w + g and + 8), over the quad.
__device__ __forceinline__ void wa_softmax(float (&s)[32], const float (&b)[32], float scale_log2,
                                           float (&l)[2]) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fmaf(s[i], scale_log2, b[i]);
    m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = hopper::ex2_approx(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// delta = rowsum(O * G) in f32 for this thread's rows 16w + g and + 8, from
// the o and g slots: lane t < 3 of the quad takes lane group t.
__device__ __forceinline__ void wa_delta(float (&dl)[2], const unsigned char* so,
                                         const unsigned char* sg, int w, int g, int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float acc = 0.f;
    if (t < 3) {
      const int at = t * 1024 + (16 * w + g + 8 * rr) * 16;
      const uint4 ov = *reinterpret_cast<const uint4*>(so + at);
      const uint4 gv = *reinterpret_cast<const uint4*>(sg + at);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += __bfloat162float(oe[i]) * __bfloat162float(ge[i]);
    }
    dl[rr] = quad_sum(acc);
  }
}

// An m64n24 accumulator times mul[row half], as bf16 rows [64][24], for a
// TMA store (the 32 lanes of a warp write 32 distinct banks).
__device__ __forceinline__ void wa_stage(unsigned char* rows, const float (&acc)[12],
                                         const float (&mul)[2], int w, int g, int t) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<uint32_t*>(rows + (16 * w + g + 8 * rr) * 48 + 16 * j + 4 * t) =
          pack_bf16(acc[4 * j + 2 * rr] * mul[rr], acc[4 * j + 2 * rr + 1] * mul[rr]);
}

// -- host side ----------------------------------------------------------------------

// The 3-D map (lanes, 64 rows, windows) over one [bnw, 64, heads, 24] lane
// view with window and row strides ws, rs (elements), boxes of `box_heads`
// heads' lanes (24 each) by one window's 64 rows.
static bool row_map(hopper::EncodeTiledFn encode, CUtensorMap* map, const void* base, int bnw,
                    int heads, long long ws, long long rs, int box_heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * WA_D, WA_N, (cuuint64_t)bnw};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2, (cuuint64_t)ws * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_heads * WA_D, WA_N, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan of a launch over bnw windows of n_r positions (nW with a shift
// mask, else 1): G = 2 for an even head count, else 1, and as many chunks as
// fill the card's SMs with one block each, at least one window a chunk for
// G = 2 and two for G = 1 (whose two consumer warpgroups take the head's
// windows in turns). false for a launch the kernels do not take.
static bool wa_plan(WaPlan* p, int bnw, int n, int heads, int head_dim, int n_r) {
  if (n != WA_N || head_dim != WA_D || bnw < 1 || heads < 1 || n_r < 1 || bnw % n_r != 0)
    return false;
  static const int sms = hopper::sm_count();
  const int group = heads % 2 == 0 ? 2 : 1, n_groups = heads / group, n_per = bnw / n_r;
  const long long items = (long long)n_groups * n_r;
  const long long fill = sms / items, most = n_per / (3 - group);
  const long long n_chunks = fill < most ? fill : most;
  *p = WaPlan{group, n_groups, n_r, n_per, n_chunks > 1 ? (int)n_chunks : 1};
  return items * p->n_chunks <= 2147483647LL;
}

}  // namespace t4s
