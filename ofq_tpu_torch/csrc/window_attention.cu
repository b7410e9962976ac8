// The Swin window-attention tail, per (window, head) unit: K6, K7, K8.
//
// Replaces the three Pallas kernels of benchmarks/window_attn_lab.py, which
// compute one function three ways (lab shapes: Swin-T stage 0 at batch 64,
// Bn = 4096 windows of n = 49 tokens, H = 3 heads of d = 32, bf16):
//   K6  _mk_kernel (pallas_units):       WB windows per program, one
//       (window, head) unit at a time; with the lab's ablation switches
//       do_scores, do_softmax, do_out;
//   K7  _mk_packed_kernel (pallas_packed): P units per pair of dots, tokens
//       padded 49 -> 64, -inf on the padded key columns, block-diagonal
//       operands;
//   K8  _mk_packed_aligned_kernel (pallas_packed_aligned): as K7, each unit
//       in its own 128-lane tile.
// For each unit, with q, k, v (49 x 32) and sm = d^-1/2 in fp32:
//   s   = (q k^T, fp32 sums of the exact bf16 products) * sm
//   p   = e / sum(e), e = exp(s - max s), fp32, IEEE divide; p rounded to
//         bf16 (nearest even)
//   out = p v with fp32 sums, rounded to bf16
// q, k, v and out are (Bn, 49, H, 32) bf16, the natural layout of the Swin
// attention: a (token, head) row of 32 values is 64 contiguous bytes, and
// the rows of one window are 49 * H * 32 contiguous values.
//
// What bounds it on an H100: 4 * Bn*49*H*32 * 2 bytes (154.1 MB at the lab
// shape, 0.046 ms at 3.35 TB/s) against 4 * Bn*H*49*49*32 operations
// (3.78 G, 0.004 ms on the bf16 tensor cores): bytes.
//
// All three run on the tensor cores (`mma.sync` m16n8k16, bf16 in, fp32
// sums) through one device function, `unit_tile`, templated on the
// shared-memory layout of a unit and on K6's form, so that their roundings
// are one.  A unit's q, k and v sit in shared memory as 64 rows (rows
// 49-63 zero, written once per buffer, never loaded) of 32 bf16.  One warp
// takes one 16-row tile of a unit:
//   S = Q K^T:  8 key tiles x 2 k16 steps, K through `ldmatrix` (its rows
//               are the B operand's columns);
//   softmax:    in registers: s = acc * sm (__fmul_rn, after the fp32
//               sum), key columns >= 49 at -inf, row max and sum over the
//               16 values a lane holds and then across its quad (shuffles
//               xor 1, 2), expf, __fdiv_rn (neither on a masked column or
//               on the padding rows 56-63), p rounded to bf16 straight
//               into the A fragments of
//   O = P V:    4 k16 steps x 4 column tiles, V through `ldmatrix.trans`.
// The (Bn, H, 49, 49) scores never leave the registers.  The warp writes
// its output rows (< 49) over the q rows it alone read.  K6's ablated forms
// compute what `_mk_kernel` does, on the same tile:
//   do_scores = false:  s[i, j] = q[i, 0] for every key j, not scaled (no
//                       product);
//   do_softmax = false: p = s in fp32 (the padded key columns are 0, from
//                       the zero rows of K), rounded to bf16 into the A
//                       fragments;
//   do_out = false:     out[i, c] = p[i, c] for c < 32, rounded to bf16
//                       straight from the S accumulators (no P V).
// Every form loads q, k and v and stores out, as the lab's kernel does.
//
// How a unit's rows sit in shared memory:
//   Swizzled64 (K6, K7): rows packed densely, 64 bytes each, the 16-byte
//      chunk c of row r at c ^ ((r / 2) % 4): the eight rows an `ldmatrix`
//      phase reads fall in eight distinct bank groups;
//   Slotted80 (K8):  each row in its own 80-byte slot (conflict-free by
//      the slot stride).
// The natural 192-byte token stride at H = 3 would conflict; no layout
// copies rows in it.
//
// K6 (`units_tc_kernel`): WB windows per block, one window's H units per
// pass, through a two-stage ring.  Its loads are TMA copies: one 3-D
// tensor map per operand over (d = 32, H, Bn * 49) with a box of (32, 1,
// 49) and the 64-byte swizzle, so that one copy lands one unit's 49 rows of
// 64 bytes at a 512-byte-aligned buffer, the hardware putting chunk c of
// row r at c ^ ((r / 2) % 4): Swizzled64, with no thread computing an
// address.  One elected thread issues the next window's 3 H copies, with
// their byte count on the stage's `mbarrier`, while the warps compute the
// current one; the warps wait on that barrier's phase.  The outputs leave
// by a TMA store of each unit's q rows through the output's map (timed
// faster than K7's 16-byte vector stores, the same bits: PERF.md).  K7 and
// K8 (`window_attn_tc_kernel`): P units per pass (unit u of
// a block: window u / H, head u % H, the lab's `_units` order; with P not a
// multiple of H a pass straddles two windows), copied with 16-byte
// `cp.async` into a two-stage ring where two stages leave room for two
// blocks per SM, else one; the block stores a pass's outputs from the q
// rows as 16-byte vectors.
//
// Rounding: __f*_rn where a contraction could move a value, expf (not
// __expf), __fdiv_rn; no --use_fast_math.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int N = 49;        // tokens per window
constexpr int D = 32;        // head width
constexpr int NP = 64;       // tokens padded
constexpr int TC_MAX_WARPS = 16;  // one warp per 16-row tile of a pass, at
                                  // most 16
constexpr unsigned FULL = 0xffffffffu;
constexpr int kUnits = 0, kPacked = 1, kAligned = 2;
constexpr size_t MAX_SMEM = 232448;
// K6's forms (flags: do_scores | do_softmax << 1 | do_out << 2)
constexpr int kFull = 7, kNoDots = 2, kNoSoftmax = 5, kScoresOnly = 1;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// element offset of (window b, token n, head h, column 0)
__device__ __forceinline__ size_t offset(int b, int n, int h, int H) {
  return ((size_t)(b * N + n) * H + h) * D;
}

// A unit's q, k or v in shared memory: 64 rows of 32 bf16; at(r, c) is the
// element offset of the 16-byte chunk c (columns 8c..8c+7) of row r.
struct Swizzled64 {  // K6, K7; the layout TMA's 64-byte swizzle writes
  static constexpr int MAT = NP * D;
  __device__ static int at(int r, int c) {
    return r * D + ((c ^ ((r >> 1) & 3)) << 3);
  }
};

struct Slotted80 {  // K8
  static constexpr int MAT = NP * 40;
  __device__ static int at(int r, int c) { return r * 40 + (c << 3); }
};

template <class L>
constexpr size_t stage_bytes(int P) {
  return (size_t)3 * P * L::MAT * sizeof(bf16);
}

// Two stages where they still leave room for two blocks per SM, else one:
// on the H100 a second stage that leaves one block per SM costs more than
// it hides (K7 at P 6 and K8 at P 4 ran slower with it).
template <class L>
constexpr int stages_for(int P) {
  return 2 * 2 * stage_bytes<L>(P) <= MAX_SMEM ? 2 : 1;
}

// How a kernel is launched: dynamic shared memory per block, ring stages
// and warps per block.
struct Launch {
  size_t smem;
  int stages, warps;
};

constexpr int tc_warps(int units) {
  return 4 * units < TC_MAX_WARPS ? 4 * units : TC_MAX_WARPS;
}

// K7's or K8's launch at P units per pass: one warp per 16-row tile of a
// pass, at most TC_MAX_WARPS, so that a pass of up to 4 units takes one
// round.
template <class L>
constexpr Launch tc_launch(int P) {
  return {stages_for<L>(P) * stage_bytes<L>(P), stages_for<L>(P),
          tc_warps(P)};
}

// K6's ring: two stages of one window's 3 H unit buffers (4096 bytes
// each, so every buffer starts on the 512-byte repeat of the 64-byte
// swizzle), behind the stages' mbarriers; 1024 bytes of room to align the
// buffers, the barriers inside it.
constexpr int K6_STAGES = 2;
constexpr size_t K6_ALIGN = 1024;

constexpr Launch units_launch(int H) {
  return {K6_STAGES * stage_bytes<Swizzled64>(H) + K6_ALIGN, K6_STAGES,
          tc_warps(H)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// d (16 x 8, fp32) += a (16 x 16) b (16 x 8), bf16 operands
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---- TMA and mbarriers (K6)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// generic-proxy shared memory accesses ordered with the async proxy's
// (TMA's)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the box at (c0, c1, c2) of `map` into shared memory at dst, completing on
// `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// shared memory at src to the box at (c0, c1, c2) of `map`
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0,
                                             int c1, int c2,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until every committed TMA store has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Rows mt*16 .. mt*16+15 of one unit in form F (K7, K8: kFull), the output
// rows (< 49) written over the q rows Qs (this warp's alone).  Fragment
// layouts (m16n8k16): lane = 4 g + c4 holds rows g and g + 8, columns
// 2 c4 and 2 c4 + 1 of each 8-column tile.
template <class L, int F>
__device__ __forceinline__ void unit_tile(bf16* Qs, const bf16* Ks,
                                          const bf16* Vs, int mt, float sm,
                                          int lane) {
  constexpr bool kScores = F & 1, kSoftmax = F & 2, kOut = F & 4;
  const int r0 = mt * 16, g = lane >> 2, c4 = lane & 3;
  const int i = lane >> 3, j = lane & 7;  // ldmatrix: matrix i, its row j
  float s[8][4];
  if constexpr (kScores) {
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // d in 16s: chunks 2 kk, 2 kk + 1
      uint32_t a[4];
      ldsm_x4<false>(a, Qs + L::at(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // keys 16 p .. 16 p + 15
        uint32_t b[4];
        ldsm_x4<false>(
            b, Ks + L::at(16 * p + (i >> 1) * 8 + j, 2 * kk + (i & 1)));
        mma16816(s[2 * p], a, b[0], b[1]);
        mma16816(s[2 * p + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = __fmul_rn(s[t][e], sm);
  } else {
    // nodots: q[row, 0] for every key of the row, not scaled
    const float q0 = bf(Qs[L::at(r0 + g, 0)]);
    const float q1 = bf(Qs[L::at(r0 + g + 8, 0)]);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = s[t][1] = q0;
      s[t][2] = s[t][3] = q1;
    }
  }
  if constexpr (kSoftmax) {
    // softmax of rows g (h = 0) and g + 8 (h = 1); key columns >= 49 at
    // -inf
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * t + 2 * c4 + (e & 1);
        if (col >= N) s[t][e] = -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[t][e]);
      }
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(FULL, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(FULL, m[h], 2));
    }
    // rows 56..63 (the last tile's second half) are padding: no exp, no
    // divide; p = 0 there (their outputs are dropped)
    const bool live1 = r0 + 8 < N;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * t + 2 * c4 + (e & 1);
        const bool live = col < N && (e < 2 || live1);
        s[t][e] = live ? expf(__fsub_rn(s[t][e], m[e >> 1])) : 0.0f;
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[t][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(FULL, sum[h], 1));
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(FULL, sum[h], 2));
    }
    // p = e / sum (0 where e is: masked or padding)
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * t + 2 * c4 + (e & 1);
        const bool live = col < N && (e < 2 || live1);
        s[t][e] = live ? __fdiv_rn(s[t][e], sum[e >> 1]) : 0.0f;
      }
    }
  }
  // the output tile: O = P V, or p's first 32 columns
  float o[4][4];
  if constexpr (kOut) {
    // p (bf16) from the score fragments into the A fragments
#pragma unroll
    for (int t = 0; t < 4; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
      const float* lo = s[2 * kk];
      const float* hi = s[2 * kk + 1];
      const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                             pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // columns 16 p .. 16 p + 15
        uint32_t b[4];
        ldsm_x4<true>(
            b, Vs + L::at(16 * kk + (i & 1) * 8 + j, 2 * p + (i >> 1)));
        mma16816(o[2 * p], a, b[0], b[1]);
        mma16816(o[2 * p + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = s[t][e];
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r < N) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        *reinterpret_cast<uint32_t*>(Qs + L::at(r, t) + 2 * c4) =
            pack_bf16(o[t][2 * h], o[t][2 * h + 1]);
    }
  }
}

// rows 49..63 of `mats` unit matrices from base (layout L): zero
template <class L>
__device__ __forceinline__ void zero_padding(bf16* base, int mats) {
  for (int e = threadIdx.x; e < mats * (NP - N) * 4; e += blockDim.x) {
    const int c = e & 3, r = N + (e >> 2) % (NP - N), m = (e >> 2) / (NP - N);
    *reinterpret_cast<uint4*>(base + m * L::MAT + L::at(r, c)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// ------------------------------------------------------ K6, TMA loads
// Grid: Bn / WB blocks; block: tc_warps(H) warps.  Pass w brings window
// b0 + w's H units into stage w % 2 by TMA (thread 0 issues pass w + 1's
// copies before the warps compute pass w) and sends their outputs out
// from the q rows by TMA store (measured faster than K7's 16-byte vector
// stores: PERF.md).  Shared memory: the two stages' barriers, then (at the
// next 1024-byte boundary) [stage][q, k, v][unit][MAT].
template <int F>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32) units_tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap, int H, int WB, float sm) {
  extern __shared__ __align__(16) char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  const uint32_t raw = smem_u32(smem_raw);
  bf16* smem = reinterpret_cast<bf16*>(
      smem_raw + ((raw + 16 + K6_ALIGN - 1) / K6_ALIGN * K6_ALIGN - raw));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int stage_elems = 3 * H * Swizzled64::MAT;
  const int b0 = blockIdx.x * WB;  // first window of this block

  zero_padding<Swizzled64>(smem, K6_STAGES * 3 * H);
  if (tid == 0) {
    for (int st = 0; st < K6_STAGES; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the zeroed rows before any copy into the stages
  __syncthreads();

  // thread 0: window b0 + w's q, k, v units into stage st
  auto issue = [&](int w, int st) {
    bf16* base = smem + st * stage_elems;
    mbar_expect_tx(&full[st], 3 * H * N * D * (uint32_t)sizeof(bf16));
    const int row = (b0 + w) * N;
    for (int u = 0; u < H; ++u) {
      tma_load_3d(base + u * Swizzled64::MAT, &qmap, 0, u, row, &full[st]);
      tma_load_3d(base + (H + u) * Swizzled64::MAT, &kmap, 0, u, row,
                  &full[st]);
      tma_load_3d(base + (2 * H + u) * Swizzled64::MAT, &vmap, 0, u, row,
                  &full[st]);
    }
  };

  if (tid == 0) issue(0, 0);
  for (int w = 0; w < WB; ++w) {
    const int st = w & 1;
    bf16* base = smem + st * stage_elems;
    if (tid == 0 && w + 1 < WB) {
      // stage st ^ 1 held pass w - 1: computed (the barrier that ended
      // it) and read out by its store
      bulk_wait_read();
      fence_proxy_async();
      issue(w + 1, st ^ 1);
    }
    mbar_wait(&full[st], (w >> 1) & 1);
    for (int task = warp; task < 4 * H; task += warps) {
      const int u = task >> 2, mt = task & 3;
      unit_tile<Swizzled64, F>(base + u * Swizzled64::MAT,
                               base + (H + u) * Swizzled64::MAT,
                               base + (2 * H + u) * Swizzled64::MAT, mt, sm,
                               lane);
    }
    fence_proxy_async();  // this thread's output rows, for the store
    __syncthreads();
    if (tid == 0) {
      for (int u = 0; u < H; ++u)
        tma_store_3d(&omap, 0, u, (b0 + w) * N, base + u * Swizzled64::MAT);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (Bn, 49, H, 32) bf16 tensor as (d, H, Bn * 49), a box of
// one unit (32, 1, 49), 64-byte swizzle; false when the driver refuses it.
bool unit_map(CUtensorMap* map, EncodeTiled encode, const void* base, int Bn,
              int H) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)Bn * N};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16),
                                 (cuuint64_t)H * D * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)D, 1u, (cuuint32_t)N};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets `kernel`'s dynamic shared memory to c.smem; with `blocks`, writes
// there the blocks of it one SM holds at c's launch (the CUDA runtime's
// occupancy: shared memory, threads and registers).  Returns a CUDA error
// code.
int prepare(const void* kernel, const Launch& c, int* blocks = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err == cudaSuccess && blocks != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, 32 * c.warps, c.smem);
  return (int)err;
}

// K6's kernel in form `form`
const void* units_kernel_of(int form) {
  switch (form) {
    case kFull: return (const void*)units_tc_kernel<kFull>;
    case kNoDots: return (const void*)units_tc_kernel<kNoDots>;
    case kNoSoftmax: return (const void*)units_tc_kernel<kNoSoftmax>;
    case kScoresOnly: return (const void*)units_tc_kernel<kScoresOnly>;
    default: return nullptr;
  }
}

// --------------------------------------------- K7, K8, cp.async loads
// Grid: Bn / WB blocks of WB * H units, P units per pass; the block's
// passes go through `stages` ring buffers of q, k, v ([which][unit][MAT]);
// any number of warps (`tc_launch` gives the count).
template <class L>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32) window_attn_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int H, int WB, int P,
    int stages, float sm) {
  extern __shared__ __align__(16) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int stage_elems = 3 * P * L::MAT;
  const int b0 = blockIdx.x * WB;  // first window of this block
  const int passes = WB * H / P;
  // lu / H for the block's units lu < WB * H: multiply by 2^32 / H + 1 and
  // shift (exact while lu * H < 2^32)
  const uint64_t h_magic = (1ull << 32) / H + 1;
  // element offset of unit lu's (token 0, column 0) in q, k, v and out
  auto unit_offset = [&](int lu) {
    const int hb = (int)(((uint64_t)lu * h_magic) >> 32);
    return offset(b0 + hb, 0, lu - hb * H, H);
  };
  constexpr int ROW_CHUNKS = N * 4;  // 16-byte chunks of a unit's 49 rows

  zero_padding<L>(smem, stages * 3 * P);
  // global -> stage: rows < 49 of the pass's units, 16 bytes a copy; the
  // divisors are constants but for the one by H
  auto issue = [&](int pass, int stage) {
    bf16* base = smem + stage * stage_elems;
    for (int e = tid; e < 3 * P * ROW_CHUNKS; e += threads) {
      const int m = e / ROW_CHUNKS, rc = e - m * ROW_CHUNKS;  // m: which, u
      const int which = (m >= P) + (m >= 2 * P), u = m - which * P;
      const int n = rc >> 2, c = rc & 3;
      const bf16* g = which == 0 ? q : which == 1 ? k : v;
      cp_async16(base + m * L::MAT + L::at(n, c),
                 g + unit_offset(pass * P + u) + (size_t)n * H * D + 8 * c);
    }
    cp_async_commit();
  };
  // stage -> out: the outputs over the q rows
  auto store = [&](int pass, int stage) {
    const bf16* base = smem + stage * stage_elems;
    for (int e = tid; e < P * ROW_CHUNKS; e += threads) {
      const int u = e / ROW_CHUNKS, rc = e - u * ROW_CHUNKS;
      const int n = rc >> 2, c = rc & 3;
      *reinterpret_cast<uint4*>(out + unit_offset(pass * P + u) +
                                (size_t)n * H * D + 8 * c) =
          *reinterpret_cast<const uint4*>(base + u * L::MAT + L::at(n, c));
    }
  };
  auto compute = [&](int stage) {
    bf16* base = smem + stage * stage_elems;
    for (int task = warp; task < 4 * P; task += warps) {
      const int u = task >> 2, mt = task & 3;
      unit_tile<L, kFull>(base + u * L::MAT, base + (P + u) * L::MAT,
                          base + (2 * P + u) * L::MAT, mt, sm, lane);
    }
  };

  if (stages == 2) {
    issue(0, 0);
    for (int pass = 0; pass < passes; ++pass) {
      const int st = pass & 1;
      cp_async_wait_all();
      __syncthreads();  // pass's operands and pass - 1's outputs visible
      if (pass > 0) {
        store(pass - 1, st ^ 1);
        __syncthreads();  // stage st ^ 1 free
      }
      if (pass + 1 < passes) issue(pass + 1, st ^ 1);
      compute(st);
    }
    __syncthreads();
    store(passes - 1, (passes - 1) & 1);
  } else {
    for (int pass = 0; pass < passes; ++pass) {
      __syncthreads();  // the previous pass's outputs stored
      issue(pass, 0);
      cp_async_wait_all();
      __syncthreads();
      compute(0);
      __syncthreads();
      store(pass, 0);
    }
  }
}

template <class L>
int launch_tc(const void* q, const void* k, const void* v, void* out, int Bn,
              int H, int WB, int P, float sm, cudaStream_t stream) {
  const Launch c = tc_launch<L>(P);
  const int err = prepare((const void*)window_attn_tc_kernel<L>, c);
  if (err != cudaSuccess) return err;
  window_attn_tc_kernel<L><<<Bn / WB, 32 * c.warps, c.smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, WB, P,
      c.stages, sm);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch of variant `variant` (0: K6 in form `form`, 1: K7, 2: K8; K7
// and K8 ignore `form`) at H heads and P units per pass (K6: H): returns
// its dynamic shared memory per block; writes its ring stages, warps per
// block and the blocks one SM holds (the CUDA runtime's occupancy of the
// kernel instance launched: shared memory, threads and registers; 0 where
// it cannot take that shared memory or `form` is none of K6's).
extern "C" long long ofq_window_attn_launch(int variant, int form, int H,
                                            int P, int* stages, int* warps,
                                            int* blocks) {
  Launch c;
  const void* kernel;
  switch (variant) {
    case kUnits:
      c = units_launch(H);
      kernel = units_kernel_of(form);
      break;
    case kPacked:
      c = tc_launch<Swizzled64>(P);
      kernel = (const void*)window_attn_tc_kernel<Swizzled64>;
      break;
    default:
      c = tc_launch<Slotted80>(P);
      kernel = (const void*)window_attn_tc_kernel<Slotted80>;
  }
  *stages = c.stages;
  *warps = c.warps;
  if (kernel == nullptr || prepare(kernel, c, blocks) != cudaSuccess) {
    *blocks = 0;
    cudaGetLastError();  // a refused query leaves no error for the launches
  }
  return (long long)c.smem;
}

// K6 in form `flags` (do_scores | do_softmax << 1 | do_out << 2: the full
// tail 7 and the lab's ablations 2, 5, 1).  q, k, v, out: (Bn, 49, H, 32) bf16,
// contiguous, 16-byte aligned; Bn % WB == 0.  Returns a CUDA error code:
// cudaErrorNotSupported where the driver offers no cuTensorMapEncodeTiled,
// cudaErrorInvalidValue where it refuses a map.
extern "C" int ofq_window_attn_units(const void* q, const void* k,
                                     const void* v, void* out, int Bn, int H,
                                     int WB, float sm, int flags,
                                     void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i)
    if (!unit_map(&maps[i], encode, bases[i], Bn, H))
      return (int)cudaErrorInvalidValue;
  const void* kernel = units_kernel_of(flags);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const Launch c = units_launch(H);
  const int err = prepare(kernel, c);
  if (err != cudaSuccess) return err;
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &H, &WB, &sm};
  return (int)cudaLaunchKernel(kernel, dim3(Bn / WB), dim3(32 * c.warps),
                               args, c.smem, (cudaStream_t)stream);
}

// K7, K8.  q, k, v, out: (Bn, 49, H, 32) bf16, contiguous, 16-byte
// aligned; Bn % WB == 0; (WB * H) % P == 0.
extern "C" int ofq_window_attn_packed(const void* q, const void* k,
                                      const void* v, void* out, int Bn, int H,
                                      int WB, int P, float sm, void* stream) {
  return launch_tc<Swizzled64>(q, k, v, out, Bn, H, WB, P, sm,
                               (cudaStream_t)stream);
}

extern "C" int ofq_window_attn_packed_aligned(const void* q, const void* k,
                                              const void* v, void* out,
                                              int Bn, int H, int WB, int P,
                                              float sm, void* stream) {
  return launch_tc<Slotted80>(q, k, v, out, Bn, H, WB, P, sm,
                              (cudaStream_t)stream);
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
