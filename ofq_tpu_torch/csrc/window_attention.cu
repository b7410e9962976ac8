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
// K6 stays on the CUDA cores: its ablation forms are timing probes of this
// design.  One warp per query row of a unit; lane j holds the scores of
// key columns j and j + 32 (k-ordered fp32 sums, the product of two bf16
// values being exact in fp32), the row max and sum are warp shuffles, and
// lane j then sums output column j over the 49 keys.  One window's H units
// per pass, 49 rows widened to fp32 rows of 33 words (conflict-free for
// row-per-lane reads).  The ablated forms compute what `_mk_kernel` does:
//   do_scores = false:  s[i, j] = q[i, 0] for every key j, not scaled;
//   do_softmax = false: p = s, fp32;
//   do_out = false:     out[i, c] = p[i, c] for c < 32, rounded to bf16;
//                       else out = bf16(p) v with fp32 sums.
// Every form loads q, k and v and stores out, as the lab's kernel does.
//
// K7 and K8 run on the tensor cores (`mma.sync` m16n8k16, bf16 in, fp32
// sums), one device function (`unit_tile`) templated on the shared-memory
// layout.  A pass holds P units (unit u of a block: window u / H, head
// u % H, the lab's `_units` order; with P not a multiple of H a pass
// straddles two windows), each unit's q, k and v as 64 rows (rows 49-63
// zero, written once per buffer, never loaded) of 32 bf16, copied from
// global memory with 16-byte `cp.async` into a two-stage ring where two
// stages leave room for two blocks per SM (the loads of pass i + 1 in
// flight while pass i computes), else one (the loads of one block overlap
// the other blocks' compute).  One warp takes one 16-row tile of a unit:
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
// its output rows (< 49) over the q rows it alone read, and the block
// stores a pass's outputs from there as 16-byte vectors.  What tells K7
// from K8 is how a unit's rows sit in shared memory, as in the lab:
//   K7 (Swizzled64): rows packed densely, 64 bytes each, the 16-byte
//      chunk c of row r at c ^ ((r / 2) % 4): the eight rows an `ldmatrix`
//      phase reads fall in eight distinct bank groups;
//   K8 (Slotted80):  each row in its own 80-byte slot (conflict-free by the
//      slot stride).
// The natural 192-byte token stride at H = 3 would conflict; neither
// layout copies rows in it.
//
// Rounding: __f*_rn where a contraction could move a value, expf (not
// __expf), __fdiv_rn; no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int N = 49;        // tokens per window
constexpr int D = 32;        // head width
constexpr int NP = 64;       // tokens padded (K7, K8)
constexpr int THREADS = 256;     // K6
constexpr int WARPS = THREADS / 32;
constexpr int TC_MAX_WARPS = 16;  // K7, K8: one warp per 16-row tile of a
                                  // pass, at most 16
constexpr unsigned FULL = 0xffffffffu;
constexpr int kUnits = 0, kPacked = 1, kAligned = 2;
constexpr int FSTRIDE = D + 1;   // K6: fp32 row, in words
constexpr size_t MAX_SMEM = 232448;
// K6's forms (flags: do_scores | do_softmax << 1 | do_out << 2)
constexpr int kFull = 7, kNoDots = 2, kNoSoftmax = 5, kScoresOnly = 1;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// element offset of (window b, token n, head h, column 0)
__device__ __forceinline__ size_t offset(int b, int n, int h, int H) {
  return ((size_t)(b * N + n) * H + h) * D;
}

// ------------------------------------------------------ K6, CUDA cores
// One window's H units: q, k, v as [unit][49][33] fp32.
struct UnitsTile {
  float* q;
  float* k;
  float* v;
  __device__ UnitsTile(char* smem, int units) {
    q = reinterpret_cast<float*>(smem);
    k = q + units * N * FSTRIDE;
    v = k + units * N * FSTRIDE;
  }
  static size_t bytes(int units) { return (size_t)3 * units * N * FSTRIDE * 4; }
  // lane: key columns lane and lane + 32 (>= 49 read nothing)
  __device__ void scores(int u, int r, int lane, float& s0, float& s1) const {
    const float* qr = q + (u * N + r) * FSTRIDE;
    const float* k0 = k + (u * N + lane) * FSTRIDE;
    const float* k1 = k + (u * N + lane + 32) * FSTRIDE;
    const bool has1 = lane + 32 < N;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qd = qr[dd];
      s0 = fmaf(qd, k0[dd], s0);
      if (has1) s1 = fmaf(qd, k1[dd], s1);
    }
  }
};

// One query row r of unit u in form F, stored to `orow` (32 values).
template <int F>
__device__ __forceinline__ void units_row(const UnitsTile& t, int u, int r,
                                          float sm,
                                          bf16* __restrict__ orow, int lane) {
  constexpr bool kScores = F & 1, kSoftmax = F & 2, kOut = F & 4;
  const bool ok1 = lane + 32 < N;  // key columns >= 49: -inf
  float s0, s1;
  if constexpr (kScores) {
    s0 = 0.0f, s1 = 0.0f;
    t.scores(u, r, lane, s0, s1);
    s0 = __fmul_rn(s0, sm);
    s1 = ok1 ? __fmul_rn(s1, sm) : -INFINITY;
  } else {
    s0 = t.q[(u * N + r) * FSTRIDE];  // q[r, 0] for every key, not scaled
    s1 = ok1 ? s0 : -INFINITY;
  }
  float p0 = s0, p1 = ok1 ? s1 : 0.0f;
  if constexpr (kSoftmax) {
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    const float e0 = expf(__fsub_rn(s0, m));
    const float e1 = ok1 ? expf(__fsub_rn(s1, m)) : 0.0f;
    float sum = __fadd_rn(e0, e1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
    p0 = __fdiv_rn(e0, sum);
    p1 = __fdiv_rn(e1, sum);
  }
  if constexpr (kOut) {
    p0 = round_bf16(p0);
    p1 = round_bf16(p1);
    float acc = 0.0f;
#pragma unroll 7
    for (int mm = 0; mm < N; ++mm) {
      const float pm = __shfl_sync(FULL, mm < 32 ? p0 : p1, mm & 31);
      acc = fmaf(pm, t.v[(u * N + mm) * FSTRIDE + lane], acc);
    }
    orow[lane] = __float2bfloat16_rn(acc);
  } else {
    orow[lane] = __float2bfloat16_rn(p0);  // key column lane < 32
  }
}

// Grid: Bn / WB blocks.  Each pass loads the H units of one window, then
// runs its H * 49 query rows, one warp each.
template <int F>
__global__ void __launch_bounds__(THREADS) units_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int H, int WB,
    float sm) {
  extern __shared__ __align__(16) char smem[];
  UnitsTile t(smem, H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int w = 0; w < WB; ++w) {
    const int b = blockIdx.x * WB + w;
    // consecutive threads read consecutive columns
    for (int e = tid; e < 3 * H * N * D; e += THREADS) {
      const int dd = e % D, n = (e / D) % N, uw = e / (D * N);
      const int which = uw / H, u = uw % H;
      const bf16* g = which == 0 ? q : which == 1 ? k : v;
      float* dst = which == 0 ? t.q : which == 1 ? t.k : t.v;
      dst[(u * N + n) * FSTRIDE + dd] = bf(g[offset(b, n, u, H) + dd]);
    }
    __syncthreads();
    for (int task = warp; task < H * N; task += WARPS) {
      const int u = task / N, r = task % N;
      units_row<F>(t, u, r, sm, out + offset(b, r, u, H), lane);
    }
    __syncthreads();
  }
}

template <int F>
int launch_units(const void* q, const void* k, const void* v, void* out,
                 int Bn, int H, int WB, float sm, cudaStream_t stream) {
  const size_t smem = UnitsTile::bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      units_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  units_kernel<F><<<Bn / WB, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, WB, sm);
  return (int)cudaGetLastError();
}

// --------------------------------------------- K7, K8, tensor cores
// A unit's q, k or v in shared memory: 64 rows of 32 bf16; at(r, c) is the
// element offset of the 16-byte chunk c (columns 8c..8c+7) of row r.
struct Swizzled64 {  // K7
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

// How a kernel is launched: dynamic shared memory per block, ring stages,
// warps per block.
struct Launch {
  size_t smem;
  int stages, warps;
};

// K7's or K8's launch at P units per pass: one warp per 16-row tile of a
// pass, at most TC_MAX_WARPS, so that a pass of up to 4 units takes one
// round.
template <class L>
constexpr Launch tc_launch(int P) {
  return {stages_for<L>(P) * stage_bytes<L>(P), stages_for<L>(P),
          4 * P < TC_MAX_WARPS ? 4 * P : TC_MAX_WARPS};
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

// Rows mt*16 .. mt*16+15 of one unit: S = Q K^T, softmax, O = P V, the
// output rows (< 49) written over the q rows Qs (this warp's alone).
// Fragment layouts (m16n8k16): lane = 4 g + c4 holds rows g and g + 8,
// columns 2 c4 and 2 c4 + 1 of each 8-column tile.
template <class L>
__device__ __forceinline__ void unit_tile(bf16* Qs, const bf16* Ks,
                                          const bf16* Vs, int mt, float sm,
                                          int lane) {
  const int r0 = mt * 16, g = lane >> 2, c4 = lane & 3;
  const int i = lane >> 3, j = lane & 7;  // ldmatrix: matrix i, its row j
  float s[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {  // d in 16s: chunks 2 kk, 2 kk + 1
    uint32_t a[4];
    ldsm_x4<false>(a, Qs + L::at(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // keys 16 p .. 16 p + 15
      uint32_t b[4];
      ldsm_x4<false>(b,
                     Ks + L::at(16 * p + (i >> 1) * 8 + j, 2 * kk + (i & 1)));
      mma16816(s[2 * p], a, b[0], b[1]);
      mma16816(s[2 * p + 1], a, b[2], b[3]);
    }
  }
  // softmax of rows g (h = 0) and g + 8 (h = 1)
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * t + 2 * c4 + (e & 1);
      s[t][e] = col < N ? __fmul_rn(s[t][e], sm) : -INFINITY;
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
  // p = e / sum rounded to bf16 (0 where e is: masked or padding)
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * t + 2 * c4 + (e & 1);
      const bool live = col < N && (e < 2 || live1);
      s[t][e] = live ? __fdiv_rn(s[t][e], sum[e >> 1]) : 0.0f;
    }
  }
  // O = P V: p (bf16) from the score fragments into the A fragments
  float o[4][4];
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
      ldsm_x4<true>(b,
                    Vs + L::at(16 * kk + (i & 1) * 8 + j, 2 * p + (i >> 1)));
      mma16816(o[2 * p], a, b[0], b[1]);
      mma16816(o[2 * p + 1], a, b[2], b[3]);
    }
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

  // rows 49..63 of every matrix of every stage: zero, once
  for (int e = tid; e < stages * 3 * P * (NP - N) * 4; e += threads) {
    const int c = e & 3, r = N + (e >> 2) % (NP - N), m = (e >> 2) / (NP - N);
    *reinterpret_cast<uint4*>(smem + m * L::MAT + L::at(r, c)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
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
      unit_tile<L>(base + u * L::MAT, base + (P + u) * L::MAT,
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
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_tc_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  window_attn_tc_kernel<L><<<Bn / WB, 32 * c.warps, c.smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, WB, P,
      c.stages, sm);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch of variant `variant` (0: K6, 1: K7, 2: K8) at H heads and P
// units per pass: returns its dynamic shared memory per block and writes
// its ring stages and warps per block.
extern "C" long long ofq_window_attn_launch(int variant, int H, int P,
                                            int* stages, int* warps) {
  Launch c;
  switch (variant) {
    case kUnits: c = {UnitsTile::bytes(H), 1, WARPS}; break;
    case kPacked: c = tc_launch<Swizzled64>(P); break;
    default: c = tc_launch<Slotted80>(P);
  }
  *stages = c.stages;
  *warps = c.warps;
  return (long long)c.smem;
}

// K6 in form `flags` (do_scores | do_softmax << 1 | do_out << 2: the full
// tail 7 and the lab's ablations 2, 5, 1).  q, k, v, out: (Bn, 49, H, 32)
// bf16, contiguous; Bn % WB == 0.
extern "C" int ofq_window_attn_units(const void* q, const void* k,
                                     const void* v, void* out, int Bn, int H,
                                     int WB, float sm, int flags,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (flags) {
    case kFull: return launch_units<kFull>(q, k, v, out, Bn, H, WB, sm, s);
    case kNoDots: return launch_units<kNoDots>(q, k, v, out, Bn, H, WB, sm, s);
    case kNoSoftmax:
      return launch_units<kNoSoftmax>(q, k, v, out, Bn, H, WB, sm, s);
    case kScoresOnly:
      return launch_units<kScoresOnly>(q, k, v, out, Bn, H, WB, sm, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
