// Fused quantized attention core, backward (K3): the cotangents of
// scores -> softmax -> LSQ -> @ v with respect to lhs, rhs, v and the
// per-query-row LSQ scale s.
//
// Replaces the Pallas kernel ofq_tpu/ops/fused_attention.py:_bwd_kernel
// (called by _attn_core_bwd, the custom VJP of quantized_attention_core).
// For every (b, h), with u = p / s_n and s_n = max(s[n], 1e-5):
//
//   scores  = fp32(lhs . rhs^T) * sm_scale,  p = softmax(scores)   (recomputed)
//   in      = u <= thd_pos,  uq = rint(clip(u, 0, thd_pos)),  pq = uq * s_n
//   dv      = pq^T . g,      dpq = g . v^T
//   dp      = in ? dpq : 0
//   ds[n]  += sum_m (in ? uq - u : thd_pos) * dpq       (over b, h and m)
//   dscores = p * (dp - sum_m dp * p) * sm_scale
//   drhs    = dscores^T . lhs,   dlhs = dscores . rhs    (summed over heads
//                                                        for a shared lhs)
//
// With quantize == 0, pq = p, dp = dpq and ds = 0.  Every sum is in fp32, as
// in the TPU kernel.  lhs is shared across heads ((B, N, K), QKR's quantized
// input) or per head ((B, N, H, K)); rhs (B, N, H, K); v and g (B, N, H, D);
// contiguous, in the JAX package's natural layout; s and ds fp32.
//
// The stream dtype T of lhs, rhs, v, g, dlhs, drhs and dv is fp32 or bf16
// (one template, two C launchers).  In bf16 the TPU kernel's roundings are
// reproduced: operands are widened exactly to fp32 as they are loaded (exact
// products, fp32 sums); pq is rounded to bf16 before dv = pq^T . g
// (`pq.astype(g.dtype)`); dscores * sm_scale is formed in fp32 and rounded
// to bf16 once, and that value feeds both drhs and dlhs; dlhs, drhs and dv
// are rounded to bf16 once, a shared dlhs after its fp32 sum over heads; ds
// and everything that feeds it stay fp32.  The scratch tensors hold exactly
// the rounded values, so they are stored in T: bf16 scratch loses nothing.
//
// Design.  The TPU kernel keeps a whole batch row's (U, N, N) tiles in VMEM
// and carries ds across its sequential grid in one VMEM ref.  Hopper blocks
// run in no order and a block owns far less fast memory, and three of the
// outputs are sums over an axis a query tile cannot own (drhs and dv over
// query rows, a shared dlhs over heads).  So four launches:
//   A  one 256-thread block per (64 query rows, head, batch row), the grid of
//      K2: the score tile (64 x N, ~50 KB of shared memory at N = 198 in
//      fp32) is formed by K2's score tile, so p is the forward's p bit for
//      bit, and the dpq tile beside it, 32 x N at a time, so that pass A
//      takes ~97 KB (bf16) or ~111 KB (fp32) and two blocks share an SM;
//      one warp per row then forms p, pq, dp, the row's ds partial (written
//      per (b, h, n), no atomics) and dscores, and writes pq and dscores to
//      scratch, (B, H, N, ldp) each in the stream dtype;
//   B  one block per (64 keys in bf16, 128 in fp32; 64 output columns;
//      (b, h)): dv = pq^T . g and drhs = dscores^T . lhs;
//   C  one block per (64 query rows in bf16, 128 in fp32; 64 columns; b or
//      (b, h)): dlhs = dscores . rhs, the heads of a shared lhs summed in
//      the block in order h = 0..H-1;
//   D  ds[n] = sum over (b, h) of the partials, in a fixed order.
// In fp32 every product runs on the CUDA cores, register-tiled (below).
// In bf16 pass A's dpq = g . v^T and passes B and C run on the tensor cores
// (see below).  Pass A's score tile is K2's in both stream dtypes: one
// device function, `qkr::score_tile` (csrc/qkr_scores.cuh).  Runs are
// repeatable (no float atomics).
//
// fp32, register-tiled.  Each thread holds 8 x 8 outputs (passes B, C;
// 128 x 64 per 128-thread block, a warp's 32 rows contiguous) or 8 x 7
// (pass A's score tile, in either dtype: a warp's 8 query rows against
// keys lane + 32 j, so 224 keys per sweep) or 4 x 7 (pass A's dpq, 32 rows
// at a time, as the bf16 form); its operands are read from shared memory
// as float4 (four contraction steps of one row, or four rows of one step).
// The operands reach shared memory through cp.async rings (passes B, C: 3
// stages of 16-deep chunks; pass A: 3 stages of 32-byte row chunks, 8 fp32
// or 16 bf16 deep) of 16-byte copies, element copies where a row's 16
// bytes are not whole or not aligned, zero past N, K and D, so the next
// chunks' copies run under this chunk's FMAs.
// The scratch rows are N rounded up to 4 apart (16-byte rows).  Pass A
// keeps the score tile (64 x N) and half the dpq tile in shared memory with
// its ring, ~111 KB at N = 198, so two blocks share an SM; a warp whose
// rows all lie past N skips its FMAs.  Every output is one __fmaf_rn chain
// in ascending contraction index from 0 (a zero-filled step adds an exact
// 0), as the untiled loops summed: scores then times sm_scale with
// __fmul_rn, a shared dlhs over heads h = 0..H-1 in order.  So the tiling
// does not move a bit: K3 fp32 equals its untiled form's outputs, and
// pass A's p is K2 fp32's p.
//
// What bounds it on an H100: at DeiT-S QKR (N = 198, H = 6, K = 384, D = 64)
// the work is 2*B*H*N^2*(3K + 2D) operations against 4*B*N*(2K + 2*H*K +
// 3*H*D) bytes of inputs and outputs, ~116 operations per byte: bounded by
// the fp32 rate (67 TFLOP/s).  The two scratch tensors add ~240 MB of
// traffic at B = 64 (~0.07 ms at 3.35 TB/s).
//
// Rounding: rintf (half to even, as torch.round / jnp.round); expf, not
// __expf; every multiply, divide and subtract that feeds a rounding or the
// in-range test spelled with the __f*_rn intrinsics; no --use_fast_math.
//
// Pass A's score and dpq tiles live in fp32 shared memory in both stream
// dtypes; its dynamic shared memory depends on N and the dtype
// (rows_smem_bytes; the launch export reports it with the scratch stride,
// the ring stages and the blocks per SM the CUDA runtime finds for it).
//
// bf16 on the tensor cores.  Every operand of dpq, dv, drhs and dlhs is
// exact in bf16 (g, v, lhs, rhs as stored; pq and dscores already rounded
// to bf16 where JAX rounds them, and kept so in the scratch), so
// `mma.sync` m16n8k16 bf16 x bf16 -> fp32 computes the plain version's
// terms exactly and only the order of the fp32 sums differs.  Each block
// computes 64 x 64 output tiles (pass A's dpq: 32 x 128), eight warps of
// 16 x 32; the contraction goes in chunks of 32, each operand's chunk
// copied to shared memory as bf16 (16-byte loads where a row chunk is
// whole and aligned; zero past N, K or D: a ragged N = 198 is
// zero-filled) and read into fragments with
// `ldmatrix` (`.trans` where the contraction runs down the stored rows:
// dv's pq^T, drhs's dscores^T, and the g, lhs and rhs operands of B and
// C).  The bf16 scratch rows are padded to a multiple of 8 (ldp) so that
// they load in 16-byte chunks.  Pass A's score tile is K2-bf16's
// (`qkr::score_tile` on bf16 chunks, widened as they are read), so the
// backward's p is the forward's p bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "qkr_scores.cuh"

namespace {

using qkr::TQ;       // query rows per block (passes A and C)
using qkr::THREADS;
using qkr::WARPS;
using qkr::smem_u32;
using qkr::st;
constexpr int TK = 64;       // keys per tile
constexpr int TD = 64;       // output columns per block (passes B and C)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16, fp32 sums)
using bf16 = __nv_bfloat16;
constexpr int TC_K = 32;       // contraction chunk
constexpr int LD_ROW = 40;     // a [rows][32] chunk's row stride (80 B)
constexpr int LD_COL = 72;     // a [32][64] chunk's row stride (144 B)

// ROWS x COLS (COLS a multiple of 8) of a row-major bf16 matrix whose rows
// are ld apart, from (r0, c0), into dst (rows lds apart); zero at rows
// >= rlim and columns >= clim
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int lds,
                                          const bf16* __restrict__ src,
                                          size_t ld, int r0, int c0,
                                          int rlim, int clim) {
  constexpr int CH = COLS / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const int gr = r0 + r, gc = c0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rlim && gc < clim) {
      const bf16* p = src + (size_t)gr * ld + gc;
      if (gc + 8 <= clim && ((uintptr_t)p & 15) == 0) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = gc + 2 * j < clim ? q[2 * j] : 0u;
          const uint32_t hi = gc + 2 * j + 1 < clim ? q[2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
  }
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

// This warp's 16 x 32 part (rows wr.., columns wc..) of an output tile:
// acc[t] (columns wc + 8t ..) += A B over one 32-deep chunk.
// A is stored [row][k] (A_KMAJOR false, rows lda apart) or [k][row]
// (true); B [col][k] (B_KMAJOR false) or [k][col] (true).  acc[t][0..1]:
// row wr + lane / 4, columns wc + 8t + 2 (lane % 4) + 0..1; acc[t][2..3]:
// row + 8.
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const bf16* As,
                                         int lda, const bf16* Bs, int ldb,
                                         int wr, int wc) {
  const int lane = threadIdx.x % 32, i = lane / 8, j = lane % 8;
#pragma unroll
  for (int kk = 0; kk < TC_K; kk += 16) {
    uint32_t a[4];
    ldsm_x4<A_KMAJOR>(
        a, A_KMAJOR ? As + (kk + j + (i / 2) * 8) * lda + wr + (i % 2) * 8
                    : As + (wr + lane % 16) * lda + kk + (lane / 16) * 8);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0 = wc + 16 * p;
      uint32_t b[4];
      ldsm_x4<B_KMAJOR>(
          b, B_KMAJOR ? Bs + (kk + (i % 2) * 8 + j) * ldb + n0 + (i / 2) * 8
                      : Bs + (n0 + (i / 2) * 8 + j) * ldb + kk + (i % 2) * 8);
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// f(row, col, value) over this warp's accumulators (rows and columns of
// the output tile)
template <class F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[4][4],
                                             int wr, int wc, F f) {
  const int lane = threadIdx.x % 32;
  const int r = wr + lane / 4, c = wc + 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    f(r, c + 8 * t, acc[t][0]);
    f(r, c + 8 * t + 1, acc[t][1]);
    f(r + 8, c + 8 * t, acc[t][2]);
    f(r + 8, c + 8 * t + 1, acc[t][3]);
  }
}

// out[r * ld_o + m] = fp32(sum_d g[q0 + r, d] * v[m, d]) for the TQ / 2
// rows from q0 and every m < N (pass A's dpq in bf16), 32 rows x 128 keys
// per round, warp (wr, wc) = (16 (warp % 2), 32 (warp / 2)); As: 32 x
// LD_ROW bf16, Bs: 128 x LD_ROW
constexpr int DPQ_KEYS = 128;
__device__ __forceinline__ void dpq_tc(const bf16* __restrict__ g,
                                       const bf16* __restrict__ v, size_t ld,
                                       int q0, int N, int D, float* out,
                                       int ld_o, bf16* As, bf16* Bs) {
  const int warp = threadIdx.x / 32;
  const int wr = (warp % 2) * 16, wc = (warp / 2) * 32;
  for (int m0 = 0; m0 < N; m0 += DPQ_KEYS) {
    float acc[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += TC_K) {
      load_tile<TQ / 2, TC_K>(As, LD_ROW, g, ld, q0, d0, N, D);
      load_tile<DPQ_KEYS, TC_K>(Bs, LD_ROW, v, ld, m0, d0, N, D);
      __syncthreads();
      warp_mma<false, false>(acc, As, LD_ROW, Bs, LD_ROW, wr, wc);
      __syncthreads();
    }
    for_each_acc(acc, wr, wc, [&](int r, int c, float x) {
      if (m0 + c < N) out[r * ld_o + m0 + c] = x;
    });
  }
}

// Row r of a pass-A tile, one warp: the softmax of its scores `row` (in
// place: p), and with its dpq in `drow`: pq and dscores to the scratch
// (rows ldp apart), dp in drow, the row's ds partial to ds_part_n.
template <typename T>
__device__ __forceinline__ void bwd_row(float* row, float* drow, int n, int N,
                                        const float* __restrict__ s,
                                        T* __restrict__ pq_u,
                                        T* __restrict__ dsc_u, int ldp,
                                        float* __restrict__ ds_part_n,
                                        float thd_pos, float sm_scale,
                                        int quantize) {
  const int lane = threadIdx.x % 32;
  // softmax, exactly as the forward kernel forms it
  float mx = -CUDART_INF_F;
  for (int m = lane; m < N; m += 32) mx = fmaxf(mx, row[m]);
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int m = lane; m < N; m += 32) {
    const float e = expf(__fsub_rn(row[m], mx));
    row[m] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  const float sn = fmaxf(s[n], 1e-5f);
  float ds_acc = 0.0f;
  float dot = 0.0f;
  for (int m = lane; m < N; m += 32) {
    const float p = __fdiv_rn(row[m], sum);
    row[m] = p;
    const float dpq = drow[m];
    float pq = p;
    float dp = dpq;
    if (quantize) {
      const float u = __fdiv_rn(p, sn);
      const float uq = rintf(fminf(fmaxf(u, 0.0f), thd_pos));
      const bool in = u <= thd_pos;
      pq = __fmul_rn(uq, sn);
      const float t = in ? __fsub_rn(uq, u) : thd_pos;
      ds_acc = __fmaf_rn(t, dpq, ds_acc);
      dp = in ? dpq : 0.0f;
    }
    st(pq_u + (size_t)n * ldp + m, pq);
    drow[m] = dp;
    dot = __fmaf_rn(dp, p, dot);
  }
  dot = warp_sum(dot);
  for (int m = lane; m < N; m += 32) {
    st(dsc_u + (size_t)n * ldp + m,
       __fmul_rn(__fmul_rn(row[m], __fsub_rn(drow[m], dot)), sm_scale));
  }
  ds_acc = warp_sum(ds_acc);
  if (lane == 0) *ds_part_n = ds_acc;
}

// Pass A in bf16: per (query tile, head, batch row).  Shared memory: S
// [TQ][ld_s] (scores, then p), then one region that holds the score
// tile's ring while the scores form and then P for half the rows (dpq,
// then dp) with dpq's bf16 chunks after it (rows_smem_bytes).  Two blocks
// per SM at N = 198: at most 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 2) qkr_bwd_rows_tc_kernel(
    const bf16* __restrict__ lhs, int lhs_per_head,
    const bf16* __restrict__ rhs, const bf16* __restrict__ v,
    const float* __restrict__ s, const bf16* __restrict__ g,
    bf16* __restrict__ pq_out, bf16* __restrict__ dsc_out,
    float* __restrict__ ds_part, int N, int H, int K, int D, int ld_s,
    int ldp, float thd_pos, float sm_scale, int quantize) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;
  float* P = S + TQ * ld_s;

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
  const bf16* lhs_b = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
  const bf16* rhs_b = rhs + (size_t)b * N * H * K + (size_t)h * K;
  const bf16* v_b = v + (size_t)b * N * H * D + (size_t)h * D;
  const bf16* g_b = g + (size_t)b * N * H * D + (size_t)h * D;

  // K2-bf16's score tile, so p is the forward's p bit for bit
  qkr::score_tile<bf16>(S, ld_s, lhs_b, lhs_row, q0, rhs_b, (size_t)H * K, N,
                        K, sm_scale, reinterpret_cast<bf16*>(P));
  __syncthreads();

  const size_t unit = (size_t)b * H + h;
  const int warp = threadIdx.x / 32;
  // dpq on the tensor cores, half the rows at a time into P: the smaller
  // shared memory lets two blocks share an SM
  bf16* ga = reinterpret_cast<bf16*>(P + (TQ / 2) * ld_s);
  bf16* vb = ga + (TQ / 2) * LD_ROW;
  for (int r0 = 0; r0 < TQ; r0 += TQ / 2) {
    dpq_tc(g_b, v_b, (size_t)H * D, q0 + r0, N, D, P, ld_s, ga, vb);
    __syncthreads();
    for (int r = r0 + warp; r < r0 + TQ / 2; r += WARPS)
      if (q0 + r < N)
        bwd_row(S + r * ld_s, P + (r - r0) * ld_s, q0 + r, N, s,
                pq_out + unit * N * ldp, dsc_out + unit * N * ldp, ldp,
                ds_part + unit * N + q0 + r, thd_pos, sm_scale, quantize);
    __syncthreads();
  }
}

// ---- fp32 on the CUDA cores: register tiles fed by cp.async rings
constexpr int F_BM = 128;       // passes B, C: output rows per block
constexpr int F_BN = 64;        //   output columns per block
constexpr int F_BK = 16;        //   contraction chunk
constexpr int F_STAGES = 3;     //   ring stages
constexpr int F_THREADS = 128;  //   4 warps of 32 rows x 64 columns
constexpr int PAD = 4;          // row padding of a [rows][k] chunk (floats)
constexpr int F_LD = F_BK + PAD;
using qkr::A_KEYS;              // pass A: keys per sweep of its row products
using qkr::A_STAGES;            //   ring stages
using qkr::A_TN;                //   keys per thread

// Pass A in fp32: per (query tile, head, batch row).  Shared memory: S
// [TQ][ld_s] (scores, then p), then one region that holds the score
// loop's ring and then P [TQ / 2][ld_s] (dpq, then dp, for half the rows)
// with dpq's ring after it (rows_smem_bytes<float>).  Two blocks per SM at
// N = 198: at most 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 2) qkr_bwd_rows_f32_kernel(
    const float* __restrict__ lhs, int lhs_per_head,
    const float* __restrict__ rhs, const float* __restrict__ v,
    const float* __restrict__ s, const float* __restrict__ g,
    float* __restrict__ pq_out, float* __restrict__ dsc_out,
    float* __restrict__ ds_part, int N, int H, int K, int D, int ld_s,
    int ldp, float thd_pos, float sm_scale, int quantize) {
  extern __shared__ __align__(16) float smem_f32[];
  float* S = smem_f32;
  float* R = S + TQ * ld_s;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
  const float* lhs_b = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
  const float* rhs_b = rhs + (size_t)b * N * H * K + (size_t)h * K;
  const float* v_b = v + (size_t)b * N * H * D + (size_t)h * D;
  const float* g_b = g + (size_t)b * N * H * D + (size_t)h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // K2 fp32's score tile: each score one FMA chain over k, then times
  // sm_scale
  qkr::score_tile<float>(S, ld_s, lhs_b, lhs_row, q0, rhs_b, (size_t)H * K, N,
                         K, sm_scale, R);

  const size_t unit = (size_t)b * H + h;
  float* P = R;
  float* dpq_ring = P + (TQ / 2) * ld_s;
  for (int r0 = 0; r0 < TQ; r0 += TQ / 2) {
    for (int m0 = 0; m0 < N; m0 += A_KEYS) {
      float acc[4][A_TN];
      qkr::rows_product<float, 4>(acc, g_b, (size_t)H * D, q0 + r0, v_b,
                                  (size_t)H * D, m0, N, D, dpq_ring);
#pragma unroll
      for (int j = 0; j < A_TN; ++j) {
        const int m = m0 + lane + 32 * j;
        if (m < N) {
#pragma unroll
          for (int i = 0; i < 4; ++i) P[(4 * warp + i) * ld_s + m] = acc[i][j];
        }
      }
    }
    __syncthreads();
    for (int r = r0 + warp; r < r0 + TQ / 2; r += WARPS)
      if (q0 + r < N)
        bwd_row(S + r * ld_s, P + (r - r0) * ld_s, q0 + r, N, s,
                pq_out + unit * N * ldp, dsc_out + unit * N * ldp, ldp,
                ds_part + unit * N + q0 + r, thd_pos, sm_scale, quantize);
    __syncthreads();
  }
}

// out[r * ld + c + j] = v[j] for j < min(avail, 4): one 16-byte store where
// the four are whole and aligned
__device__ __forceinline__ void store4(float* p, int avail, const float* v) {
  if (avail >= 4 && ((uintptr_t)p & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && j < avail; ++j) p[j] = v[j];
  }
}

// A 128 x 64 output tile of passes B and C from acc: this thread's rows
// row0 + i, columns col0 + 0..3 and col0 + 32 + 0..3 (in-tile), bounded by
// rlim rows and clim columns.
__device__ __forceinline__ void store_tile(const float (&acc)[8][8],
                                           float* out, size_t ld_out,
                                           int row0, int rlim, int col0,
                                           int clim) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (row0 + i >= rlim) break;
    float* o = out + (size_t)(row0 + i) * ld_out;
    store4(o + col0, clim - col0, acc[i]);
    store4(o + col0 + 32, clim - col0 - 32, acc[i] + 4);
  }
}

// Pass B in fp32: out[m, c] = sum_n x[n, m] * y[n, c] for 128 keys m and 64
// columns c; column chunks [0, ceil(D/TD)) give dv (x = pq, y = g), the
// rest drhs (x = dscores, y = lhs); x's rows (the scratch) are ldp apart.
// Both operands are stored with the contraction down the rows.
__global__ void __launch_bounds__(F_THREADS) qkr_bwd_cols_f32_kernel(
    const float* __restrict__ pq, const float* __restrict__ dsc,
    const float* __restrict__ g, const float* __restrict__ lhs,
    int lhs_per_head, float* __restrict__ dv, float* __restrict__ drhs,
    int N, int H, int K, int D, int ldp) {
  constexpr int STAGE = F_BK * (F_BM + F_BN);
  __shared__ __align__(16) float buf[F_STAGES * STAGE];
  const int m0 = blockIdx.x * F_BM;
  const int unit = blockIdx.z;
  const int b = unit / H;
  const int h = unit % H;
  const int nd = (D + TD - 1) / TD;

  const float* x;
  const float* y;
  size_t ldy, ld_out;
  int ncols, c0;
  float* out;
  if ((int)blockIdx.y < nd) {
    x = pq + (size_t)unit * N * ldp;
    y = g + (size_t)b * N * H * D + (size_t)h * D;
    ldy = (size_t)H * D;
    ncols = D;
    c0 = blockIdx.y * TD;
    out = dv + (size_t)b * N * H * D + (size_t)h * D;
    ld_out = (size_t)H * D;
  } else {
    const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
    x = dsc + (size_t)unit * N * ldp;
    y = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
    ldy = lhs_row;
    ncols = K;
    c0 = (blockIdx.y - nd) * TD;
    out = drhs + (size_t)b * N * H * K + (size_t)h * K;
    ld_out = (size_t)H * K;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 32 * warp + 8 * (lane >> 3), col0 = 4 * (lane & 7);
  const bool live = m0 + 32 * warp < N;
  float acc[8][8] = {};
  qkr::ring<F_STAGES>(
      (N + F_BK - 1) / F_BK,
      [&](int c, int st) {
        float* As = buf + st * STAGE;
        qkr::load_rows<float, F_BK, F_BM, F_THREADS>(As, F_BM, x, ldp, c * F_BK, N, m0,
                                        N);
        qkr::load_rows<float, F_BK, F_BN, F_THREADS>(As + F_BK * F_BM, F_BN, y, ldy,
                                        c * F_BK, N, c0, ncols);
      },
      [&](int st) {
        const float* As = buf + st * STAGE;
        if (live)
          qkr::fma_chunk<float, 8, 8, F_BK, true, true>(acc, As, F_BM, row0,
                                            As + F_BK * F_BM, F_BN, col0, 32);
      });
  store_tile(acc, out + c0 + (size_t)m0 * ld_out, ld_out, row0, N - m0, col0,
             ncols - c0);
}

// Pass C in fp32: dlhs[n, c] = sum_h sum_m dscores[b, h, n, m] * rhs[b, m,
// h, c] for 128 query rows and 64 columns; a shared lhs sums h = 0..H-1 in
// this block, a per-head lhs takes one head per block.  The contraction
// runs over (h, m) in that order, in chunks of F_BK keys of one head;
// dscores is stored [n][m] (the contraction along the rows), rhs [m][c].
__global__ void __launch_bounds__(F_THREADS) qkr_bwd_dlhs_f32_kernel(
    const float* __restrict__ dsc, const float* __restrict__ rhs,
    int lhs_per_head, float* __restrict__ dlhs, int N, int H, int K,
    int ldp) {
  constexpr int STAGE = F_BM * F_LD + F_BK * F_BN;
  __shared__ __align__(16) float buf[F_STAGES * STAGE];
  const int q0 = blockIdx.x * F_BM;
  const int c0 = blockIdx.y * TD;
  int b, h0, h1;
  float* out;
  size_t ld_out;
  if (lhs_per_head) {
    b = blockIdx.z / H;
    h0 = blockIdx.z % H;
    h1 = h0 + 1;
    out = dlhs + (size_t)b * N * H * K + (size_t)h0 * K;
    ld_out = (size_t)H * K;
  } else {
    b = blockIdx.z;
    h0 = 0;
    h1 = H;
    out = dlhs + (size_t)b * N * K;
    ld_out = (size_t)K;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 32 * warp + 8 * (lane >> 3), col0 = 4 * (lane & 7);
  const bool live = q0 + 32 * warp < N;
  const int per_head = (N + F_BK - 1) / F_BK;
  float acc[8][8] = {};
  qkr::ring<F_STAGES>(
      (h1 - h0) * per_head,
      [&](int c, int st) {
        const int h = h0 + c / per_head, m0 = (c % per_head) * F_BK;
        float* As = buf + st * STAGE;
        qkr::load_rows<float, F_BM, F_BK, F_THREADS>(
            As, F_LD, dsc + ((size_t)b * H + h) * N * ldp, ldp, q0, N, m0, N);
        qkr::load_rows<float, F_BK, F_BN, F_THREADS>(
            As + F_BM * F_LD, F_BN, rhs + (size_t)b * N * H * K + (size_t)h * K,
            (size_t)H * K, m0, N, c0, K);
      },
      [&](int st) {
        const float* As = buf + st * STAGE;
        if (live)
          qkr::fma_chunk<float, 8, 8, F_BK, false, true>(acc, As, F_LD, row0,
                                             As + F_BM * F_LD, F_BN, col0, 32);
      });
  store_tile(acc, out + c0 + (size_t)q0 * ld_out, ld_out, row0, N - q0, col0,
             K - c0);
}

// Pass B in bf16 on the tensor cores: out[m, c] = sum_n x[n, m] * y[n, c]
// for 64 keys m and 64 columns c, as qkr_bwd_cols_f32_kernel (column chunks
// [0, ceil(D/TD)) give dv, the rest drhs); x's rows (the scratch) are ldp
// apart.  A = x^T and B = y, both stored with the contraction down the
// rows: ldmatrix .trans for both.
__global__ void __launch_bounds__(THREADS) qkr_bwd_cols_tc_kernel(
    const bf16* __restrict__ pq, const bf16* __restrict__ dsc,
    const bf16* __restrict__ g, const bf16* __restrict__ lhs,
    int lhs_per_head, bf16* __restrict__ dv, bf16* __restrict__ drhs, int N,
    int H, int K, int D, int ldp) {
  __shared__ __align__(16) bf16 As[TC_K * LD_COL];
  __shared__ __align__(16) bf16 Bs[TC_K * LD_COL];
  const int m0 = blockIdx.x * TK;
  const int unit = blockIdx.z;
  const int b = unit / H;
  const int h = unit % H;
  const int nd = (D + TD - 1) / TD;

  const bf16* x;
  const bf16* y;
  size_t ldy, ld_out;
  int ncols, c0;
  bf16* out;
  if ((int)blockIdx.y < nd) {
    x = pq + (size_t)unit * N * ldp;
    y = g + (size_t)b * N * H * D + (size_t)h * D;
    ldy = (size_t)H * D;
    ncols = D;
    c0 = blockIdx.y * TD;
    out = dv + (size_t)b * N * H * D + (size_t)h * D;
    ld_out = (size_t)H * D;
  } else {
    const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
    x = dsc + (size_t)unit * N * ldp;
    y = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
    ldy = lhs_row;
    ncols = K;
    c0 = (blockIdx.y - nd) * TD;
    out = drhs + (size_t)b * N * H * K + (size_t)h * K;
    ld_out = (size_t)H * K;
  }

  const int warp = threadIdx.x / 32;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * 32;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += TC_K) {
    load_tile<TC_K, TK>(As, LD_COL, x, (size_t)ldp, n0, m0, N, N);
    load_tile<TC_K, TD>(Bs, LD_COL, y, ldy, n0, c0, N, ncols);
    __syncthreads();
    warp_mma<true, true>(acc, As, LD_COL, Bs, LD_COL, wr, wc);
    __syncthreads();
  }
  for_each_acc(acc, wr, wc, [&](int r, int c, float v) {
    const int m = m0 + r, cc = c0 + c;
    if (m < N && cc < ncols) out[(size_t)m * ld_out + cc] = __float2bfloat16_rn(v);
  });
}

// Pass C in bf16 on the tensor cores: dlhs[n, c] = sum_h sum_m
// dscores[b, h, n, m] * rhs[b, m, h, c], as qkr_bwd_dlhs_f32_kernel (a shared
// lhs sums h = 0..H-1 in fp32 in this block, then rounds once).  A =
// dscores stored [n][m] (ldmatrix), B = rhs stored [m][c] (.trans).
__global__ void __launch_bounds__(THREADS) qkr_bwd_dlhs_tc_kernel(
    const bf16* __restrict__ dsc, const bf16* __restrict__ rhs,
    int lhs_per_head, bf16* __restrict__ dlhs, int N, int H, int K,
    int ldp) {
  __shared__ __align__(16) bf16 As[TQ * LD_ROW];
  __shared__ __align__(16) bf16 Bs[TC_K * LD_COL];
  const int q0 = blockIdx.x * TQ;
  const int c0 = blockIdx.y * TD;
  int b, h0, h1;
  bf16* out;
  size_t ld_out;
  if (lhs_per_head) {
    b = blockIdx.z / H;
    h0 = blockIdx.z % H;
    h1 = h0 + 1;
    out = dlhs + (size_t)b * N * H * K + (size_t)h0 * K;
    ld_out = (size_t)H * K;
  } else {
    b = blockIdx.z;
    h0 = 0;
    h1 = H;
    out = dlhs + (size_t)b * N * K;
    ld_out = (size_t)K;
  }

  const int warp = threadIdx.x / 32;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * 32;
  float acc[4][4] = {};
  for (int h = h0; h < h1; ++h) {
    const bf16* x = dsc + ((size_t)b * H + h) * N * ldp;
    const bf16* y = rhs + (size_t)b * N * H * K + (size_t)h * K;
    for (int m0 = 0; m0 < N; m0 += TC_K) {
      load_tile<TQ, TC_K>(As, LD_ROW, x, (size_t)ldp, q0, m0, N, N);
      load_tile<TC_K, TD>(Bs, LD_COL, y, (size_t)H * K, m0, c0, N, K);
      __syncthreads();
      warp_mma<false, true>(acc, As, LD_ROW, Bs, LD_COL, wr, wc);
      __syncthreads();
    }
  }
  for_each_acc(acc, wr, wc, [&](int r, int c, float v) {
    const int n = q0 + r, cc = c0 + c;
    if (n < N && cc < K) out[(size_t)n * ld_out + cc] = __float2bfloat16_rn(v);
  });
}

// Pass D: ds[n] = sum over units (b, h) in order of the row partials.
__global__ void qkr_bwd_ds_kernel(const float* __restrict__ ds_part,
                                  float* __restrict__ ds, int units, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int u = 0; u < units; ++u) acc = __fadd_rn(acc, ds_part[(size_t)u * N + n]);
  ds[n] = acc;
}

// pass A's row stride of the score and dpq tiles: past N; in bf16 odd
// (PR 7's stride, which the dpq fragments' stores keep), in fp32 a
// multiple of 4 (16-byte rows; the register tiles' accesses run along a
// row)
template <typename T>
int rows_ld(int N) {
  return std::is_same<T, bf16>::value ? (N + 31) / 32 * 32 + 1
                                      : (N + 3) / 4 * 4;
}

// pass A's dynamic shared memory for N keys (see qkr_bwd_rows_tc_kernel,
// qkr_bwd_rows_f32_kernel)
template <typename T>
long long rows_smem_bytes(int N) {
  const long long ld_s = rows_ld<T>(N);
  // the score tile's ring, then half the rows of dpq with its own
  // (fp32: the row product's ring; bf16: the tensor cores' chunks)
  const long long scores = qkr::ring_bytes(TQ);
  const long long half =
      4LL * (TQ / 2) * ld_s + (std::is_same<T, bf16>::value
                                   ? 2LL * (TQ / 2 + DPQ_KEYS) * LD_ROW
                                   : (long long)qkr::ring_bytes(TQ / 2));
  return 4LL * TQ * ld_s + (half > scores ? half : scores);
}

// the scratch's row stride: N rounded up to 4 in fp32 and to 8 in bf16, so
// that every row starts 16-byte aligned for the passes' 16-byte copies
template <typename T>
int scratch_ld(int N) {
  return std::is_same<T, bf16>::value ? (N + 7) / 8 * 8 : (N + 3) / 4 * 4;
}

// Pass A's kernel for stream dtype T, with its dynamic shared memory at N
// keys set and the largest carveout, so that two blocks' shared memory fit
// an SM; nullptr where the runtime refuses, the error in *err.
template <typename T>
const void* prepare_rows(int N, cudaError_t* err) {
  const void* rows = std::is_same<T, bf16>::value
                         ? (const void*)qkr_bwd_rows_tc_kernel
                         : (const void*)qkr_bwd_rows_f32_kernel;
  *err = cudaFuncSetAttribute(rows,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)rows_smem_bytes<T>(N));
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(
        rows, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  return *err == cudaSuccess ? rows : nullptr;
}

template <typename T>
int launch_bwd(const T* lhs, int lhs_per_head, const T* rhs, const T* v,
               const float* s, const T* g, T* dlhs, T* drhs, T* dv, float* ds,
               T* pq_scratch, T* dsc_scratch, float* ds_part, int B, int N,
               int H, int K, int D, float thd_pos, float sm_scale,
               int quantize, void* stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  cudaStream_t strm = (cudaStream_t)stream;
  const int ld_s = rows_ld<T>(N);
  const int ldp = scratch_ld<T>(N);
  const size_t smem = (size_t)rows_smem_bytes<T>(N);
  cudaError_t err;
  if (prepare_rows<T>(N, &err) == nullptr) return (int)err;
  const int q_tiles = (N + TQ - 1) / TQ;
  const dim3 rows_grid(q_tiles, H, B);
  if constexpr (kBf16) {
    qkr_bwd_rows_tc_kernel<<<rows_grid, THREADS, smem, strm>>>(
        lhs, lhs_per_head, rhs, v, s, g, pq_scratch, dsc_scratch, ds_part, N,
        H, K, D, ld_s, ldp, thd_pos, sm_scale, quantize);
  } else {
    qkr_bwd_rows_f32_kernel<<<rows_grid, THREADS, smem, strm>>>(
        lhs, lhs_per_head, rhs, v, s, g, pq_scratch, dsc_scratch, ds_part, N,
        H, K, D, ld_s, ldp, thd_pos, sm_scale, quantize);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nd = (D + TD - 1) / TD;
  const int nk = (K + TD - 1) / TD;
  const int units = lhs_per_head ? B * H : B;
  if constexpr (kBf16) {
    qkr_bwd_cols_tc_kernel<<<dim3((N + TK - 1) / TK, nd + nk, B * H),
                             THREADS, 0, strm>>>(
        pq_scratch, dsc_scratch, g, lhs, lhs_per_head, dv, drhs, N, H, K, D,
        ldp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qkr_bwd_dlhs_tc_kernel<<<dim3(q_tiles, nk, units), THREADS, 0, strm>>>(
        dsc_scratch, rhs, lhs_per_head, dlhs, N, H, K, ldp);
  } else {
    const int f_tiles = (N + F_BM - 1) / F_BM;
    qkr_bwd_cols_f32_kernel<<<dim3(f_tiles, nd + nk, B * H), F_THREADS, 0,
                              strm>>>(pq_scratch, dsc_scratch, g, lhs,
                                      lhs_per_head, dv, drhs, N, H, K, D,
                                      ldp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qkr_bwd_dlhs_f32_kernel<<<dim3(f_tiles, nk, units), F_THREADS, 0,
                              strm>>>(dsc_scratch, rhs, lhs_per_head, dlhs, N,
                                      H, K, ldp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qkr_bwd_ds_kernel<<<(N + 255) / 256, 256, 0, strm>>>(ds_part, ds, B * H, N);
  return (int)cudaGetLastError();
}

}  // namespace

// How K3 launches pass A for N keys in a stream dtype (is_bf16 != 0 for
// bf16): returns its dynamic shared memory in bytes, which the wrapper
// checks against the card's per-block limit, and writes the scratch's row
// stride (the wrapper allocates B*H*N rows of it for each of pq and
// dscores), the stages of pass A's score ring and the blocks of pass A that one SM holds (the CUDA runtime's
// occupancy: shared memory, threads and registers; 0 where the kernel
// cannot take that shared memory).
extern "C" long long ofq_qkr_attention_bwd_launch(int N, int is_bf16,
                                                  int* ldp, int* stages,
                                                  int* blocks) {
  const long long smem =
      is_bf16 ? rows_smem_bytes<bf16>(N) : rows_smem_bytes<float>(N);
  *ldp = is_bf16 ? scratch_ld<bf16>(N) : scratch_ld<float>(N);
  *stages = A_STAGES;
  cudaError_t err;
  const void* rows =
      is_bf16 ? prepare_rows<bf16>(N, &err) : prepare_rows<float>(N, &err);
  if (rows != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, rows, THREADS,
                                                        (size_t)smem);
  if (err != cudaSuccess) {
    *blocks = 0;
    cudaGetLastError();  // a refused query leaves no error for the launches
  }
  return smem;
}

// pq_scratch and dsc_scratch hold B*H*N*ldp elements of the stream dtype
// each (ldp from ofq_qkr_attention_bwd_launch), ds_part B*H*N floats; all allocated by the caller.  Returns the
// first CUDA error of the launches.
extern "C" int ofq_qkr_attention_bwd(
    const float* lhs, int lhs_per_head, const float* rhs, const float* v,
    const float* s, const float* g, float* dlhs, float* drhs, float* dv,
    float* ds, float* pq_scratch, float* dsc_scratch, float* ds_part, int B,
    int N, int H, int K, int D, float thd_pos, float sm_scale, int quantize,
    void* stream) {
  return launch_bwd<float>(lhs, lhs_per_head, rhs, v, s, g, dlhs, drhs, dv,
                           ds, pq_scratch, dsc_scratch, ds_part, B, N, H, K,
                           D, thd_pos, sm_scale, quantize, stream);
}

// The bf16 stream: lhs, rhs, v, g, the cotangents and the scratch bf16; s,
// ds and ds_part fp32.  The scratch holds B*H*N*ldp elements each, ldp = N
// rounded up to 8 (ofq_qkr_attention_bwd_launch).
extern "C" int ofq_qkr_attention_bwd_bf16(
    const __nv_bfloat16* lhs, int lhs_per_head, const __nv_bfloat16* rhs,
    const __nv_bfloat16* v, const float* s, const __nv_bfloat16* g,
    __nv_bfloat16* dlhs, __nv_bfloat16* drhs, __nv_bfloat16* dv, float* ds,
    __nv_bfloat16* pq_scratch, __nv_bfloat16* dsc_scratch, float* ds_part,
    int B, int N, int H, int K, int D, float thd_pos, float sm_scale,
    int quantize, void* stream) {
  return launch_bwd<__nv_bfloat16>(lhs, lhs_per_head, rhs, v, s, g, dlhs,
                                   drhs, dv, ds, pq_scratch, dsc_scratch,
                                   ds_part, B, N, H, K, D, thd_pos, sm_scale,
                                   quantize, stream);
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
