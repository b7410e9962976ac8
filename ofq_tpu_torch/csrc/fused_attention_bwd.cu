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
//      K2: the score tile (64 x N, ~66 KB of shared memory at N = 198) is
//      formed with K2's loop, so p is the forward's p bit for bit, and the
//      dpq tile beside it (fp32: 64 x N with the same loop; bf16: 32 x N
//      at a time on the tensor cores, so that pass A takes ~97 KB and two
//      blocks share an SM); one warp per row then forms p, pq, dp, the
//      row's ds partial (written per (b, h, n), no atomics) and dscores, and
//      writes pq and dscores to scratch, (B, H, N, ldp) each in the stream
//      dtype;
//   B  one block per (64 keys, 64 output columns, (b, h)): dv = pq^T . g and
//      drhs = dscores^T . lhs;
//   C  one block per (64 query rows, 64 columns, b or (b, h)): dlhs =
//      dscores . rhs, the heads of a shared lhs summed in the block in
//      order h = 0..H-1;
//   D  ds[n] = sum over (b, h) of the partials, in a fixed order.
// In fp32 every product is a shared-memory tiled loop on the CUDA cores,
// 4 x 4 outputs per thread.  In bf16 pass A's dpq = g . v^T and passes B
// and C run on the tensor cores (see below); pass A's score tile stays
// K2's loop in both.  Runs are repeatable (no float atomics).
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
// (rows_smem_bytes).
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
// they load in 16-byte chunks.  Pass A's score tile stays K2-bf16's loop
// (tile_nt), so the backward's p is the forward's p bit for bit; it moves
// to the tensor cores together with K2-bf16's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TQ = 64;       // query rows per block (passes A and C)
constexpr int TK = 64;       // keys per tile
constexpr int KC = 32;       // contraction chunk
constexpr int TD = 64;       // output columns per block (passes B and C)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// loads widen to fp32, stores round to the stream dtype (nearest-even)
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// out[r * ld_o + m] = fp32(sum_k a[n, k] * b[m, k]) * scale for the TQ rows
// n = q0 + r of this block and every m < N; a's rows are a_ld apart, b's
// b_ld.  The loop order is K2's phase 1, so the score tile equals the
// forward kernel's bit for bit.
template <typename T>
__device__ __forceinline__ void tile_nt(const T* __restrict__ a, size_t a_ld,
                                        const T* __restrict__ b,
                                        size_t b_ld, int q0, int N, int kdim,
                                        float scale, float* out, int ld_o,
                                        float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_key_tiles = (N + TK - 1) / TK;
  for (int kt = 0; kt < n_key_tiles; ++kt) {
    const int m0 = kt * TK;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < kdim; k0 += KC) {
      for (int e = tid; e < TQ * KC; e += THREADS) {
        const int r = e / KC;
        const int kk = e % KC;
        const int n = q0 + r;
        const int k = k0 + kk;
        As[kk * (TQ + 1) + r] = (n < N && k < kdim) ? ld(a + (size_t)n * a_ld + k) : 0.0f;
      }
      for (int e = tid; e < TK * KC; e += THREADS) {
        const int c = e / KC;
        const int kk = e % KC;
        const int m = m0 + c;
        const int k = k0 + kk;
        Bs[kk * (TK + 1) + c] = (m < N && k < kdim) ? ld(b + (size_t)m * b_ld + k) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk * (TQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * (TK + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tx + 16 * j;
        if (m < N) out[(ty + 16 * i) * ld_o + m] = __fmul_rn(acc[i][j], scale);
      }
  }
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16, fp32 sums)
using bf16 = __nv_bfloat16;
constexpr int TC_K = 32;       // contraction chunk
constexpr int LD_ROW = 40;     // a [rows][32] chunk's row stride (80 B)
constexpr int LD_COL = 72;     // a [32][64] chunk's row stride (144 B)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// Pass A: per (query tile, head, batch row).
template <typename T>
__global__ void __launch_bounds__(THREADS) qkr_bwd_rows_kernel(
    const T* __restrict__ lhs, int lhs_per_head, const T* __restrict__ rhs,
    const T* __restrict__ v, const float* __restrict__ s,
    const T* __restrict__ g, T* __restrict__ pq_out, T* __restrict__ dsc_out,
    float* __restrict__ ds_part, int N, int H, int K, int D, int ld_s,
    int ldp, float thd_pos, float sm_scale, int quantize) {
  constexpr bool kTC = std::is_same<T, bf16>::value;
  extern __shared__ float smem[];
  // fp32: S, then P [TQ][ld_s] (dpq, then dp), then As, Bs.  bf16: S,
  // then one region that holds As, Bs while the scores form and then P
  // for half the rows (dpq, then dp) with dpq's bf16 chunks after it
  // (rows_smem_bytes)
  float* S = smem;                  // [TQ][ld_s] scores, then p
  float* P = S + TQ * ld_s;
  float* As = kTC ? P : P + TQ * ld_s;  // [KC][TQ + 1]
  float* Bs = As + KC * (TQ + 1);       // [KC][TK + 1]

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
  const T* lhs_b = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
  const T* rhs_b = rhs + (size_t)b * N * H * K + (size_t)h * K;
  const T* v_b = v + (size_t)b * N * H * D + (size_t)h * D;
  const T* g_b = g + (size_t)b * N * H * D + (size_t)h * D;

  tile_nt(lhs_b, lhs_row, rhs_b, (size_t)H * K, q0, N, K, sm_scale, S, ld_s, As, Bs);

  const size_t unit = (size_t)b * H + h;
  T* pq_u = pq_out + unit * N * ldp;
  T* dsc_u = dsc_out + unit * N * ldp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // row r of the tile, its dpq in drow: p, pq, dp, the row's ds partial
  // and dscores, one warp per row
  auto row_work = [&](int r, float* drow) {
    const int n = q0 + r;
    float* row = S + r * ld_s;
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
    if (lane == 0) ds_part[unit * N + n] = ds_acc;
  };

  if constexpr (kTC) {
    // dpq on the tensor cores, half the rows at a time into P: the
    // smaller shared memory lets two blocks share an SM
    bf16* ga = reinterpret_cast<bf16*>(P + (TQ / 2) * ld_s);
    bf16* vb = ga + (TQ / 2) * LD_ROW;
    for (int r0 = 0; r0 < TQ; r0 += TQ / 2) {
      dpq_tc(g_b, v_b, (size_t)H * D, q0 + r0, N, D, P, ld_s, ga, vb);
      __syncthreads();
      for (int r = r0 + warp; r < r0 + TQ / 2; r += WARPS)
        if (q0 + r < N) row_work(r, P + (r - r0) * ld_s);
      __syncthreads();
    }
  } else {
    tile_nt(g_b, (size_t)H * D, v_b, (size_t)H * D, q0, N, D, 1.0f, P, ld_s, As, Bs);
    __syncthreads();
    for (int r = warp; r < TQ; r += WARPS)
      if (q0 + r < N) row_work(r, P + r * ld_s);
  }
}

// Pass B: out[m, c] = sum_n x[n, m] * y[n, c] for 64 keys m and 64 columns
// c; column chunks [0, ceil(D/TD)) give dv (x = pq, y = g), the rest drhs
// (x = dscores, y = lhs).
template <typename T>
__global__ void __launch_bounds__(THREADS) qkr_bwd_cols_kernel(
    const T* __restrict__ pq, const T* __restrict__ dsc,
    const T* __restrict__ g, const T* __restrict__ lhs, int lhs_per_head,
    T* __restrict__ dv, T* __restrict__ drhs, int N, int H, int K, int D) {
  __shared__ float As[KC * (TK + 1)];
  __shared__ float Bs[KC * TD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TK;
  const int unit = blockIdx.z;
  const int b = unit / H;
  const int h = unit % H;
  const int nd = (D + TD - 1) / TD;

  const T* x;
  const T* y;
  size_t ldy, ld_out;
  int ncols, c0;
  T* out;
  if ((int)blockIdx.y < nd) {
    x = pq + (size_t)unit * N * N;
    y = g + (size_t)b * N * H * D + (size_t)h * D;
    ldy = (size_t)H * D;
    ncols = D;
    c0 = blockIdx.y * TD;
    out = dv + (size_t)b * N * H * D + (size_t)h * D;
    ld_out = (size_t)H * D;
  } else {
    const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
    x = dsc + (size_t)unit * N * N;
    y = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
    ldy = lhs_row;
    ncols = K;
    c0 = (blockIdx.y - nd) * TD;
    out = drhs + (size_t)b * N * H * K + (size_t)h * K;
    ld_out = (size_t)H * K;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int e = tid; e < KC * TK; e += THREADS) {
      const int nn = e / TK;
      const int mm = e % TK;
      const int n = n0 + nn;
      const int m = m0 + mm;
      As[nn * (TK + 1) + mm] = (n < N && m < N) ? ld(x + (size_t)n * N + m) : 0.0f;
    }
    for (int e = tid; e < KC * TD; e += THREADS) {
      const int nn = e / TD;
      const int cc = e % TD;
      const int n = n0 + nn;
      const int c = c0 + cc;
      Bs[nn * TD + cc] = (n < N && c < ncols) ? ld(y + (size_t)n * ldy + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < KC; ++nn) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[nn * (TK + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[nn * TD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < ncols) st(out + (size_t)m * ld_out + c, acc[i][j]);
    }
  }
}

// Pass C: dlhs[n, c] = sum_h sum_m dscores[b, h, n, m] * rhs[b, m, h, c] for
// 64 query rows and 64 columns; a shared lhs sums h = 0..H-1 in this block,
// a per-head lhs takes one head per block.
template <typename T>
__global__ void __launch_bounds__(THREADS) qkr_bwd_dlhs_kernel(
    const T* __restrict__ dsc, const T* __restrict__ rhs, int lhs_per_head,
    T* __restrict__ dlhs, int N, int H, int K) {
  __shared__ float As[KC * (TQ + 1)];
  __shared__ float Bs[KC * TD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * TQ;
  const int c0 = blockIdx.y * TD;
  int b, h0, h1;
  T* out;
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

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int h = h0; h < h1; ++h) {
    const T* x = dsc + ((size_t)b * H + h) * N * N;
    const T* y = rhs + (size_t)b * N * H * K + (size_t)h * K;
    for (int m0 = 0; m0 < N; m0 += KC) {
      for (int e = tid; e < TQ * KC; e += THREADS) {
        const int r = e / KC;
        const int kk = e % KC;
        const int n = q0 + r;
        const int m = m0 + kk;
        As[kk * (TQ + 1) + r] = (n < N && m < N) ? ld(x + (size_t)n * N + m) : 0.0f;
      }
      for (int e = tid; e < KC * TD; e += THREADS) {
        const int kk = e / TD;
        const int cc = e % TD;
        const int m = m0 + kk;
        const int c = c0 + cc;
        Bs[kk * TD + cc] = (m < N && c < K) ? ld(y + (size_t)m * H * K + c) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk * (TQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * TD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < K) st(out + (size_t)n * ld_out + c, acc[i][j]);
    }
  }
}

// Pass B in bf16 on the tensor cores: out[m, c] = sum_n x[n, m] * y[n, c]
// for 64 keys m and 64 columns c, as qkr_bwd_cols_kernel (column chunks
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
// dscores[b, h, n, m] * rhs[b, m, h, c], as qkr_bwd_dlhs_kernel (a shared
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

// pass A's row stride of the score and dpq tiles: past N, odd (their
// column accesses miss bank conflicts); fp32 keeps its first form
template <typename T>
int rows_ld(int N) {
  return std::is_same<T, bf16>::value ? (N + 31) / 32 * 32 + 1
                                      : ((N + TK - 1) / TK) * TK + 1;
}

// pass A's dynamic shared memory for N keys (see qkr_bwd_rows_kernel)
template <typename T>
long long rows_smem_bytes(int N) {
  const long long ld_s = rows_ld<T>(N);
  const long long tiles = 4LL * (KC * (TQ + 1) + KC * (TK + 1));
  if (!std::is_same<T, bf16>::value)
    return 4LL * 2 * TQ * ld_s + tiles;
  const long long half = 4LL * (TQ / 2) * ld_s +
                         2LL * (TQ / 2 + DPQ_KEYS) * LD_ROW;
  return 4LL * TQ * ld_s + (half > tiles ? half : tiles);
}

long long bwd_smem_bytes(int N) {
  const long long f = rows_smem_bytes<float>(N), h = rows_smem_bytes<bf16>(N);
  return f > h ? f : h;
}

// the scratch's row stride: N in fp32 (the CUDA-core passes read rows N
// apart), N rounded up to 8 in bf16 (16-byte rows for the tensor-core
// passes' loads)
template <typename T>
int scratch_ld(int N) {
  return std::is_same<T, bf16>::value ? (N + 7) / 8 * 8 : N;
}

template <typename T>
int launch_bwd(const T* lhs, int lhs_per_head, const T* rhs, const T* v,
               const float* s, const T* g, T* dlhs, T* drhs, T* dv, float* ds,
               T* pq_scratch, T* dsc_scratch, float* ds_part, int B, int N,
               int H, int K, int D, float thd_pos, float sm_scale,
               int quantize, void* stream) {
  cudaStream_t strm = (cudaStream_t)stream;
  const int ld_s = rows_ld<T>(N);
  const int ldp = scratch_ld<T>(N);
  const size_t smem = (size_t)rows_smem_bytes<T>(N);
  cudaError_t err = cudaFuncSetAttribute(
      qkr_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (N + TQ - 1) / TQ;
  qkr_bwd_rows_kernel<T><<<dim3(q_tiles, H, B), THREADS, smem, strm>>>(
      lhs, lhs_per_head, rhs, v, s, g, pq_scratch, dsc_scratch, ds_part, N, H,
      K, D, ld_s, ldp, thd_pos, sm_scale, quantize);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nd = (D + TD - 1) / TD;
  const int nk = (K + TD - 1) / TD;
  const dim3 cols_grid((N + TK - 1) / TK, nd + nk, B * H);
  const dim3 dlhs_grid(q_tiles, nk, lhs_per_head ? B * H : B);
  if constexpr (std::is_same<T, bf16>::value) {
    qkr_bwd_cols_tc_kernel<<<cols_grid, THREADS, 0, strm>>>(
        pq_scratch, dsc_scratch, g, lhs, lhs_per_head, dv, drhs, N, H, K, D,
        ldp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qkr_bwd_dlhs_tc_kernel<<<dlhs_grid, THREADS, 0, strm>>>(
        dsc_scratch, rhs, lhs_per_head, dlhs, N, H, K, ldp);
  } else {
    qkr_bwd_cols_kernel<T><<<cols_grid, THREADS, 0, strm>>>(
        pq_scratch, dsc_scratch, g, lhs, lhs_per_head, dv, drhs, N, H, K, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qkr_bwd_dlhs_kernel<T><<<dlhs_grid, THREADS, 0, strm>>>(
        dsc_scratch, rhs, lhs_per_head, dlhs, N, H, K);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qkr_bwd_ds_kernel<<<(N + 255) / 256, 256, 0, strm>>>(ds_part, ds, B * H, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory pass A needs for N keys (bytes), in either stream
// dtype; the wrapper checks it against the card's per-block limit before
// launching.
extern "C" long long ofq_qkr_attention_bwd_smem_bytes(int N) {
  return bwd_smem_bytes(N);
}

// The row stride of the scratch in the stream dtype (is_bf16 != 0 for
// bf16): the wrapper allocates B*H*N rows of it.
extern "C" int ofq_qkr_attention_bwd_scratch_ld(int N, int is_bf16) {
  return is_bf16 ? scratch_ld<__nv_bfloat16>(N) : scratch_ld<float>(N);
}

// pq_scratch and dsc_scratch hold B*H*N*N elements of the stream dtype
// each, ds_part B*H*N floats; all allocated by the caller.  Returns the
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
// rounded up to 8 (ofq_qkr_attention_bwd_scratch_ld).
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
