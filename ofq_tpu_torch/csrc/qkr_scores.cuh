// The score tile of the fused QKR attention core, one device function for
// K2 (fused_attention.cu) and K3's pass A (fused_attention_bwd.cu), so that
// the backward's p is the forward's bit for bit, as the JAX kernels
// recompute the scores with one function (`_unit_scores`,
// ofq_tpu/ops/fused_attention.py:71, called by `_fwd_kernel` and
// `_bwd_kernel`).
//
//   S[r, m] = fp32(sum_k a[q0 + r, k] b[m, k]) * sm_scale
//
// for the 64 query rows of a block and every key m < N.  On the CUDA
// cores, register-tiled: a 256-thread block, each warp 8 query rows
// against the keys lane + 32 j (j < 7, 224 keys a sweep); each score is one
// __fmaf_rn chain in ascending k from 0, then __fmul_rn by sm_scale, in
// both stream dtypes (a bf16 operand is widened exactly as it is read, so
// its products are exact).  The operands reach shared memory in their
// stream dtype through a ring of A_STAGES cp.async stages of 32-byte row
// chunks (8 fp32 or 16 bf16 of k), 16-byte copies where a row's chunk
// part is whole and aligned, smaller ones (or zeros past N and K) where
// not; rows 48 bytes apart, so that a warp's 16-byte (fp32) or 8-byte
// (bf16) reads of one k4 step spread over the banks.
//
// The same ring and the row product serve K3 fp32's dpq (g v^T), and the
// column chunks of K2's pq v (`pq_v`): each output one __fmaf_rn chain in
// ascending key from 0.  K4 and K5 (pallas_statsq.cu) run their product
// on the ring, the row loads and fma_chunk too (a in the stream dtype,
// B = Q(W) in fp32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace qkr {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;       // the block of K2 and K3's pass A
constexpr int WARPS = THREADS / 32;
constexpr int TQ = 64;             // query rows per block
constexpr int A_STAGES = 3;        // ring stages of the row products
constexpr int A_TN = 7;            // keys per thread: lane + 32 j, j < 7
constexpr int A_KEYS = 32 * A_TN;  // keys per sweep
constexpr int CHUNK_BYTES = 32;    // a row's part of one chunk
constexpr int ROW_BYTES = 48;      // a chunk row's stride (16 bytes padding)
constexpr int PV_KEYS = 16;        // pq v: keys per chunk
constexpr int PV_COLS = 64;        //   output columns per pass

// a chunk's depth and row stride, in elements of the stream dtype
template <typename T>
__host__ __device__ constexpr int chunk_k() { return CHUNK_BYTES / sizeof(T); }
template <typename T>
__host__ __device__ constexpr int chunk_ld() { return ROW_BYTES / sizeof(T); }

// the ring's bytes for AR query rows against a sweep of keys (either dtype)
__host__ __device__ constexpr int ring_bytes(int rows) {
  return A_STAGES * (rows + A_KEYS) * ROW_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.0f); }

// one element of the stream dtype copied to shared memory: fp32 by a
// 4-byte cp.async, bf16 (no 2-byte cp.async) by a plain load and store,
// visible to the block after the ring's barrier
__device__ __forceinline__ void copy1(float* d, const float* p) {
  cp_async4(d, p);
}
__device__ __forceinline__ void copy1(bf16* d, const bf16* p) { *d = *p; }

// R x C elements of a row-major matrix whose rows are ld apart, from (r0,
// c0), into dst (rows lds apart), by NT threads: a 16-byte cp.async where
// a row's 16 bytes are whole and aligned, element copies where they are
// not whole or not aligned, zero at rows >= rlim and columns >= clim.
template <typename T, int R, int C, int NT>
__device__ __forceinline__ void load_rows(T* dst, int lds,
                                          const T* __restrict__ src,
                                          size_t ld, int r0, int rlim, int c0,
                                          int clim) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte copy
  constexpr int CH = C / V;
  for (int e = threadIdx.x; e < R * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * lds + c;
    if (gr >= rlim || gc >= clim) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* p = src + (size_t)gr * ld + gc;
    if (gc + V <= clim && ((uintptr_t)p & 15) == 0) {
      cp_async16(d, p);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (gc + j < clim) copy1(d + j, p + j);
        else d[j] = zero<T>();
      }
    }
  }
}

// The chunks 0..chunks-1 of a contraction through a ring of STAGES
// buffers: load(c, stage) issues chunk c's copies, compute(stage) applies
// a landed chunk; the copies of the next STAGES - 1 chunks are in flight
// while one is applied.  Ends with every buffer free.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void ring(int chunks, Load load, Compute compute) {
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    // chunk c visible to all; every thread done with chunk c - 1's stage
    __syncthreads();
    const int next = c + STAGES - 1;
    if (next < chunks) load(next, next % STAGES);
    cp_async_commit();
    compute(c % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// four consecutive elements at p (16-byte aligned in fp32, 8-byte in
// bf16), widened exactly to fp32
__device__ __forceinline__ void read4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}
__device__ __forceinline__ void read4(const bf16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(t.x << 16), x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16), x[3] = __uint_as_float(t.y & 0xffff0000u);
}

// acc[i][j] += a(row i) b(column j) over one chunk of BK contraction
// steps, in ascending order, one __fmaf_rn each.  This thread's rows are
// ar0 + i (i < TM).  A_KM: the chunk of A is stored [k][row] (lda apart),
// else [row][k].  B_KM: B stored [k][col] and this thread's columns are
// bc0 + 0..3, bc0 + b_next + 0..3; else [col][k] and columns bc0 + b_next
// * j (j < TN).  T (TB): A's (B's) element type, widened as it is read.
template <typename T, int TM, int TN, int BK, bool A_KM, bool B_KM,
          typename TB = T>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][TN], const T* As,
                                          int lda, int ar0, const TB* Bs,
                                          int ldb, int bc0, int b_next) {
  static_assert(!B_KM || TN == 8, "a K-major B gives two 4-wide columns");
  static_assert(!A_KM || B_KM, "no product takes a K-major A alone");
#pragma unroll
  for (int k4 = 0; k4 < BK; k4 += 4) {
    float a[4][TM];
    if constexpr (!A_KM) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float t[4];
        read4(As + (ar0 + i) * lda + k4, t);
        a[0][i] = t[0], a[1][i] = t[1], a[2][i] = t[2], a[3][i] = t[3];
      }
    }
    if constexpr (B_KM) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (A_KM) {
#pragma unroll
          for (int i = 0; i < TM; i += 4) {
            float t[4];
            read4(As + (k4 + kk) * lda + ar0 + i, t);
            a[kk][i] = t[0], a[kk][i + 1] = t[1], a[kk][i + 2] = t[2],
            a[kk][i + 3] = t[3];
          }
        }
        const TB* brow = Bs + (k4 + kk) * ldb + bc0;
        float lo[4], hi[4];
        read4(brow, lo);
        read4(brow + b_next, hi);
        const float b[8] = {lo[0], lo[1], lo[2], lo[3],
                            hi[0], hi[1], hi[2], hi[3]};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(a[kk][i], b[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float b[4];
        read4(Bs + (bc0 + b_next * j) * ldb + k4, b);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i)
            acc[i][j] = __fmaf_rn(a[kk][i], b[kk], acc[i][j]);
      }
    }
  }
}

// acc[i][j] = sum_k a[n, k] b[m, k] over k < kdim for this warp's rows n =
// r0 + TM * warp + i and the keys m = m0 + lane + 32 j, a's rows a_ld apart
// and b's b_ld, both zero past N; through a ring of A_STAGES chunks at
// `buf` (ring_bytes(TM * WARPS) bytes, 16-byte aligned).  A warp whose rows
// all lie past N skips the FMAs (the last query tile).
template <typename T, int TM>
__device__ __forceinline__ void rows_product(float (&acc)[TM][A_TN],
                                             const T* __restrict__ a,
                                             size_t a_ld, int r0,
                                             const T* __restrict__ b,
                                             size_t b_ld, int m0, int N,
                                             int kdim, T* buf) {
  constexpr int AR = TM * WARPS;
  constexpr int BK = chunk_k<T>(), LD = chunk_ld<T>();
  constexpr int STAGE = (AR + A_KEYS) * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = r0 + TM * warp < N;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < A_TN; ++j) acc[i][j] = 0.0f;
  ring<A_STAGES>(
      (kdim + BK - 1) / BK,
      [&](int c, int st) {
        T* As = buf + st * STAGE;
        load_rows<T, AR, BK, THREADS>(As, LD, a, a_ld, r0, N, c * BK, kdim);
        load_rows<T, A_KEYS, BK, THREADS>(As + AR * LD, LD, b, b_ld, m0, N,
                                          c * BK, kdim);
      },
      [&](int st) {
        const T* As = buf + st * STAGE;
        if (live)
          fma_chunk<T, TM, A_TN, BK, false, false>(
              acc, As, LD, TM * warp, As + AR * LD, LD, lane, 32);
      });
}

// The score tile: S[r * ld_s + m] = fp32(sum_k a[q0 + r, k] b[m, k]) *
// sm_scale for r < TQ and m < N, a's rows a_ld apart and b's b_ld; `buf`:
// the ring (ring_bytes(TQ)).  S is written after the ring's last barrier:
// the caller synchronizes before reading another warp's rows.
template <typename T>
__device__ __forceinline__ void score_tile(float* S, int ld_s,
                                           const T* __restrict__ a,
                                           size_t a_ld, int q0,
                                           const T* __restrict__ b,
                                           size_t b_ld, int N, int kdim,
                                           float sm_scale, T* buf) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m0 = 0; m0 < N; m0 += A_KEYS) {
    float acc[TQ / WARPS][A_TN];
    rows_product<T, TQ / WARPS>(acc, a, a_ld, q0, b, b_ld, m0, N, kdim, buf);
#pragma unroll
    for (int j = 0; j < A_TN; ++j) {
      const int m = m0 + lane + 32 * j;
      if (m < N) {
#pragma unroll
        for (int i = 0; i < TQ / WARPS; ++i)
          S[(TQ / WARPS * warp + i) * ld_s + m] =
              __fmul_rn(acc[i][j], sm_scale);
      }
    }
  }
}

// stores round to the stream dtype (nearest-even)
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// two consecutive elements at p (8-byte aligned in fp32, 4-byte in bf16),
// widened exactly to fp32
__device__ __forceinline__ void read2(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x, x[1] = t.y;
}
__device__ __forceinline__ void read2(const bf16* p, float (&x)[2]) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
  x[0] = __uint_as_float(t << 16), x[1] = __uint_as_float(t & 0xffff0000u);
}

// K2's pq v: out[(q0 + r) * out_ld + d] = fp32(sum_m P[r * ld_p + m] v[m,
// d]) for r < TQ, q0 + r < N, and d < D, rounded to T once; P (fp32, its
// rows 16-byte aligned) holds pq, zero at keys N .. N rounded up to
// PV_KEYS.  Each warp takes 8 rows, each lane the columns 2 lane, 2 lane +
// 1 of a 64-column pass; v's chunks of PV_KEYS keys come through a ring at
// `buf` (A_STAGES * PV_KEYS * PV_COLS elements, 16-byte aligned); each
// output is one __fmaf_rn chain in ascending m from 0.
template <typename T>
__device__ __forceinline__ void pq_v(const float* P, int ld_p,
                                     const T* __restrict__ v, size_t v_ld,
                                     int q0, int N, int D, T* out,
                                     size_t out_ld, T* buf) {
  constexpr int TM = TQ / WARPS;
  constexpr int STAGE = PV_KEYS * PV_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = TM * warp;
  const bool live = q0 + r0 < N;
  for (int d0 = 0; d0 < D; d0 += PV_COLS) {
    float acc[TM][2];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = 0.0f;
    int chunk = 0;  // the chunk compute() applies, in order
    ring<A_STAGES>(
        (N + PV_KEYS - 1) / PV_KEYS,
        [&](int c, int st) {
          load_rows<T, PV_KEYS, PV_COLS, THREADS>(buf + st * STAGE, PV_COLS,
                                                  v, v_ld, c * PV_KEYS, N, d0,
                                                  D);
        },
        [&](int st) {
          const int m0 = PV_KEYS * chunk++;
          if (!live) return;
          const T* Vs = buf + st * STAGE + 2 * lane;
#pragma unroll
          for (int k4 = 0; k4 < PV_KEYS; k4 += 4) {
            float a[4][TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              float t[4];
              read4(P + (r0 + i) * ld_p + m0 + k4, t);
              a[0][i] = t[0], a[1][i] = t[1], a[2][i] = t[2], a[3][i] = t[3];
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float b[2];
              read2(Vs + (k4 + kk) * PV_COLS, b);
#pragma unroll
              for (int i = 0; i < TM; ++i) {
                acc[i][0] = __fmaf_rn(a[kk][i], b[0], acc[i][0]);
                acc[i][1] = __fmaf_rn(a[kk][i], b[1], acc[i][1]);
              }
            }
          }
        });
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int n = q0 + r0 + i;
      if (n >= N) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = d0 + 2 * lane + j;
        if (d < D) st(out + (size_t)n * out_ld + d, acc[i][j]);
      }
    }
  }
}

}  // namespace qkr
