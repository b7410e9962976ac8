// StatsQ weight-quantized matmul: forward (K4) and the dx product (K5).
//
// Replaces the Pallas kernels of ofq_tpu/ops/pallas_statsq.py:
//   K4  _fwd_kernel (called by _fwd_call, reached through
//       pallas_statsq_matmul, i.e. QLinear with matmul_impl='pallas'):
//         y[m, n]  = sum_k x[m, k] * Q(W)[k, n]
//   K5  _dx_kernel (called by _dx_call):
//         dx[m, k] = sum_n g[m, n] * Q(W)[k, n]
// with the StatsQ mid-rise level set of _quant_tile,
//   Q(W)[k, n] = s[n] * ((rint(clip(W[k, n] / s[n], -1, 1 - 1e-6) * nl - 0.5)
//                         + 0.5) / nl),
// and s = 2 mean|W| per output column, computed by the caller (as in JAX).
// W tiles are quantized in fp32 on their way into shared memory, so Q(W)
// never reaches device memory.  x, g and the output are float or bf16
// (template T): a bf16 input widens exactly to fp32, every product and sum
// is fp32 (CUDA-core FMAs, no TF32, no tensor cores), and the output is
// rounded once (__float2bfloat16_rn for bf16).
//
// What bounds it on an H100: at DeiT-S widths (M = 64*198, K, N in
// {384, 1536}) the work is 2*M*K*N operations against ~esize*(MK + MN)
// + 4*KN bytes.  In the bf16 stream x and the odd level codes are exact in
// bf16, so the tensor cores could run the same product: the bound is then
// bytes (~0.006 ms for proj, ~0.015 ms for fc1/fc2).  In the fp32 stream the
// bound is the fp32 rate (~0.06-0.22 ms).  This first version is a plain
// shared-memory tiled product like K1 (one 64x64 output tile per 256-thread
// block, 4x4 outputs per thread, 32-deep contraction chunks), far from
// either bound; wgmma on bf16 tiles is the next step for speed.
//
// Rounding: rintf rounds half to even like torch.round / jnp.round, and
// StatsQ's c*nl - 0.5 sits on a tie whenever c*nl is integral, so every
// multiply/add/divide whose rounding feeds rint, or that forms Q(W), is
// spelled with the __f*_rn intrinsics (no FMA contraction); IEEE division
// (no --use_fast_math).  Ragged edges (M = 12 672 is no multiple of 64) are
// guarded in the kernel: loads outside the matrix read 0, stores are
// skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BC = 32;       // contraction chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// _quant_tile on one element, in the order of the JAX expression
__device__ __forceinline__ float quant(float w, float s, float nl) {
  const float hi = 1.0f - 1e-6f;
  const float c = fminf(fmaxf(__fdiv_rn(w, s), -1.0f), hi);
  const float lv = rintf(__fsub_rn(__fmul_rn(c, nl), 0.5f));
  return __fmul_rn(s, __fdiv_rn(__fadd_rn(lv, 0.5f), nl));
}

// the 64x64 tile product over one chunk: acc[i][j] += a[kk][ty+16i] *
// b[kk][tx+16j]
__device__ __forceinline__ void tile_fma(const float (*as)[BM + 1],
                                         const float (*bs)[BN + 1],
                                         float (&acc)[4][4], int tx, int ty) {
#pragma unroll 8
  for (int kk = 0; kk < BC; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, int ld,
                                          int rows, int cols, int row0,
                                          int col0, const float (&acc)[4][4],
                                          int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < cols) store(out + (size_t)r * ld + c, acc[i][j]);
    }
  }
}

// out (M, C) = a (M, L) @ Q(W) contracted over L.  K4 (kNT false): a = x,
// W (L, C) = (K, N), out = y.  K5 (kNT true): a = g, W (C, L) = (K, N)
// read transposed, out = dx.  Grid (ceil(C/64), ceil(M/64)).
template <typename T, bool kNT>
__global__ void __launch_bounds__(THREADS) statsq_kernel(
    const T* __restrict__ a, const float* __restrict__ w,
    const float* __restrict__ s, T* __restrict__ out, int M, int L, int C,
    float nl) {
  // l-major tiles; the +1 pad keeps the transposing stores conflict-free
  __shared__ float as[BC][BM + 1];
  __shared__ float ws[BC][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += BC) {
    // a tile: consecutive threads walk a row's L (coalesced)
    for (int e = tid; e < BM * BC; e += THREADS) {
      const int r = e / BC, ll = e % BC;
      const int gr = row0 + r, gl = l0 + ll;
      as[ll][r] = (gr < M && gl < L) ? widen(a[(size_t)gr * L + gl]) : 0.0f;
    }
    // W tile, quantized on load; consecutive threads walk W's rows
    // (coalesced): along C for K4, along L for K5 (stored transposed)
    for (int e = tid; e < BC * BN; e += THREADS) {
      const int ll = kNT ? e % BC : e / BN;
      const int c = kNT ? e / BC : e % BN;
      const int gl = l0 + ll, gc = col0 + c;
      float q = 0.0f;
      if (gl < L && gc < C)
        q = kNT ? quant(w[(size_t)gc * L + gl], s[gl], nl)
                : quant(w[(size_t)gl * C + gc], s[gc], nl);
      ws[ll][c] = q;
    }
    __syncthreads();
    tile_fma(as, ws, acc, tx, ty);
    __syncthreads();
  }
  store_tile(out, C, M, C, row0, col0, acc, tx, ty);
}

template <bool kNT>
int launch(const void* a, const float* w, const float* s, void* out, int M,
           int L, int C, float nl, int bf16, void* stream) {
  dim3 grid((C + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    statsq_kernel<__nv_bfloat16, kNT><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, w, s, (__nv_bfloat16*)out, M, L, C, nl);
  else
    statsq_kernel<float, kNT><<<grid, THREADS, 0, st>>>(
        (const float*)a, w, s, (float*)out, M, L, C, nl);
  return (int)cudaGetLastError();
}

}  // namespace

// K4.  x, y: float (bf16 == 0) or __nv_bfloat16 (bf16 == 1); w, s: float
extern "C" int ofq_pallas_statsq_fwd(const void* x, const float* w,
                                     const float* s, void* y, int M, int K,
                                     int N, float nl, int bf16,
                                     void* stream) {
  return launch<false>(x, w, s, y, M, K, N, nl, bf16, stream);
}

// K5.  g, dx: float (bf16 == 0) or __nv_bfloat16 (bf16 == 1); w, s: float
extern "C" int ofq_pallas_statsq_dx(const void* g, const float* w,
                                    const float* s, void* dx, int M, int K,
                                    int N, float nl, int bf16,
                                    void* stream) {
  return launch<true>(g, w, s, dx, M, N, K, nl, bf16, stream);
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
