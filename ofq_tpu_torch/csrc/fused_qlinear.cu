// Fused QLinear forward: LSQ activation codes x StatsQ weight codes.
//
// Replaces the Pallas kernel ofq_tpu/ops/fused_qlinear.py:_fwd_kernel
// (called by _fwd_call, reached through fused_qlinear).  Per output tile:
//
//   u   = (x + b_pre) / s_tok[r % n_tok]
//   XI  = rint(clip(u, a_lo, a_hi))                      LSQ integer codes
//   WI  = 2 * rint(clip(w / s_w, -1, 1 - 1e-6) * n - 0.5) + 1   odd StatsQ codes
//   acc = XI @ WI                                        exact in fp32
//   y   = acc * s_tok[r] * (s_w[c] / (2n)) + bvec[c]
//
// s_w = 2 mean|W| per column and bvec = b_post @ Wq + bias come from the
// caller, as in JAX.  Both code sets are formed in registers on their way
// into shared memory and never reach device memory.
//
// What bounds it on an H100: at DeiT-S widths (M = 64*197, K, N in
// {384, 1536}) the product is ~2*M*K*N fp32 FMAs against ~4*(MK+KN+MN)
// bytes, i.e. ~100 operations per byte: compute-bound on the fp32 CUDA
// cores (67 TFLOP/s).  This first version is a plain shared-memory tiled
// product, one 64x64 output tile per 256-thread block, 4x4 outputs per
// thread.  The codes are small integers (|XI*WI| <= 9 at W2A2), so the
// tensor cores could run the same product exactly in int8 or bf16: that
// is the next step for speed.
//
// Rounding: rintf rounds half to even like torch.round / jnp.round (CUDA's
// roundf would round half away from zero).  StatsQ's c*n - 0.5 sits on a
// tie whenever c*n is an integer, so every multiply-add whose rounding
// feeds a rint is spelled with __fmul_rn / __fadd_rn: nvcc may not
// contract them into an FMA.  IEEE division (no --use_fast_math).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) fused_qlinear_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ s_tok, int n_tok,
    const float* __restrict__ b_pre, const float* __restrict__ w,
    const float* __restrict__ s_w, const float* __restrict__ bvec,
    float* __restrict__ y, int M, int K, int N, float a_lo, float a_hi,
    float n_w) {
  // k-major tiles of integer codes; +1 pad keeps the transposing stores
  // of the activation tile free of bank conflicts
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float w_hi = 1.0f - 1e-6f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: consecutive threads walk a row's K (coalesced)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int kk = e % BK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      float code = 0.0f;
      if (gr < M && gk < K) {
        const float s = s_tok[gr % n_tok];
        const float u =
            __fdiv_rn(__fadd_rn(x[(size_t)gr * K + gk], b_pre[gk]), s);
        code = rintf(fminf(fmaxf(u, a_lo), a_hi));
      }
      xs[kk][r] = code;
    }
    // weight tile: consecutive threads walk a row's N (coalesced)
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int c = e % BN;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      float code = 0.0f;
      if (gk < K && gc < N) {
        const float cl = fminf(
            fmaxf(__fdiv_rn(w[(size_t)gk * N + gc], s_w[gc]), -1.0f), w_hi);
        code = __fadd_rn(
            __fmul_rn(2.0f, rintf(__fsub_rn(__fmul_rn(cl, n_w), 0.5f))),
            1.0f);
      }
      ws[kk][c] = code;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float two_n = 2.0f * n_w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
    const float s = s_tok[r % n_tok];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      const float scale = __fdiv_rn(s_w[c], two_n);
      y[(size_t)r * N + c] =
          __fadd_rn(__fmul_rn(__fmul_rn(acc[i][j], s), scale), bvec[c]);
    }
  }
}

}  // namespace

extern "C" int ofq_fused_qlinear_fwd(const float* x, const float* s_tok,
                                     int n_tok, const float* b_pre,
                                     const float* w, const float* s_w,
                                     const float* bvec, float* y, int M,
                                     int K, int N, float a_lo, float a_hi,
                                     float n_w, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_qlinear_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, s_tok, n_tok, b_pre, w, s_w, bvec, y, M, K, N, a_lo, a_hi, n_w);
  return (int)cudaGetLastError();
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
