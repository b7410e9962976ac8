// Fused quantized attention core, forward: scores -> softmax -> LSQ -> @ v.
//
// Replaces the Pallas kernel ofq_tpu/ops/fused_attention.py:_fwd_kernel
// (called by _attn_core_fwd, reached through quantized_attention_core).
// For every (b, h) and every query row n:
//
//   scores[m] = fp32(lhs[b, n, (h), :] . rhs[b, m, h, :]) * sm_scale
//   p         = e / fp32(sum_m e[m]),  e = expf(scores - max)
//   pq        = rint(clip(p / s_n, 0, 2^bits - 1)) * s_n,  s_n = max(s[n], 1e-5)
//   out[b, n, h, :] = fp32(sum_m pq[m] * v[b, m, h, :])
//
// Every sum accumulates in fp32, as the TPU kernel's products and softmax
// do (preferred_element_type=float32), so the kernel and its plain version
// agree up to the ulps of two fp32 summation orders; where such an ulp moves
// a probability across an LSQ rounding boundary, one output element moves by
// one level, s_n * |v|.
//
// lhs is either shared across heads (QKR: the quantized input xq, (B, N, K))
// or per head ((B, N, H, K)); rhs (B, N, H, K), v and out (B, N, H, D),
// contiguous, in the JAX package's natural layout; s fp32.
//
// The stream dtype T of lhs, rhs, v and out is fp32 or bf16 (one template,
// two C launchers).  In bf16 the TPU kernel's arithmetic is reproduced: the
// bf16 operands are widened exactly to fp32 as they are loaded, so products
// are exact and sums, scores and the softmax stay fp32; pq is rounded to
// bf16 before the product with v (`pq.astype(v.dtype)`), as a separate
// __fmul_rn then __float2bfloat16_rn, and out is rounded to bf16 once.  In
// fp32 both roundings are the identity.
//
// Design.  One 256-thread block per (query tile of TQ = 64 rows, head,
// batch row).  LSQ quantizes the *normalised* probability, so an online
// (flash) softmax does not fit: the block first computes its full
// TQ x N score tile into shared memory (N = 198 at DeiT: 64 x 257 floats,
// ~66 KB), tiling the contraction over K in chunks of 32; then one warp per
// row takes the max and the sum, normalises and quantizes in place; then
// the block multiplies the quantized tile by v, 32 keys at a time.  Only
// `out` is written to device memory.  Every product is a plain
// shared-memory tiled loop on the CUDA cores, 4x4 outputs per thread.
//
// What bounds it on an H100: at DeiT-S QKR (N = 198, H = 6, K = 384, d = 64)
// the work is 2*B*H*N^2*(K + d) operations against 4*B*N*(K + H*K + 2*H*d)
// bytes in fp32, half that in bf16: ~75 (fp32) or ~150 (bf16) operations
// per byte.  The fp32 form is bound by the fp32 rate (67 TFLOP/s); the bf16
// form's products are exact bf16 x bf16 and could run at the bf16
// tensor-core rate, where the bytes bound it, but this template runs them
// as fp32 FMAs on the CUDA cores (tensor cores are a later redesign).  rhs
// is re-read once per query tile (4 tiles at N = 198), from L2.
//
// Rounding: rintf (half to even, as torch.round / jnp.round); expf, not
// __expf; IEEE division; no --use_fast_math.
//
// Shared memory holds fp32 in both stream dtypes (a bf16 operand is widened
// as it is stored), so the bytes a launch needs depend on N only: the
// launcher's smem count serves both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int TQ = 64;       // query rows per block
constexpr int TK = 64;       // keys per score tile
constexpr int KC = 32;       // contraction chunk
constexpr int TV = 32;       // keys per v tile
constexpr int TD = 64;       // output columns per pass
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
// x rounded to T and widened back: the value a product of T operands reads
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

template <typename T>
__global__ void __launch_bounds__(THREADS) qkr_attention_fwd_kernel(
    const T* __restrict__ lhs, int lhs_per_head, const T* __restrict__ rhs,
    const T* __restrict__ v, const float* __restrict__ s, T* __restrict__ out,
    int N, int H, int K, int D, int ld_s, float thd_pos, float sm_scale,
    int quantize) {
  extern __shared__ float smem[];
  float* S = smem;                        // [TQ][ld_s] scores, then pq
  float* As = S + TQ * ld_s;              // [KC][TQ + 1] lhs chunk
  float* Bs = As + KC * (TQ + 1);         // [KC][TK + 1] rhs chunk; v tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
  const T* lhs_b = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
  const T* rhs_b = rhs + (size_t)b * N * H * K + (size_t)h * K;
  const T* v_b = v + (size_t)b * N * H * D + (size_t)h * D;
  T* out_b = out + (size_t)b * N * H * D + (size_t)h * D;

  // ---- phase 1: S = (lhs_tile @ rhs^T) * sm_scale -------------------------
  const int n_key_tiles = (N + TK - 1) / TK;
  for (int kt = 0; kt < n_key_tiles; ++kt) {
    const int m0 = kt * TK;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      for (int e = tid; e < TQ * KC; e += THREADS) {
        const int r = e / KC;
        const int kk = e % KC;
        const int n = q0 + r;
        const int k = k0 + kk;
        As[kk * (TQ + 1) + r] =
            (n < N && k < K) ? ld(lhs_b + (size_t)n * lhs_row + k) : 0.0f;
      }
      for (int e = tid; e < TK * KC; e += THREADS) {
        const int c = e / KC;
        const int kk = e % KC;
        const int m = m0 + c;
        const int k = k0 + kk;
        Bs[kk * (TK + 1) + c] =
            (m < N && k < K) ? ld(rhs_b + (size_t)m * H * K + k) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk * (TQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[kk * (TK + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tx + 16 * j;
        if (m < N) S[(ty + 16 * i) * ld_s + m] = __fmul_rn(acc[i][j], sm_scale);
      }
  }
  __syncthreads();

  // ---- phase 2: softmax and LSQ over each row, one warp per row ----------
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_v_tiles = (N + TV - 1) / TV;
  const int m_pad = n_v_tiles * TV;       // columns phase 3 reads
  for (int r = warp; r < TQ; r += WARPS) {
    float* row = S + r * ld_s;
    const int n = q0 + r;
    if (n >= N) {
      for (int m = lane; m < m_pad; m += 32) row[m] = 0.0f;
      continue;
    }
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
    for (int m = lane; m < N; m += 32) {
      float p = __fdiv_rn(row[m], sum);
      if (quantize) {
        p = __fmul_rn(rintf(fminf(fmaxf(__fdiv_rn(p, sn), 0.0f), thd_pos)), sn);
      }
      row[m] = round_to<T>(p);
    }
    for (int m = N + lane; m < m_pad; m += 32) row[m] = 0.0f;
  }
  __syncthreads();

  // ---- phase 3: out_tile = pq @ v ----------------------------------------
  float* Vs = Bs;  // [TV][TD]
  for (int d0 = 0; d0 < D; d0 += TD) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int vt = 0; vt < n_v_tiles; ++vt) {
      const int m0 = vt * TV;
      for (int e = tid; e < TV * TD; e += THREADS) {
        const int mm = e / TD;
        const int c = e % TD;
        const int m = m0 + mm;
        const int d = d0 + c;
        Vs[mm * TD + c] = (m < N && d < D) ? ld(v_b + (size_t)m * H * D + d) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int mm = 0; mm < TV; ++mm) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = S[(ty + 16 * i) * ld_s + m0 + mm];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Vs[mm * TD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = q0 + ty + 16 * i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + tx + 16 * j;
        if (d < D) st(out_b + (size_t)n * H * D + d, acc[i][j]);
      }
    }
  }
}

long long smem_bytes(int N) {
  const int ld_s = ((N + TK - 1) / TK) * TK + 1;
  return (long long)sizeof(float) *
         ((long long)TQ * ld_s + KC * (TQ + 1) + KC * (TK + 1));
}

template <typename T>
int launch_fwd(const T* lhs, int lhs_per_head, const T* rhs, const T* v,
               const float* s, T* out, int B, int N, int H, int K, int D,
               float thd_pos, float sm_scale, int quantize, void* stream) {
  const int ld_s = ((N + TK - 1) / TK) * TK + 1;
  const size_t smem = (size_t)smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      qkr_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TQ - 1) / TQ, H, B);
  qkr_attention_fwd_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      lhs, lhs_per_head, rhs, v, s, out, N, H, K, D, ld_s, thd_pos, sm_scale,
      quantize);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the launch needs for N keys (bytes), in either stream
// dtype; the wrapper checks it against the card's per-block limit before
// launching.
extern "C" long long ofq_qkr_attention_smem_bytes(int N) {
  return smem_bytes(N);
}

extern "C" int ofq_qkr_attention_fwd(const float* lhs, int lhs_per_head,
                                     const float* rhs, const float* v,
                                     const float* s, float* out, int B, int N,
                                     int H, int K, int D, float thd_pos,
                                     float sm_scale, int quantize,
                                     void* stream) {
  return launch_fwd<float>(lhs, lhs_per_head, rhs, v, s, out, B, N, H, K, D,
                           thd_pos, sm_scale, quantize, stream);
}

// The bf16 stream: lhs, rhs, v and out bf16 (s fp32).
extern "C" int ofq_qkr_attention_fwd_bf16(
    const __nv_bfloat16* lhs, int lhs_per_head, const __nv_bfloat16* rhs,
    const __nv_bfloat16* v, const float* s, __nv_bfloat16* out, int B, int N,
    int H, int K, int D, float thd_pos, float sm_scale, int quantize,
    void* stream) {
  return launch_fwd<__nv_bfloat16>(lhs, lhs_per_head, rhs, v, s, out, B, N,
                                   H, K, D, thd_pos, sm_scale, quantize,
                                   stream);
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
