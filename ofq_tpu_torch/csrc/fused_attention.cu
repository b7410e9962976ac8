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
// TQ x N score tile into shared memory (N = 198 at DeiT: 64 x 208 floats,
// ~53 KB) with the score tile that K3's pass A shares (`qkr::score_tile`,
// csrc/qkr_scores.cuh: register tiles of 8 rows x 7 keys a thread, each
// score one __fmaf_rn chain in ascending k, the operands through a
// three-stage cp.async ring in the stream dtype); then one warp per row
// takes the max and the sum, normalises and quantizes in place; then the
// block multiplies the quantized tile by v (`qkr::pq_v`: 8 rows x 2
// columns a thread, v through a cp.async ring of 16-key chunks, each
// output one __fmaf_rn chain in ascending key).  Only `out` is written to
// device memory.  ~93 KB of shared memory and at most 128 registers a
// thread: two blocks share an SM.
//
// What bounds it on an H100: at DeiT-S QKR (N = 198, H = 6, K = 384, d = 64)
// the work is 2*B*H*N^2*(K + d) operations against 4*B*N*(K + H*K + 2*H*d)
// bytes in fp32, half that in bf16: ~75 (fp32) or ~150 (bf16) operations
// per byte.  The fp32 form is bound by the fp32 rate (67 TFLOP/s); the bf16
// form's products are exact bf16 x bf16 and could run at the bf16
// tensor-core rate, where the bytes bound it, but this template runs them
// as fp32 FMAs on the CUDA cores.  rhs is re-read once per query tile (4
// tiles at N = 198), from L2.
//
// Rounding: rintf (half to even, as torch.round / jnp.round); expf, not
// __expf; IEEE division; no --use_fast_math.
//
// The score tile is fp32 in both stream dtypes and the rings take the
// same bytes in both (32-byte row chunks), so the bytes a launch needs
// depend on N only: the launcher's smem count serves both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

#include "qkr_scores.cuh"

namespace {

using qkr::TQ;
using qkr::THREADS;
using qkr::WARPS;

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

// the score tile's row stride: N rounded up to pq_v's key chunk (16-byte
// rows; the columns past N hold pq's zeros)
int score_ld(int N) { return (N + qkr::PV_KEYS - 1) / qkr::PV_KEYS * qkr::PV_KEYS; }

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) qkr_attention_fwd_kernel(
    const T* __restrict__ lhs, int lhs_per_head, const T* __restrict__ rhs,
    const T* __restrict__ v, const float* __restrict__ s, T* __restrict__ out,
    int N, int H, int K, int D, int ld_s, float thd_pos, float sm_scale,
    int quantize) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                  // [TQ][ld_s] scores, pq
  T* ring = reinterpret_cast<T*>(S + TQ * ld_s);    // the products' rings

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const size_t lhs_row = lhs_per_head ? (size_t)H * K : (size_t)K;
  const T* lhs_b = lhs + (size_t)b * N * lhs_row + (lhs_per_head ? (size_t)h * K : 0);
  const T* rhs_b = rhs + (size_t)b * N * H * K + (size_t)h * K;
  const T* v_b = v + (size_t)b * N * H * D + (size_t)h * D;
  T* out_b = out + (size_t)b * N * H * D + (size_t)h * D;

  // ---- phase 1: S = (lhs_tile @ rhs^T) * sm_scale -------------------------
  qkr::score_tile<T>(S, ld_s, lhs_b, lhs_row, q0, rhs_b, (size_t)H * K, N, K,
                     sm_scale, ring);
  __syncthreads();

  // ---- phase 2: softmax and LSQ over each row, one warp per row ----------
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int r = warp; r < TQ; r += WARPS) {
    float* row = S + r * ld_s;
    const int n = q0 + r;
    if (n >= N) {
      for (int m = lane; m < ld_s; m += 32) row[m] = 0.0f;
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
    for (int m = N + lane; m < ld_s; m += 32) row[m] = 0.0f;
  }
  __syncthreads();

  // ---- phase 3: out_tile = pq @ v ----------------------------------------
  qkr::pq_v<T>(S, ld_s, v_b, (size_t)H * D, q0, N, D, out_b, (size_t)H * D,
               ring);
}

long long smem_bytes(int N) {
  return (long long)sizeof(float) * TQ * score_ld(N) + qkr::ring_bytes(TQ);
}

// K2's kernel for stream dtype T with its dynamic shared memory at N keys
// set, and the largest carveout, so that two blocks' shared memory fit an
// SM; nullptr where the runtime refuses, the error in *err.
template <typename T>
const void* prepare_fwd(int N, cudaError_t* err) {
  const void* fwd = (const void*)qkr_attention_fwd_kernel<T>;
  *err = cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(N));
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(fwd,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  return *err == cudaSuccess ? fwd : nullptr;
}

template <typename T>
int launch_fwd(const T* lhs, int lhs_per_head, const T* rhs, const T* v,
               const float* s, T* out, int B, int N, int H, int K, int D,
               float thd_pos, float sm_scale, int quantize, void* stream) {
  cudaError_t err;
  if (prepare_fwd<T>(N, &err) == nullptr) return (int)err;
  dim3 grid((N + TQ - 1) / TQ, H, B);
  qkr_attention_fwd_kernel<T>
      <<<grid, THREADS, (size_t)smem_bytes(N), (cudaStream_t)stream>>>(
          lhs, lhs_per_head, rhs, v, s, out, N, H, K, D, score_ld(N), thd_pos,
          sm_scale, quantize);
  return (int)cudaGetLastError();
}

}  // namespace

// How K2 launches for N keys in a stream dtype (is_bf16 != 0 for bf16):
// returns its dynamic shared memory in bytes, which the wrapper checks
// against the card's per-block limit, and writes the blocks that one SM
// holds (the CUDA runtime's occupancy: shared memory, threads and
// registers; 0 where the kernel cannot take that shared memory).
extern "C" long long ofq_qkr_attention_fwd_launch(int N, int is_bf16,
                                                  int* blocks) {
  const long long smem = smem_bytes(N);
  cudaError_t err;
  const void* fwd = is_bf16 ? prepare_fwd<__nv_bfloat16>(N, &err)
                            : prepare_fwd<float>(N, &err);
  if (fwd != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fwd, THREADS,
                                                        (size_t)smem);
  if (err != cudaSuccess) {
    *blocks = 0;
    cudaGetLastError();  // a refused query leaves no error for the launches
  }
  return smem;
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
