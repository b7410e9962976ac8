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
//
// Each launcher runs two kernels on the caller's stream.  A pre-pass forms
// Q(W) once per call in fp32 into a scratch buffer the wrapper allocates
// (K * N floats, L2-resident at these widths): Q(W) itself (K, N) for K4,
// its transpose (N, K) for K5.  Then one product body computes
//   out (M, C) = a (M, L) @ B (L, C)
// with a = x, B = Q(W) (K4) or a = g, B = Q(W)^T (K5).  x, g and the output
// are float or bf16 (template T): a bf16 input widens exactly to fp32, each
// output is one fp32 FMA chain over the contraction in ascending order
// from 0 (CUDA-core FMAs, no TF32, no tensor cores), rounded once to T.
// No chain depends on the tiling, so a change of tiling moves no bit.
//
// What bounds it on an H100: at DeiT-S widths (M = 64*198, K, N in
// {384, 1536}) the work is 2*M*K*N operations against ~esize*(MK + MN)
// + 4*KN bytes.  In the bf16 stream x and the odd level codes are exact in
// bf16, so the tensor cores could run the same product: the bound is then
// bytes (~0.006 ms for proj, ~0.015 ms for fc1/fc2).  But Q(W) itself is
// not a bf16 or TF32 value, and a tensor-core form that factors out s was
// refused by the whole-step gradient rule (PERF.md section 7), so the
// product stays on the fp32 CUDA cores, whose rate is this design's floor
// (~0.06 ms for proj, ~0.22 ms for fc1/fc2).  The product is
// register-tiled for that rate: 8 x 8 outputs a thread, warps of 32 x 64
// or 64 x 32 outputs, a's rows read as float4 (bf16: 8 bytes) and B's
// columns as float4 from shared memory, fed by a 3-stage cp.async ring of
// 16-deep chunks (qkr_scores.cuh's ring, row loads and fma_chunk).  The
// block tile (128 x 128 or 128 x 96) is chosen per shape
// (`choose`) for the fewest waves on the card's SMs, so that DeiT-S's
// N = 384 and Swin-T's N = 96 run neither a thin last wave nor a padded
// column block.  The contraction is never split: a split-K sum would
// reorder the chain.
//
// Rounding: rintf rounds half to even like torch.round / jnp.round, and
// StatsQ's c*nl - 0.5 sits on a tie whenever c*nl is integral, so every
// multiply/add/divide whose rounding feeds rint, or that forms Q(W), is
// spelled with the __f*_rn intrinsics (no FMA contraction); IEEE division
// (no --use_fast_math).  Ragged edges (M = 12 672 and M = 3 136 are no
// multiples of 128, K = 20 no multiple of 16) are guarded in the kernel:
// loads outside the matrix read 0 (an exact zero added to the chain),
// stores outside are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "qkr_scores.cuh"

namespace {

using qkr::bf16;

constexpr int BK = 16;     // contraction chunk
constexpr int STAGES = 3;  // ring stages
constexpr int BLOCKS_PER_SM = 2;  // __launch_bounds__ fits their registers
constexpr int LV = 32;     // pre-pass: a 32 x 32 tile of W per block
constexpr int LV_ROWS = 8;  //   of 32 x 8 threads

// _quant_tile on one element, in the order of the JAX expression
__device__ __forceinline__ float quant(float w, float s, float nl) {
  const float hi = 1.0f - 1e-6f;
  const float c = fminf(fmaxf(__fdiv_rn(w, s), -1.0f), hi);
  const float lv = rintf(__fsub_rn(__fmul_rn(c, nl), 0.5f));
  return __fmul_rn(s, __fdiv_rn(__fadd_rn(lv, 0.5f), nl));
}

// The pre-pass: wq = Q(W) (K, N), or (kT) its transpose (N, K), for one
// 32 x 32 tile of W per block (read along W's rows; the transpose goes
// through shared memory so that its writes run along wq's rows too).
template <bool kT>
__global__ void __launch_bounds__(LV * LV_ROWS) levels_kernel(
    const float* __restrict__ w, const float* __restrict__ s,
    float* __restrict__ wq, int K, int N, float nl) {
  __shared__ float t[LV][LV + 1];
  const int k0 = blockIdx.y * LV, n0 = blockIdx.x * LV;
  const int tx = threadIdx.x % LV, ty = threadIdx.x / LV;
  for (int r = ty; r < LV; r += LV_ROWS) {
    const int k = k0 + r, n = n0 + tx;
    if (k < K && n < N) {
      const float q = quant(w[(size_t)k * N + n], s[n], nl);
      if (kT) t[r][tx] = q;
      else wq[(size_t)k * N + n] = q;
    }
  }
  if (!kT) return;
  __syncthreads();
  for (int r = ty; r < LV; r += LV_ROWS) {
    const int n = n0 + r, k = k0 + tx;
    if (n < N && k < K) wq[(size_t)n * K + k] = t[tx][r];
  }
}

// A block tile of the product: WM x WN warps, each RG row groups x 32 / RG
// column groups of lanes, each lane 8 x 8 outputs (rows RG apart, so that
// a warp's reads of a's rows fall on distinct banks; two 4-wide column
// runs 4 * CG apart).
template <int RG_, int WM_, int WN_>
struct Tile {
  static constexpr int RG = RG_, WM = WM_, WN = WN_;
  static constexpr int CG = 32 / RG;
  static constexpr int WROWS = 8 * RG, WCOLS = 8 * CG;
  static constexpr int BM = WM * WROWS, BN = WN * WCOLS;
  static constexpr int THREADS = 32 * WM * WN;
};
using Tile128x128 = Tile<4, 4, 2>;  // 256 threads, warps 32 x 64
using Tile128x96 = Tile<8, 2, 3>;   // 192 threads, warps 64 x 32

// a's chunk rows in shared memory: BK elements and 16 bytes of padding
// (80 bytes in fp32, 48 in bf16), so that the RG consecutive rows a warp
// reads at once sit on distinct banks
template <typename T>
__host__ __device__ constexpr int a_ld() { return BK + 16 / (int)sizeof(T); }

template <typename T, class TL>
__host__ __device__ constexpr size_t a_bytes() {
  return (size_t)TL::BM * a_ld<T>() * sizeof(T);
}

template <typename T, class TL>
__host__ __device__ constexpr size_t stage_bytes() {
  return a_bytes<T, TL>() + (size_t)BK * TL::BN * sizeof(float);
}

template <typename T, class TL>
__host__ __device__ constexpr size_t smem_bytes() {
  return STAGES * stage_bytes<T, TL>();
}

// out[c + j] = v[j] for j < min(avail, 4), rounded once to T: one vector
// store where the four are whole and aligned
__device__ __forceinline__ void store4(float* p, int avail, const float* v) {
  if (avail >= 4 && ((uintptr_t)p & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && j < avail; ++j) p[j] = v[j];
  }
}
__device__ __forceinline__ void store4(bf16* p, int avail, const float* v) {
  if (avail >= 4 && ((uintptr_t)p & 7) == 0) {
    uint32_t h[4];
    for (int j = 0; j < 4; ++j)
      h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
    *reinterpret_cast<uint2*>(p) =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  } else {
    for (int j = 0; j < 4 && j < avail; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// out (M, C) = a (M, L) @ b (L, C), b fp32; grid (ceil(C / BN), ceil(M /
// BM)), dynamic shared memory smem_bytes<T, TL>().
template <typename T, class TL>
__global__ void __launch_bounds__(TL::THREADS, BLOCKS_PER_SM)
    product_kernel(const T* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ out, int M, int L, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDA = a_ld<T>();
  const int row0 = blockIdx.y * TL::BM, col0 = blockIdx.x * TL::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this thread's rows r + RG i (i < 8) and columns c + 0..3, c + 4 CG +
  // 0..3 of the block tile
  const int r = (warp % TL::WM) * TL::WROWS + lane / TL::CG;
  const int c = (warp / TL::WM) * TL::WCOLS + 4 * (lane % TL::CG);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  qkr::ring<STAGES>(
      (L + BK - 1) / BK,
      [&](int ch, int st) {
        unsigned char* stage = smem + st * stage_bytes<T, TL>();
        qkr::load_rows<T, TL::BM, BK, TL::THREADS>(
            reinterpret_cast<T*>(stage), LDA, a, L, row0, M, ch * BK, L);
        qkr::load_rows<float, BK, TL::BN, TL::THREADS>(
            reinterpret_cast<float*>(stage + a_bytes<T, TL>()), TL::BN, b, C,
            ch * BK, L, col0, C);
      },
      [&](int st) {
        const unsigned char* stage = smem + st * stage_bytes<T, TL>();
        qkr::fma_chunk<T, 8, 8, BK, false, true>(
            acc, reinterpret_cast<const T*>(stage) + r * LDA, TL::RG * LDA,
            0, reinterpret_cast<const float*>(stage + a_bytes<T, TL>()),
            TL::BN, c, 4 * TL::CG);
      });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + r + TL::RG * i;
    if (gr >= M) break;
    T* o = out + (size_t)gr * C + col0 + c;
    const int avail = C - col0 - c;
    store4(o, avail, acc[i]);
    store4(o + 4 * TL::CG, avail - 4 * TL::CG, acc[i] + 4);
  }
}

// One instantiation of the product: its kernel and launch shape.
struct Plan {
  const void* kernel;
  int bm, bn, threads;
  size_t smem;
};

template <typename T, class TL>
Plan plan_of() {
  return {(const void*)product_kernel<T, TL>, TL::BM, TL::BN, TL::THREADS,
          smem_bytes<T, TL>()};
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The tile for out (M, C) on `sms` SMs: the fewer waves (a wave being
// BLOCKS_PER_SM blocks on every SM), and at equal waves 128 x 96, whose
// wave does less work (padding included): the waves set the time.
template <typename T>
Plan choose(int M, int C, int sms) {
  const Plan big = plan_of<T, Tile128x128>(), small = plan_of<T, Tile128x96>();
  const auto waves = [&](const Plan& p) {
    return cdiv(cdiv(M, p.bm) * cdiv(C, p.bn), (long long)sms * BLOCKS_PER_SM);
  };
  return waves(big) < waves(small) ? big : small;
}

// The plan for out (M, C) in stream dtype T on the current card, with its
// dynamic shared memory allowed; error in *err.
template <typename T>
Plan prepare(int M, int C, cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Plan p = choose<T>(M, C, sms > 0 ? sms : 1);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(p.kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)p.smem);
  return p;
}

dim3 grid_of(const Plan& p, int M, int C) {
  return dim3((unsigned)cdiv(C, p.bn), (unsigned)cdiv(M, p.bm));
}

// Q(W) (kT: its transpose) into wq, then out (M, C) = a (M, L) @ wq
template <typename T, bool kT>
int launch(const T* a, const float* w, const float* s, float* wq, T* out,
           int M, int L, int C, float nl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // W is (K, N): (L, C) for K4, (C, L) for K5
  const int K = kT ? C : L, N = kT ? L : C;
  cudaError_t err;
  const Plan p = prepare<T>(M, C, &err);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(p, M, C);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  levels_kernel<kT><<<dim3((unsigned)cdiv(N, LV), (unsigned)cdiv(K, LV)),
                      LV * LV_ROWS, 0, st>>>(w, s, wq, K, N, nl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a, (void*)&wq, (void*)&out, (void*)&M, (void*)&L,
                  (void*)&C};
  err = cudaLaunchKernel(p.kernel, grid, dim3(p.threads), args, p.smem, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kT>
int launch_any(const void* a, const float* w, const float* s, float* wq,
               void* out, int M, int L, int C, float nl, int bf16,
               void* stream) {
  if (bf16)
    return launch<qkr::bf16, kT>((const qkr::bf16*)a, w, s, wq,
                                 (qkr::bf16*)out, M, L, C, nl, stream);
  return launch<float, kT>((const float*)a, w, s, wq, (float*)out, M, L, C,
                           nl, stream);
}

}  // namespace

// How the product launches for out (M, C) in fp32 (bf16 == 0) or bf16:
// info = {tile rows, tile columns, threads, grid x, grid y, blocks per SM
// (the CUDA runtime's occupancy: shared memory, threads and registers; 0
// where it refuses)}; returns the dynamic shared memory in bytes.  K4:
// C = N; K5: C = K.
extern "C" long long ofq_pallas_statsq_launch(int M, int C, int bf16,
                                              int* info) {
  cudaError_t err;
  const Plan p = bf16 ? prepare<qkr::bf16>(M, C, &err)
                      : prepare<float>(M, C, &err);
  const dim3 grid = grid_of(p, M, C);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kernel,
                                                        p.threads, p.smem);
  if (err != cudaSuccess) {
    blocks = 0;
    cudaGetLastError();  // a refused query leaves no error for the launches
  }
  const int out[6] = {p.bm, p.bn, p.threads, (int)grid.x, (int)grid.y,
                      blocks};
  for (int i = 0; i < 6; ++i) info[i] = out[i];
  return (long long)p.smem;
}

// K4.  x, y: float (bf16 == 0) or __nv_bfloat16 (bf16 == 1); w (K, N), s
// (1, N): float; wq: scratch of K * N floats (Q(W) on return)
extern "C" int ofq_pallas_statsq_fwd(const void* x, const float* w,
                                     const float* s, float* wq, void* y,
                                     int M, int K, int N, float nl, int bf16,
                                     void* stream) {
  return launch_any<false>(x, w, s, wq, y, M, K, N, nl, bf16, stream);
}

// K5.  g, dx: float (bf16 == 0) or __nv_bfloat16 (bf16 == 1); w (K, N), s
// (1, N): float; wq: scratch of K * N floats (Q(W)^T, (N, K), on return)
extern "C" int ofq_pallas_statsq_dx(const void* g, const float* w,
                                    const float* s, float* wq, void* dx,
                                    int M, int K, int N, float nl, int bf16,
                                    void* stream) {
  return launch_any<true>(g, w, s, wq, dx, M, N, K, nl, bf16, stream);
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
