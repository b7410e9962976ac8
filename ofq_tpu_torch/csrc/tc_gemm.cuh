// The tensor-core GEMM of K1 (fused_qlinear.cu): the wgmma product, the
// shared-memory layout it reads, the pipeline and the codes' arithmetic.
//
// K1 multiplies small integer codes (LSQ activation codes, odd StatsQ
// weight codes), exact in bf16, so `wgmma.mma_async` m64nNk16 bf16 x bf16
// -> fp32 (sm_90a) computes each product exactly and, while the partial
// sums stay integers below 2^24, the whole sum exactly.
//
// Block: 512 threads, four warpgroups, one block per SM, persistent: block
// (x, y) of grid (nt, G) walks the M tiles y, y + G, ... of N tile x, a BM x
// BN output tile each (BM = 128, BN 64, 96 or 128).  Two warpgroups
// multiply, 64 rows each, with their fp32 accumulators in registers; all
// four load and code (the codes are latency-bound, so they take every warp
// the registers allow).  The contraction goes in stages of BK = 64: one
// 128-byte row of bf16 per operand row, stored K-major with the 128-byte
// swizzle that the wgmma descriptor reads (layout type 1: the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8); tile bases 1024-byte aligned; SBO =
// 1024 bytes, the stride of 8 rows; the k16 slices of a stage start 32
// bytes apart).
//
// The pipeline runs over the block's tiles as one sequence of steps (tile,
// stage): every operand's raw step comes in by cp.async into a ring of S
// slots, S - 1 steps ahead, so no thread waits on a global load; while the
// tensor cores multiply step g, the threads turn raw step g + 1 into codes
// (from shared memory, in registers) and store them into the swizzled code
// tiles (two, in turn), and a tile's epilogue overlaps the next tile's
// loads.  Where the W codes of the block's whole N tile fit in shared
// memory (a panel of KT code tiles), the block forms them once, before its
// first tile, and loads and codes no W after.
//
// Codes are step functions of the input, read off tables (see "codes as
// step functions" below): per column or row, where each step starts, found
// once per block with the exact expression.  Rows past M, columns past N
// and the K tail (K need not be a multiple of 16) are zero codes; stores
// past the matrix are skipped.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

constexpr int BM = 128;           // output rows per block
constexpr int BK = 64;            // contraction per stage: 64 bf16 = 128 bytes
constexpr int MMA_WGS = BM / 64;  // warpgroups that multiply
constexpr int THREADS = 512;      // four warpgroups load and code
constexpr int SMEM_LIMIT = 232448 - 256;  // dynamic, beside 128 B static
constexpr int A_BYTES = BM * BK * 2;     // a code tile of x (bf16)
constexpr int XRAW_BYTES = BM * BK * 4;  // a raw step of x (fp32)
__host__ __device__ constexpr int b_bytes(int bn) {  // a code tile of W
  return bn * BK * 2;
}
__host__ __device__ constexpr int wraw_bytes(int bn) {  // a raw step of W
  return BK * bn * 4;
}

// The grid of a launch: nt N tiles by G blocks each, G the number of SMs
// over nt (at least 1, at most the number of M tiles mt); each block walks
// T = ceil(mt / G) M tiles (the last ones past M, if any, computed and not
// stored).
struct Launch {
  dim3 grid;
  int tiles;  // T
};
// the SM count of the current device, asked once per device
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = v > 0 ? v : 132;
  }
  return counts[dev];
}
inline Launch launch_shape(int M, int N, int bn) {
  const int nt = (N + bn - 1) / bn, mt = (M + BM - 1) / BM;
  int g = sm_count() / nt;
  g = g < 1 ? 1 : g > mt ? mt : g;
  return Launch{dim3(nt, g), (mt + g - 1) / g};
}
// A kernel's dynamic shared memory raised to SMEM_LIMIT once per device
// (the first launch of each kernel there), then launched on `stream`.
template <class Kernel, class... Args>
int launch(Kernel kernel, const Launch& l, int smem, void* stream,
           Args... args) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static const void* raised[64][8] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const void** seen = raised[dev >= 0 && dev < 64 ? dev : 0];
  int i = 0;
  while (i < 8 && seen[i] && seen[i] != (const void*)kernel) ++i;
  if (i == 8 || seen[i] != (const void*)kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    if (i < 8) seen[i] = (const void*)kernel;
  }
  kernel<<<l.grid, THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the 1024-byte aligned start of the dynamic shared memory
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// The M tile of this block's t-th tile, and its first row
__device__ __forceinline__ int tile_m0(int t) {
  return (blockIdx.y + t * gridDim.y) * BM;
}

// byte offset of the 16-byte chunk c (k = 8c .. 8c + 7) of row r
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// K-major operand, 128-byte swizzle: start >> 4, LBO 16 B (unused by
// this layout), SBO 1024 B, layout type 1
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the 8 codes of chunk c of row r, as bf16, into a swizzled tile
__device__ __forceinline__ void st_chunk(uint8_t* tile, int r, int c,
                                         const float (&v)[8]) {
  uint4 q;
  q.x = pack2(v[0], v[1]);
  q.y = pack2(v[2], v[3]);
  q.z = pack2(v[4], v[5]);
  q.w = pack2(v[6], v[7]);
  *reinterpret_cast<uint4*>(tile + swz(r, c)) = q;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a / b rounded to nearest (even) in fp32, from rb = 1 / b in fp64 (the
// correctly rounded double reciprocal, one per row or column): the bits of
// the IEEE division __fdiv_rn(a, b) without its branch to a slow path, so
// that a thread's divisions overlap.  Why, for finite a, b != 0 and a
// quotient in the normal range: a = A 2^x, b = B 2^y with A, B integers
// below 2^24.  An fp32 rounding midpoint m = Q 2^z has an odd Q of 25
// bits, and m b = Q B 2^(y + z) has at least 25 significant bits where a
// has at most 24, so a / b is never a midpoint; a - m b, a non-zero
// multiple of 2^min(x, y + z), puts every midpoint more than 2^-49 |a / b|
// away (1 / (Q B) > 2^-49).  a * rb carries at most 2^-52 |a / b| of
// error (two fp64 roundings), so rounding it to fp32 rounds a / b.  In the
// subnormal range a quotient can sit on a midpoint, and then differ by one
// subnormal step; clip, * n - 0.5 and rint (StatsQ) or clip and rint (LSQ)
// map every subnormal to the same code, so no code differs.  Zeros,
// infinities and NaNs propagate as in the division.
__device__ __forceinline__ float div_rn(float a, double rb) {
  return __double2float_rn(__dmul_rn((double)a, rb));
}
__device__ __forceinline__ double rcp64(float b) {
  return __drcp_rn((double)b);
}

// StatsQ's level of a quotient q, in the order of the JAX expression:
// rint(clip(q, -1, 1 - 1e-6) * n - 0.5), rintf half to even like
// jnp.round, no FMA contraction (c * n - 0.5 sits on a tie whenever c * n
// is an integer); its odd code 2 level + 1
__device__ __forceinline__ float statsq_level(float q, float n) {
  const float c = fminf(fmaxf(q, -1.0f), 1.0f - 1e-6f);
  return rintf(__fsub_rn(__fmul_rn(c, n), 0.5f));
}
__device__ __forceinline__ float statsq_code(float w, double rs, float n) {
  return __fadd_rn(__fmul_rn(2.0f, statsq_level(div_rn(w, rs), n)), 1.0f);
}

// ---- codes as step functions
// For a divisor b > 0 fixed per column (StatsQ's s) or per row (LSQ's
// s_tok), the code is a non-decreasing step function of the fp32 input:
// RN(a / b), clip, RN(c n), RN(. - 0.5) and rint are each monotone.  So a
// block finds once, per column or row, where each step starts, and codes
// an element by comparisons: code = base + sum_j d_j [a >= t_j].  The
// steps are found with the exact expression: first in the quotient (the
// steps of the level function, the same for every column), on a window of
// 9 consecutive floats around where each must lie; then t_j, the smallest
// input whose quotient reaches it, on a window of 9 floats around q_j b.
// Up to MAX_STEPS candidates (W4, A4); more levels take the division per
// element.
constexpr int MAX_STEPS = 16;

// the first of 9 consecutive floats around x0 at which f steps, as
// (where, f after - f before); (INFINITY, 0) if f is flat there
template <class F>
__device__ __forceinline__ float2 find_step(float x0, F f) {
  float x = x0;
#pragma unroll
  for (int i = 0; i < 4; ++i) x = nextafterf(x, -INFINITY);
  float prev = f(x), at = INFINITY, d = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x = nextafterf(x, INFINITY);
    const float cur = f(x);
    if (at == INFINITY && cur != prev) {
      at = x;
      d = cur - prev;
    }
    prev = cur;
  }
  return make_float2(at, d);
}

// the smallest fp32 a with RN(a / b) >= q (b > 0): RN(a / b) is monotone
// in a, and q b rounded lies within an ulp of it
__device__ __forceinline__ float step_start(float q, float b, double rb) {
  float a = __fmul_rn(q, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) a = nextafterf(a, -INFINITY);
  float at = INFINITY;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if (at == INFINITY && div_rn(a, rb) >= q) at = a;
    a = nextafterf(a, INFINITY);
  }
  return at;
}

// The quotient steps of StatsQ's code (n levels each side, n a power of
// two): every thread, with a barrier after.  Candidates j < 2n: the step
// where c n - 0.5 crosses j - n - 0.5, near c = (j - n) / n (the step from
// level -1 to 0 lies at -2^-25 / n, where RN(c n - 0.5) leaves -0.5; at
// c = -1 the code is flat for even n).  Writes the steps with d != 0 to
// q, d (in order), *base (the code below every step) and returns how many;
// 0 past MAX_STEPS candidates.
__device__ __forceinline__ int statsq_steps(float n, float* q, float* d,
                                            float* base) {
  const int J = 2 * (int)n;
  if (J > MAX_STEPS) return 0;
  __shared__ float cq[MAX_STEPS], cd[MAX_STEPS];
  const int j = threadIdx.x;
  if (j < J) {
    const int jj = j - (int)n;
    const float x0 = jj == 0 ? -ldexpf(1.0f, -25) / n : (float)jj / n;
    const float2 st = find_step(x0, [&](float c) {
      return __fadd_rn(__fmul_rn(2.0f, statsq_level(c, n)), 1.0f);
    });
    cq[j] = st.x;
    cd[j] = st.y;
  }
  __syncthreads();
  int k = 0;
  for (int i = 0; i < J; ++i) {
    if (cd[i] != 0.0f) {
      if (j == 0) {
        q[k] = cq[i];
        d[k] = cd[i];
      }
      ++k;
    }
  }
  if (j == 0)
    *base = __fadd_rn(__fmul_rn(2.0f, statsq_level(-1.0f, n)), 1.0f);
  __syncthreads();
  return k;
}

// The quotient steps of the LSQ code rint(clip(u, lo, hi)) (integers lo <
// hi): every thread, with a barrier after.  Step j < hi - lo lies near
// lo + j + 0.5; each is +1 and the code below every step is lo.  Writes q
// and returns how many; 0 past MAX_STEPS.
__device__ __forceinline__ int lsq_steps(float lo, float hi, float* q) {
  const int J = (int)(hi - lo);
  if (J > MAX_STEPS) return 0;
  const int j = threadIdx.x;
  if (j < J)
    q[j] = find_step(__fadd_rn(__fadd_rn(lo, (float)j), 0.5f), [&](float u) {
             return rintf(fminf(fmaxf(u, lo), hi));
           }).x;
  __syncthreads();
  return J;
}

// The B operand: W (K, N) fp32 row-major, columns n0 .. n0 + BN - 1, as
// odd codes in K-major tiles (row n, 64 k).  load(g, raw) brings step g's
// (stage g % KT's) rows into a raw slot ([64][BN] fp32; 16-byte cp.async
// when vec: N % 4 == 0 and W 16-byte aligned, else 4-byte); code_into turns
// a raw slot into codes (unit (row r, chunk c): 8 raw values of one
// column, neighbouring lanes on neighbouring columns), by steps (J > 0:
// t_tab[j * BN + r] where column r's step j starts, d[j] its size, base
// the code below them) or by division (rs_tab: 1 / s of the columns, fp64).
// Streaming: a ring of S raw slots and two code tiles, each step loaded
// and coded in the main loop.  Panel (the codes of every stage of the N
// tile fit in shared memory, KT code tiles): build() loads and codes them
// all before the main loop, through two raw slots in `scratch` (memory the
// main loop uses later), and the main loop loads and codes no W.
template <int BN, int S>
struct WCodes {
  const float* __restrict__ w;
  const double* rs_tab;
  const float* t_tab;
  const float* d;
  float base;
  int J;
  uint8_t* raw;    // streaming: S raw slots; panel: 2, in scratch
  uint8_t* codes;  // 2 code tiles, or KT (panel)
  int K, N, n0, KT;
  float n;
  bool vec, panel;

  __device__ __forceinline__ uint32_t tile(int g) const {
    return smem_u32(codes + (panel ? g % KT : g & 1) * b_bytes(BN));
  }

  __device__ __forceinline__ void load_into(uint8_t* slot, int kt) {
    float* dst = reinterpret_cast<float*>(slot);
    if (vec) {
      for (int i = threadIdx.x; i < BK * (BN / 4); i += THREADS) {
        const int kr = i / (BN / 4), cc = i % (BN / 4);
        const int gk = kt * BK + kr, gn = n0 + 4 * cc;
        const bool in = gk < K && gn < N;
        cp_async16(dst + kr * BN + 4 * cc,
                   in ? (const void*)(w + (size_t)gk * N + gn)
                      : (const void*)w,
                   in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
        const int kr = i / BN, cn = i % BN;
        const int gk = kt * BK + kr, gn = n0 + cn;
        const bool in = gk < K && gn < N;
        cp_async4(dst + kr * BN + cn,
                  in ? (const void*)(w + (size_t)gk * N + gn)
                     : (const void*)w,
                  in ? 4 : 0);
      }
    }
  }

  __device__ __forceinline__ void code_into(uint8_t* tile_p,
                                            const uint8_t* slot, int kt) {
    const float* src = reinterpret_cast<const float*>(slot);
    for (int u = threadIdx.x; u < BN * 8; u += THREADS) {
      const int r = u % BN, c = u / BN;
      const int gn = n0 + r, gk = kt * BK + 8 * c;
      float v[8];
      if (J > 0) {
        float wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          wv[e] = src[(8 * c + e) * BN + r];
          v[e] = base;
        }
        for (int j = 0; j < J; ++j) {
          const float t = t_tab[j * BN + r], dj = d[j];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += wv[e] >= t ? dj : 0.0f;
        }
      } else {
        const double rs = rs_tab[r];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = statsq_code(src[(8 * c + e) * BN + r], rs, n);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gn >= N || gk + e >= K) v[e] = 0.0f;
      st_chunk(tile_p, r, c, v);
    }
  }

  __device__ __forceinline__ void load(int g) {
    if (!panel) load_into(raw + (g % S) * wraw_bytes(BN), g % KT);
  }
  __device__ __forceinline__ void code(int g) {
    if (!panel)
      code_into(codes + (g & 1) * b_bytes(BN), raw + (g % S) * wraw_bytes(BN),
                g % KT);
  }

  // the panel: stage kt + 1 loads while stage kt is coded
  __device__ __forceinline__ void build() {
    load_into(raw, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT)
        load_into(raw + ((kt + 1) & 1) * wraw_bytes(BN), kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      code_into(codes + kt * b_bytes(BN), raw + (kt & 1) * wraw_bytes(BN), kt);
      __syncthreads();
    }
  }
};

template <int BN>
struct Wgmma;

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A and B K-major from shared
// memory (descriptors), D += A B (scale-d 1); the operand lists written out
template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The main loop over this block's T tiles of KT stages each, as one run
// of T * KT steps: acc (a multiplying warpgroup's 64 x BN fp32 tile) = the
// sum over a tile's stages of A (BM x 64) @ B (64 x BN), then epi(t)
// stores it.  Each operand has load(g) (cp.async of step g into its ring),
// code(g) (step g's codes into a code tile; nothing for a W kept in a
// panel) and tile(g) (the shared-memory address of step g's tile for
// wgmma).  Commit group g holds the loads of step g; S - 1 steps are in
// flight while step g is multiplied and step g + 1 coded, across tile
// boundaries, so a tile's epilogue overlaps the next tile's loads.  The
// tables (and a W panel) are ready when it starts.
template <int BN, int S, class OpA, class OpB, class Epi>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2], int KT, int T,
                                         OpA& a, OpB& b, Epi epi) {
  static_assert(S >= 2, "at least two raw slots");
  const int wg = threadIdx.x / 128;
  const bool mma = wg < MMA_WGS;  // uniform over a warpgroup
  const int steps = T * KT;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (k < steps) {
      a.load(k);
      b.load(k);
    }
    cp_async_commit();
  }
  cp_async_wait<S - 1>();
  __syncthreads();
  a.code(0);
  b.code(0);
  for (int g = 0; g < steps; ++g) {
    const int kt = g % KT;
    // step g's codes complete and visible to the tensor cores, raw step
    // g + 1 landed; every warpgroup past the product of step g - 1, so its
    // tiles are free
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();
    if (mma) {
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      }
      fence_acc(acc);
      wgmma_fence();
      const uint32_t a0 = a.tile(g) + wg * 64 * 128, b0 = b.tile(g);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<BN>::mma(acc, desc(a0 + 32 * kk), desc(b0 + 32 * kk));
      wgmma_commit();
      fence_acc(acc);
    }
    if (g + 1 < steps) {
      a.code(g + 1);
      b.code(g + 1);
    }
    // raw slot g % S was coded in the last iteration (or before the loop)
    if (g + S < steps) {
      a.load(g + S);
      b.load(g + S);
    }
    cp_async_commit();
    if (mma) {
      wgmma_wait_all();
      fence_acc(acc);
      if (kt == KT - 1) epi(g / KT);
    }
  }
}

// The accumulator fragment of m64nNk16 (f32): thread t of warpgroup wg
// holds, for each 8-column group j, (row, col) = (r0, 8j + c0) and
// (r0, 8j + c0 + 1) in acc[4j], acc[4j + 1], and row r0 + 8 in acc[4j + 2],
// acc[4j + 3], with r0 = 64 wg + 16 (t / 32) + (t % 32) / 4 and
// c0 = 2 (t % 4).  f(row, col, v_col, v_col_plus_1) for each pair.
template <int BN, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[BN / 2],
                                              F f) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int r0 = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int c0 = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    f(r0, 8 * j + c0, acc[4 * j], acc[4 * j + 1]);
    f(r0 + 8, 8 * j + c0, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace tc
