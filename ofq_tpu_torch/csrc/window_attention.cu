// The Swin window-attention tail, per (window, head) unit: K6, K7, K8.
//
// Replaces the three Pallas kernels of benchmarks/window_attn_lab.py, which
// compute one function three ways (lab shapes: Swin-T stage 0 at batch 64,
// Bn = 4096 windows of n = 49 tokens, H = 3 heads of d = 32, bf16):
//   K6  _mk_kernel (pallas_units):       WB windows per program, one
//       (window, head) unit at a time;
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
// attention: a (token, head) row of 32 values is 64 contiguous bytes.
//
// What bounds it on an H100: 4 * Bn*49*H*32 * 2 bytes (154.1 MB at the lab
// shape, 0.046 ms at 3.35 TB/s) against 4 * Bn*H*49*49*32 operations
// (3.78 G, 0.004 ms on the bf16 tensor cores): bytes.  This first version
// runs on the CUDA cores: one warp per query row of a unit; lane j holds
// the scores of key columns j and j + 32 (k-ordered fp32 sums, the product
// of two bf16 values being exact in fp32), the row max and sum are warp
// shuffles, and lane j then sums output column j over the 49 keys.  The
// (Bn, H, 49, 49) scores never leave the SM.  What tells the three apart
// is how the units' operands sit in shared memory:
//   K6 (kUnits):   one window's H units per pass, 49 rows, widened to fp32
//                  rows of 33 words (conflict-free for row-per-lane reads);
//   K7 (kPacked):  P units per pass, 64 rows (zero-padded), bf16 packed
//                  densely, k stored transposed (the lab's K_cat^T), so
//                  column-per-lane reads are conflict-free; the transposing
//                  stores conflict instead;
//   K8 (kAligned): P units per pass, 64 rows, bf16, each operand row in its
//                  own 80-byte slot (each unit an aligned tile); global and
//                  shared accesses are 16-byte vectors, conflict-free.
// The block-diagonal zero blocks of K7 and K8 only amortized the MXU's
// per-dot overhead; they are not built here.  K7 and K8 also run the 15
// padded query rows of each unit, as the lab kernels do, and drop them at
// the store.
// A thread block has 8 warps and runs WB windows (WB * H units).
//
// Rounding: __f*_rn where a contraction could move a value, expf (not
// __expf), __fdiv_rn; no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N = 49;        // tokens per window
constexpr int D = 32;        // head width
constexpr int NP = 64;       // tokens padded (K7, K8)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kUnits = 0, kPacked = 1, kAligned = 2;
constexpr int FSTRIDE = D + 1;   // K6: fp32 row, in words
constexpr int ASTRIDE = 40;      // K8: bf16 row slot (80 bytes)

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the eight bf16 values of a 16-byte vector, as floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = bf(h[i]);
}

// Shared-memory operands of the units of one pass and the scores of one
// query row (lane: key columns lane and lane + 32; keys >= 49 read 0).
template <int V>
struct Tile;

template <>
struct Tile<kUnits> {
  static constexpr int ROWS = N;
  float* q;  // [unit][49][33]
  float* k;
  float* v;
  __device__ Tile(char* smem, int units) {
    q = reinterpret_cast<float*>(smem);
    k = q + units * N * FSTRIDE;
    v = k + units * N * FSTRIDE;
  }
  static size_t bytes(int units) { return (size_t)3 * units * N * FSTRIDE * 4; }
  __device__ void put(int which, int u, int n, int dd, __nv_bfloat16 x) {
    float* t = which == 0 ? q : which == 1 ? k : v;
    t[(u * N + n) * FSTRIDE + dd] = bf(x);
  }
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
  __device__ float val(int u, int m, int dd) const {
    return v[(u * N + m) * FSTRIDE + dd];
  }
};

template <>
struct Tile<kPacked> {
  static constexpr int ROWS = NP;
  __nv_bfloat16* q;   // [unit][64][32]
  __nv_bfloat16* kt;  // [unit][32][64]
  __nv_bfloat16* v;   // [unit][64][32]
  __device__ Tile(char* smem, int units) {
    q = reinterpret_cast<__nv_bfloat16*>(smem);
    kt = q + units * NP * D;
    v = kt + units * NP * D;
  }
  static size_t bytes(int units) { return (size_t)3 * units * NP * D * 2; }
  __device__ void put(int which, int u, int n, int dd, __nv_bfloat16 x) {
    if (which == 1)
      kt[(u * D + dd) * NP + n] = x;
    else
      (which == 0 ? q : v)[(u * NP + n) * D + dd] = x;
  }
  __device__ void scores(int u, int r, int lane, float& s0, float& s1) const {
    const __nv_bfloat16* qr = q + (u * NP + r) * D;
    const __nv_bfloat16* kc = kt + u * D * NP;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float qd = bf(qr[dd]);
      s0 = fmaf(qd, bf(kc[dd * NP + lane]), s0);
      s1 = fmaf(qd, bf(kc[dd * NP + lane + 32]), s1);
    }
  }
  __device__ float val(int u, int m, int dd) const {
    return bf(v[(u * NP + m) * D + dd]);
  }
};

template <>
struct Tile<kAligned> {
  static constexpr int ROWS = NP;
  __nv_bfloat16* q;  // [unit][64][40], 16-byte aligned rows
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  __device__ Tile(char* smem, int units) {
    q = reinterpret_cast<__nv_bfloat16*>(smem);
    k = q + units * NP * ASTRIDE;
    v = k + units * NP * ASTRIDE;
  }
  static size_t bytes(int units) {
    return (size_t)3 * units * NP * ASTRIDE * 2;
  }
  // 16-byte chunk c (8 values) of row n of unit u
  __device__ uint4* chunk(int which, int u, int n, int c) const {
    __nv_bfloat16* t = which == 0 ? q : which == 1 ? k : v;
    return reinterpret_cast<uint4*>(t + (u * NP + n) * ASTRIDE + 8 * c);
  }
  __device__ void scores(int u, int r, int lane, float& s0, float& s1) const {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      float qf[8], k0[8], k1[8];
      unpack8(*chunk(0, u, r, c), qf);
      unpack8(*chunk(1, u, lane, c), k0);
      unpack8(*chunk(1, u, lane + 32, c), k1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s0 = fmaf(qf[i], k0[i], s0);
        s1 = fmaf(qf[i], k1[i], s1);
      }
    }
  }
  __device__ float val(int u, int m, int dd) const {
    return bf(v[(u * NP + m) * ASTRIDE + dd]);
  }
};

// One query row r of unit u: softmax of its scores, then the output row,
// stored to `orow` (32 values) when r < 49.
template <int V>
__device__ __forceinline__ void row(const Tile<V>& t, int u, int r, float sm,
                                    __nv_bfloat16* __restrict__ orow,
                                    int lane) {
  float s0 = 0.0f, s1 = 0.0f;
  t.scores(u, r, lane, s0, s1);
  const bool ok1 = lane + 32 < N;  // key columns >= 49: -inf
  s0 = __fmul_rn(s0, sm);
  s1 = ok1 ? __fmul_rn(s1, sm) : -INFINITY;
  float m = fmaxf(s0, s1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  const float e0 = expf(__fsub_rn(s0, m));
  const float e1 = ok1 ? expf(__fsub_rn(s1, m)) : 0.0f;
  float sum = __fadd_rn(e0, e1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
  const float p0 = round_bf16(__fdiv_rn(e0, sum));
  const float p1 = round_bf16(__fdiv_rn(e1, sum));
  float acc = 0.0f;
#pragma unroll 7
  for (int mm = 0; mm < N; ++mm) {
    const float pm = __shfl_sync(FULL, mm < 32 ? p0 : p1, mm & 31);
    acc = fmaf(pm, t.val(u, mm, lane), acc);
  }
  if (r < N) orow[lane] = __float2bfloat16_rn(acc);
}

// element offset of (window b, token n, head h, column 0)
__device__ __forceinline__ size_t offset(int b, int n, int h, int H) {
  return ((size_t)(b * N + n) * H + h) * D;
}

// Grid: Bn / WB blocks.  Each pass loads `units` units (K6: the H units of
// one window; K7, K8: P units, unit u of the block being window u / H,
// head u % H, as the lab's `_units` orders them), then runs its
// units * ROWS query rows, one warp each.
template <int V>
__global__ void __launch_bounds__(THREADS) window_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int H, int WB, int P, float sm) {
  extern __shared__ __align__(16) char smem[];
  const int units = V == kUnits ? H : P;
  Tile<V> t(smem, units);
  constexpr int ROWS = Tile<V>::ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0_block = blockIdx.x * WB * H;  // first unit of this block
  const int passes = WB * H / units;

  for (int pass = 0; pass < passes; ++pass) {
    const int u0 = u0_block + pass * units;  // global unit index
    if constexpr (V == kAligned) {
      // 16-byte vectors: 4 per (unit, row), rows >= 49 zero
      for (int e = tid; e < 3 * units * NP * 4; e += THREADS) {
        const int c = e & 3, n = (e >> 2) % NP, uw = (e >> 2) / NP;
        const int which = uw / units, u = uw % units;
        const int gu = u0 + u;
        const __nv_bfloat16* g = which == 0 ? q : which == 1 ? k : v;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (n < N)
          val = *reinterpret_cast<const uint4*>(
              g + offset(gu / H, n, gu % H, H) + 8 * c);
        *t.chunk(which, u, n, c) = val;
      }
    } else {
      // elementwise: consecutive threads read consecutive columns
      for (int e = tid; e < 3 * units * ROWS * D; e += THREADS) {
        const int dd = e % D, n = (e / D) % ROWS, uw = e / (D * ROWS);
        const int which = uw / units, u = uw % units;
        const int gu = u0 + u;
        const __nv_bfloat16* g = which == 0 ? q : which == 1 ? k : v;
        const __nv_bfloat16 x = n < N ? g[offset(gu / H, n, gu % H, H) + dd]
                                      : __float2bfloat16_rn(0.0f);
        t.put(which, u, n, dd, x);
      }
    }
    __syncthreads();
    for (int task = warp; task < units * ROWS; task += WARPS) {
      const int u = task / ROWS, r = task % ROWS;
      const int gu = u0 + u;
      __nv_bfloat16* orow =
          out + offset(gu / H, r < N ? r : 0, gu % H, H);
      row<V>(t, u, r, sm, orow, lane);
    }
    __syncthreads();
  }
}

template <int V>
int launch(const void* q, const void* k, const void* v, void* out, int Bn,
           int H, int WB, int P, float sm, void* stream) {
  const size_t smem = Tile<V>::bytes(V == kUnits ? H : P);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attn_kernel<V><<<Bn / WB, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, WB, P, sm);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of variant `variant` (0: K6, 1: K7,
// 2: K8) for H heads and P units per pass.
extern "C" long long ofq_window_attn_smem(int variant, int H, int P) {
  switch (variant) {
    case kUnits: return (long long)Tile<kUnits>::bytes(H);
    case kPacked: return (long long)Tile<kPacked>::bytes(P);
    default: return (long long)Tile<kAligned>::bytes(P);
  }
}

// K6, K7, K8.  q, k, v, out: (Bn, 49, H, 32) bf16, contiguous, 16-byte
// aligned; Bn % WB == 0; (WB * H) % P == 0 (K6 ignores P).
extern "C" int ofq_window_attn_units(const void* q, const void* k,
                                     const void* v, void* out, int Bn, int H,
                                     int WB, int P, float sm, void* stream) {
  return launch<kUnits>(q, k, v, out, Bn, H, WB, P, sm, stream);
}

extern "C" int ofq_window_attn_packed(const void* q, const void* k,
                                      const void* v, void* out, int Bn, int H,
                                      int WB, int P, float sm, void* stream) {
  return launch<kPacked>(q, k, v, out, Bn, H, WB, P, sm, stream);
}

extern "C" int ofq_window_attn_packed_aligned(const void* q, const void* k,
                                              const void* v, void* out,
                                              int Bn, int H, int WB, int P,
                                              float sm, void* stream) {
  return launch<kAligned>(q, k, v, out, Bn, H, WB, P, sm, stream);
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
