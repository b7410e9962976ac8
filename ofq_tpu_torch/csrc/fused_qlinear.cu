// Fused QLinear forward: LSQ activation codes x StatsQ weight codes.
//
// Replaces the Pallas kernel ofq_tpu/ops/fused_qlinear.py:_fwd_kernel
// (called by _fwd_call, reached through fused_qlinear).  Per output tile:
//
//   u   = (x + b_pre) / s_tok[r % n_tok]
//   XI  = rint(clip(u, a_lo, a_hi))                      LSQ integer codes
//   WI  = 2 * rint(clip(w / s_w, -1, 1 - 1e-6) * n - 0.5) + 1   odd StatsQ codes
//   acc = XI @ WI
//   y   = acc * s_tok[r] * (s_w[c] / (2n)) + bvec[c]
//
// s_w = 2 mean|W| per column and bvec = b_post @ Wq + bias come from the
// caller, as in JAX.  Both code sets are formed from fp32 x and W brought
// into shared memory by cp.async, turned into codes by the threads (step
// tables per token and per column, tc_gemm.cuh) and stored as bf16 into
// the swizzled shared-memory layout that the wgmma descriptor reads; they
// never reach device memory.  The product is wgmma m64nNk16 bf16 x bf16 ->
// fp32 (tc_gemm.cuh): LSQ codes (|XI| <= 2^(bits-1)) and odd StatsQ codes
// (|WI| <= 2n - 1) are small integers, exact in bf16, every product exact,
// and every partial sum an integer below 2^24 as long as
// K * max|XI| * max|WI| < 2^24 (W2A2 at K = 1536: 9 216; W4A4: 184 320),
// so the sum is exact in any order and the kernel gives its plain
// version's bits.  Past that bound (W8A8 at K = 1536: 1536 * 128 * 255) a
// partial sum can round, in the tensor cores' order rather than the plain
// version's: the 1e-5 max|ref| gate of chip_smoke.py's phase_k1 covers
// that case; it is not refused.
//
// What bounds it on an H100: at DeiT-S widths (M = 64*198, K, N in
// {384, 1536}) the product is 2 M K N operations against 4 (MK + KN + MN)
// bytes, bytes-bound at the bf16 rate (~0.012-0.03 ms).  Besides the
// product the kernel forms the LSQ codes of its x tile once per output
// tile (N / BN times over the whole x) and the StatsQ codes of its N tile
// once per block where they fit in shared memory (a panel: K up to 384 at
// BN 128), else once per M tile; blocks are persistent, one per SM, each
// on one N tile.
//
// Rounding: rintf rounds half to even like torch.round / jnp.round (CUDA's
// roundf would round half away from zero).  StatsQ's c*n - 0.5 sits on a
// tie whenever c*n is an integer, so every multiply-add whose rounding
// feeds a rint is spelled with __fmul_rn / __fadd_rn: nvcc may not
// contract them into an FMA.  Correctly rounded division (no
// --use_fast_math; tc::div_rn, the bits of __fdiv_rn).  The epilogue keeps
// the first version's order:
// __fadd_rn(__fmul_rn(__fmul_rn(acc, s_tok[r]), s_w[c] / (2n)), bvec[c]).

#include <cuda_runtime.h>
#include <stddef.h>

#include "tc_gemm.cuh"

namespace {

// The A operand: x (M, K) fp32 as LSQ codes.  load(g) brings step g (the
// rows of its M tile, the k of its stage) raw into ring slot g % S
// ([128][64] fp32; 16-byte cp.async when vec: K % 4 == 0 and x 16-byte
// aligned, else 4-byte); code(g) forms the codes from a = x + b_pre (unit
// (row r, chunk c): 8 neighbouring k) and the tables of the row's token
// (steps when J > 0: t_tok[j * n_tok + token] where step j starts, each +1
// from a_lo; else the division by rr_tok, 1 / s_tok in fp64) and stores
// them into code tile g % 2.
template <int S>
struct XCodes {
  const float* __restrict__ x;
  const double* rr_tok;
  const float* t_tok;
  const float* bp_tab;  // b_pre, zero past K
  uint8_t* raw;         // S raw slots
  uint8_t* codes;       // 2 code tiles
  int M, K, KT, n_tok, J;
  float a_lo, a_hi;
  bool vec;

  __device__ __forceinline__ uint32_t tile(int g) const {
    return tc::smem_u32(codes + (g & 1) * tc::A_BYTES);
  }

  __device__ __forceinline__ void load(int g) {
    float* dst = reinterpret_cast<float*>(raw + (g % S) * tc::XRAW_BYTES);
    const int m0 = tc::tile_m0(g / KT), k0 = (g % KT) * tc::BK;
    if (vec) {
      for (int i = threadIdx.x; i < tc::BM * (tc::BK / 4); i += tc::THREADS) {
        const int r = i / (tc::BK / 4), cc = i % (tc::BK / 4);
        const int gm = m0 + r, gk = k0 + 4 * cc;
        const bool in = gm < M && gk < K;
        tc::cp_async16(dst + r * tc::BK + 4 * cc,
                       in ? (const void*)(x + (size_t)gm * K + gk)
                          : (const void*)x,
                       in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < tc::BM * tc::BK; i += tc::THREADS) {
        const int r = i / tc::BK, ck = i % tc::BK;
        const int gm = m0 + r, gk = k0 + ck;
        const bool in = gm < M && gk < K;
        tc::cp_async4(dst + r * tc::BK + ck,
                      in ? (const void*)(x + (size_t)gm * K + gk)
                         : (const void*)x,
                      in ? 4 : 0);
      }
    }
  }

  __device__ __forceinline__ void code(int g) {
    const float* src =
        reinterpret_cast<const float*>(raw + (g % S) * tc::XRAW_BYTES);
    uint8_t* tile_p = codes + (g & 1) * tc::A_BYTES;
    const int m0 = tc::tile_m0(g / KT), k0 = (g % KT) * tc::BK;
    for (int u = threadIdx.x; u < tc::BM * 8; u += tc::THREADS) {
      const int r = u / 8, c = u % 8;
      const int gm = m0 + r, gk = k0 + 8 * c;
      const int tk = gm % n_tok;
      const float4 x0 =
          *reinterpret_cast<const float4*>(src + r * tc::BK + 8 * c);
      const float4 x1 =
          *reinterpret_cast<const float4*>(src + r * tc::BK + 8 * c + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float av[8], v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) av[e] = __fadd_rn(xv[e], bp_tab[gk + e]);
      if (J > 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = a_lo;
        for (int j = 0; j < J; ++j) {
          const float t = t_tok[j * n_tok + tk];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += av[e] >= t ? 1.0f : 0.0f;
        }
      } else {
        const double rr = rr_tok[tk];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = rintf(fminf(fmaxf(tc::div_rn(av[e], rr), a_lo), a_hi));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gm >= M || gk + e >= K) v[e] = 0.0f;
      tc::st_chunk(tile_p, r, c, v);
    }
  }
};

// raw slots of each streamed operand: the deepest of these that fits
constexpr int K1_STAGES[] = {3, 2};

// the code step candidates: StatsQ's 2n, LSQ's a_hi - a_lo; none (the
// division per element) past MAX_STEPS
__host__ __device__ inline int statsq_step_count(float n_w) {
  return 2 * (int)n_w <= tc::MAX_STEPS ? 2 * (int)n_w : 0;
}
__host__ __device__ inline int lsq_step_count(float a_lo, float a_hi) {
  return (int)(a_hi - a_lo) <= tc::MAX_STEPS ? (int)(a_hi - a_lo) : 0;
}

// The shared memory of a launch, by region: the raw x ring (which the W
// panel is built through first), the x code tiles, the raw W ring
// (streaming), the W code tiles (two, or KT in a panel), the tables (per
// column 1 / s_w in fp64, s_w / (2n), bvec; per token 1 / s_tok in fp64,
// s_tok; b_pre over the padded contraction; the steps, their sizes, the
// base W code; the columns' (Jw) and tokens' (Jx) step starts).
struct K1Smem {
  int x_raw, x_codes, w_raw, w_codes, tables, total;
};
__host__ __device__ inline K1Smem k1_smem(int bn, int KT, bool panel,
                                          int n_tok, int Jw, int Jx, int S) {
  K1Smem m;
  const int ring = S * tc::XRAW_BYTES;
  m.x_raw = 0;
  m.x_codes = panel && 2 * tc::wraw_bytes(bn) > ring ? 2 * tc::wraw_bytes(bn)
                                                      : ring;
  m.w_raw = panel ? 0 : m.x_codes + 2 * tc::A_BYTES;
  m.w_codes = m.x_codes + 2 * tc::A_BYTES +
              (panel ? 0 : S * tc::wraw_bytes(bn));
  m.tables = m.w_codes + (panel ? KT : 2) * tc::b_bytes(bn);
  m.total = m.tables +
            4 * (4 * bn + 3 * n_tok + KT * tc::BK + 2 * tc::MAX_STEPS + 4 +
                 Jw * bn + Jx * n_tok) +
            1024;
  return m;
}

// K1's tile width for (N, K): a width whose W panel fits first, then the
// one that pads N least, then the widest; and whether it takes the panel
inline int k1_pick(int N, int K, int n_tok, int Jw, int Jx, bool* panel) {
  const int KT = (K + tc::BK - 1) / tc::BK;
  int best = 0;
  long best_pad = 0;
  bool best_panel = false;
  const int widths[] = {128, 96, 64};
  for (int bn : widths) {
    const bool p = k1_smem(bn, KT, true, n_tok, Jw, Jx, 2).total <=
                   tc::SMEM_LIMIT;
    const long pad = (long)(N + bn - 1) / bn * bn;
    if (best == 0 || (p && !best_panel) ||
        (p == best_panel && pad < best_pad)) {
      best = bn;
      best_pad = pad;
      best_panel = p;
    }
  }
  *panel = best_panel;
  return best;
}

// y (M, N) fp32; persistent blocks, grid (nt, G) from tc::launch_shape,
// each walking `tiles` M tiles of its N tile
template <int TBN, int S>
__global__ void __launch_bounds__(tc::THREADS, 1) fused_qlinear_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ s_tok, int n_tok,
    const float* __restrict__ b_pre, const float* __restrict__ w,
    const float* __restrict__ s_w, const float* __restrict__ bvec,
    float* __restrict__ y, int M, int K, int N, float a_lo, float a_hi,
    float n_w, int vec_x, int vec_w, int tiles, int panel) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc::aligned_smem(smem_raw);
  const int KT = (K + tc::BK - 1) / tc::BK;
  const int Jw_max = statsq_step_count(n_w);
  const K1Smem m = k1_smem(TBN, KT, panel != 0, n_tok, Jw_max,
                           lsq_step_count(a_lo, a_hi), S);
  double* rw_tab = reinterpret_cast<double*>(smem + m.tables);
  double* rr_tok = rw_tab + TBN;
  float* f_tab = reinterpret_cast<float*>(rr_tok + n_tok);
  float* bv_tab = f_tab + TBN;
  float* rs_tok = bv_tab + TBN;
  float* bp_tab = rs_tok + n_tok;
  float* qw_st = bp_tab + KT * tc::BK;
  float* dw_st = qw_st + tc::MAX_STEPS;
  float* w_base = dw_st + tc::MAX_STEPS;
  float* tw_tab = w_base + 4;
  float* tx_tok = tw_tab + Jw_max * TBN;
  __shared__ float qx_st[tc::MAX_STEPS];
  const int n0 = blockIdx.x * TBN;
  const float two_n = 2.0f * n_w;
  for (int i = threadIdx.x; i < TBN; i += tc::THREADS) {
    const bool in = n0 + i < N;
    const float sc = in ? s_w[n0 + i] : 1.0f;
    rw_tab[i] = tc::rcp64(sc);
    f_tab[i] = __fdiv_rn(sc, two_n);
    bv_tab[i] = in ? bvec[n0 + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < n_tok; i += tc::THREADS) {
    rs_tok[i] = s_tok[i];
    rr_tok[i] = tc::rcp64(s_tok[i]);
  }
  for (int i = threadIdx.x; i < KT * tc::BK; i += tc::THREADS)
    bp_tab[i] = i < K ? b_pre[i] : 0.0f;
  const int Jw = tc::statsq_steps(n_w, qw_st, dw_st, w_base);
  const int Jx = tc::lsq_steps(a_lo, a_hi, qx_st);
  for (int i = threadIdx.x; i < Jw * TBN; i += tc::THREADS) {
    const int j = i / TBN, r = i % TBN;
    tw_tab[i] = tc::step_start(qw_st[j], n0 + r < N ? s_w[n0 + r] : 1.0f,
                               rw_tab[r]);
  }
  for (int i = threadIdx.x; i < Jx * n_tok; i += tc::THREADS) {
    const int j = i / n_tok, tk = i % n_tok;
    tx_tok[i] = tc::step_start(qx_st[j], rs_tok[tk], rr_tok[tk]);
  }
  __syncthreads();
  float acc[TBN / 2];
  XCodes<S> a{x,  rr_tok, tx_tok, bp_tab, smem + m.x_raw, smem + m.x_codes,
              M,  K,      KT,     n_tok,  Jx,             a_lo,
              a_hi, vec_x != 0};
  tc::WCodes<TBN, S> b{w,       rw_tab,         tw_tab,    dw_st,
                       *w_base, Jw,             smem + m.w_raw,
                       smem + m.w_codes,        K,         N,
                       n0,      KT,             n_w,       vec_w != 0,
                       panel != 0};
  if (b.panel) b.build();
  const bool pairs = (N & 1) == 0;
  tc::mainloop<TBN, S>(acc, KT, tiles, a, b, [&](int t) {
    const int m0 = tc::tile_m0(t);
    tc::for_each_pair<TBN>(acc, [&](int r, int c, float v0, float v1) {
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) return;
      const float sr = rs_tok[gm % n_tok];
      float* out = y + (size_t)gm * N + gn;
      const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(v0, sr), f_tab[c]),
                                 bv_tab[c]);
      const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(v1, sr), f_tab[c + 1]),
                                 bv_tab[c + 1]);
      if (pairs) {
        *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
      } else {
        out[0] = y0;
        if (gn + 1 < N) out[1] = y1;
      }
    });
  });
}

// the deepest ring that fits beside the rest
inline int k1_stages(int bn, int KT, bool panel, int n_tok, int Jw, int Jx) {
  for (int S : K1_STAGES)
    if (k1_smem(bn, KT, panel, n_tok, Jw, Jx, S).total <= tc::SMEM_LIMIT)
      return S;
  return 0;
}

template <int TBN>
int launch_tc(const float* x, const float* s_tok, int n_tok,
              const float* b_pre, const float* w, const float* s_w,
              const float* bvec, float* y, int M, int K, int N, float a_lo,
              float a_hi, float n_w, bool panel, void* stream) {
  const bool vec_x = K % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_w = N % 4 == 0 && ((uintptr_t)w & 15) == 0;
  const int KT = (K + tc::BK - 1) / tc::BK;
  const int Jw = statsq_step_count(n_w), Jx = lsq_step_count(a_lo, a_hi);
  const int S = k1_stages(TBN, KT, panel, n_tok, Jw, Jx);
  const tc::Launch l = tc::launch_shape(M, N, TBN);
#define OFQ_K1_STAGES(SS)                                                   \
  case SS:                                                                  \
    return tc::launch(fused_qlinear_tc_kernel<TBN, SS>, l,                  \
                      k1_smem(TBN, KT, panel, n_tok, Jw, Jx, SS).total,     \
                      stream, x, s_tok, n_tok, b_pre, w, s_w, bvec, y, M,  \
                      K, N, a_lo, a_hi, n_w, vec_x ? 1 : 0, vec_w ? 1 : 0, \
                      l.tiles, panel ? 1 : 0);
  switch (S) {
    OFQ_K1_STAGES(3)
    OFQ_K1_STAGES(2)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OFQ_K1_STAGES
}

}  // namespace

// K1 with the tile width of k1_pick (and its W panel where that fits)
extern "C" int ofq_fused_qlinear_fwd(const float* x, const float* s_tok,
                                     int n_tok, const float* b_pre,
                                     const float* w, const float* s_w,
                                     const float* bvec, float* y, int M,
                                     int K, int N, float a_lo, float a_hi,
                                     float n_w, void* stream) {
  bool panel = false;
  const int bn = k1_pick(N, K, n_tok, statsq_step_count(n_w),
                         lsq_step_count(a_lo, a_hi), &panel);
#define OFQ_K1_CASE(B)                                                      \
  case B:                                                                   \
    return launch_tc<B>(x, s_tok, n_tok, b_pre, w, s_w, bvec, y, M, K, N, \
                        a_lo, a_hi, n_w, panel, stream);
  switch (bn) {
    OFQ_K1_CASE(64)
    OFQ_K1_CASE(96)
    OFQ_K1_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OFQ_K1_CASE
}

// The launch K1 takes for these shapes on the current card.  out: BN,
// grid x, grid y, M tiles per block, panel, raw slots
extern "C" void ofq_fused_qlinear_shape(int M, int K, int N, int n_tok,
                                        float a_lo, float a_hi, float n_w,
                                        int* out) {
  bool panel = false;
  const int bn = k1_pick(N, K, n_tok, statsq_step_count(n_w),
                         lsq_step_count(a_lo, a_hi), &panel);
  const tc::Launch l = tc::launch_shape(M, N, bn);
  out[0] = bn;
  out[1] = (int)l.grid.x;
  out[2] = (int)l.grid.y;
  out[3] = l.tiles;
  out[4] = panel ? 1 : 0;
  out[5] = k1_stages(bn, (K + tc::BK - 1) / tc::BK, panel, n_tok,
                     statsq_step_count(n_w), lsq_step_count(a_lo, a_hi));
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
