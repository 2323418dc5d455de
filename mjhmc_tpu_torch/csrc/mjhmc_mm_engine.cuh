// Fused MJHMC, control HMC, MALT and NUTS engines for the matmul energies
// on Hopper (sm_90a): a whole sampling run in one launch. This header holds
// the kernels as templates; mjhmc_mm_engine.cu compiles the C entry and the
// product-of-t instances at full f32, and the mm_engine_*.cu, mm_nuts_*.cu
// and mm_sweep.cu sources the other instances (the list at the end of this
// header), each by its own nvcc (ops/_build.py).
//
// Replaces the TPU kernels _mjhmc_mm_kernel and _mjhmc_mm_stream_kernel
// (mjhmc_tpu/ops/pallas_mjhmc.py:1265 and :1596) with the step bodies
// _make_step (:714, "mjhmc"), _make_step_control (:863), _make_step_malt
// (:938) and _make_step_nuts (:1011; nuts_mm_kernel below), the
// ProductOfTSpec (:379), SparseCodingSpec (:468) and LogregSpec (:519)
// energies, their dot precisions (MatmulEnergySpec._dot, :282-375), a
// diagonal inverse mass and the two-stage integrator. One
// templated kernel serves the first three bodies: EMIT=false is the run,
// EMIT=true also streams every thin-th iteration's x (MJHMC:
// pre-transition, with its dwell weight; the others: post-transition,
// weight 1) and cumulative evals with plain coalesced stores (no row
// padding).
//
// Design: a block owns a tile of chains. It loads the parameter matrix
// (W, or Φ and the patch) into shared memory once, in both orientations,
// so that each contraction reads it along contiguous rows. The trajectories
// of the tile are the NC = 2C columns of (d, NC) arrays X, V, G in shared
// memory: MJHMC spends them on the forward and backward trajectories of C
// chains, control and MALT (forward trajectories only) on 2C chains, so all
// three bodies run the same tile width. Every leapfrog step runs the
// energy's two contractions over all NC columns at once (product of t: y =
// Wᵀx, then W·dU/dy; sparse coding: r = patch − Φa, then Φᵀr; logistic
// regression: z = Xs·θ, then Xsᵀσ(z)), all through contract() at the
// instance's precision P, with __syncthreads() between the
// phases; a two-stage step is two of them with its own kick coefficients,
// and no pair form (both contractions per gradient, as the TPU body sets
// use_pair false there). The endpoint energies reuse the last step's y or
// r; MALT takes U after every step from the same contraction's y or r (its
// Δ sum), as the JAX body relies on CSE for. The current point (x, v, g)
// and the Kahan pairs of each (dim, chain) element live in registers of
// the thread that owns the element; the per-chain scalars (u, h_back,
// valid, Σw, evals; MALT's running U and Δ) in registers of one thread per
// chain. The inverse mass sits in shared memory (rows M^-1 and sqrt(M),
// 1.0 without a mass, which multiplies exactly).
//
// Precisions (P, JAX's names): kHighest sums each thread's 4×4 register
// tile in FP32 FMA (the 4×4 tiles give each thread 16 independent FMA
// chains per shared-memory load pair; the warps of a tile read the same
// matrix row, broadcast, and neighbouring columns of the state). kBf16x3,
// kBf16x2 and kDefault run hand-written mma.sync.m16n8k16 bf16 -> f32
// passes (mma_bf16.cuh): warps own m16n8 output tiles, the parameter rows
// on m and the 32 columns on n. The parameter matrix is split into bf16 hi
// and lo once per block (load_params) and kept in shared memory in A-
// fragment order for both contractions, zero-padded to multiples of 16
// (product of t's 36 to 48); the state operand (X, dU/dy, the residual,
// σ(z)) is split as its B fragments load, 0 past its last row, so the f32
// layout keeps its strides. bf16x3 is hi·hi + (hi·lo + lo·hi) in three
// accumulators added as JAX adds them (_dot_bf16x3, :312); bf16x2 is
// hi·(hi + lo) of the state with the parameter rounded once (_dot_bf16x2,
// :337); default one pass with both operands rounded (the TPU's
// Precision.DEFAULT). The f32 copies of the parameter matrix exist only in
// the kHighest instances (sparse coding at bf16x3 holds ~124 KB, as at
// kHighest: its two bf16 copies take the f32 copies' 64 KB).
//
// What bounds it: at kHighest the FP32 FMA throughput in the contractions
// (~3.3e5 multiply-adds per chain and iteration for sparse coding at M=10,
// ~1.3e4 for product of t at M=5). In the bf16 instances the 1-3 mma
// passes per 16×8×16 tile are cheap, and the B fragments' strided f32
// loads (lanes 2q apart in k hit the same bank) and splits take their
// place, so they run near the FP32 path's time (PERF.md §6). At every
// precision: the elementwise work, the latency of the 3M+4 block barriers
// per iteration (MALT adds four per step; two-stage doubles the
// contractions), and shared memory per block (one sparse-coding block per
// SM), which caps the warps an SM holds.
// MALT also draws (2M+1)·d normals per chain and iteration, each from two
// Philox blocks (the owner of element (i, chain) computes words i and
// d+i), which at product of t's small k is comparable to the contractions.
// Control and MALT hold twice the (dim, chain) elements per thread (16 at
// sparse coding), which raises register pressure.
//
// Random numbers: Philox4x32-10 keyed (seed, 0), laid out in philox.cuh:
// MJHMC counter (chain, iteration, block, 0), 1 + 2d words per iteration
// (word 0 picks the clock, drawn by the chain's thread; words 1+i and 1+d+i
// make dim i's Box-Muller normal, drawn by the thread owning element (i,
// chain)); NUTS tags 1-3 (momentum, round, leaf) as the elementwise kernel
// draws them; control tag 4, MALT tags 5 and 6, each normal from words i
// and d+i and the Metropolis uniform from word 2d. The plain PyTorch version
// (ops/cuda_mjhmc.py) computes the same words. No fast-math: the Kahan sums
// and the plain-version comparisons need IEEE arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "philox.cuh"

namespace mjhmc {
namespace mm {

using tc::mma_bf16;
using tc::split_bf16;

constexpr float kLogRateMax = 25.0f;
constexpr float kNegInf = -1e30f;
constexpr float kTwoPi = 6.283185307179586f;

enum Energy { kProductOfT = 0, kSparseCoding = 1, kLogreg = 2 };
enum Choice { kL = 0, kF = 1, kR = 2 };
// the step bodies, numbered as the elementwise kernel's
enum Variant { kMjhmc = 0, kNuts = 1, kControl = 2, kMalt = 3 };
// the dot precisions, numbered as cuda_mjhmc.PRECISIONS
enum Precision { kHighest = 0, kBf16x3 = 1, kBf16x2 = 2, kDefault = 3 };

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// BCSS two-stage coefficient b and 1 - 2b, rounded to float once
constexpr float kTwoStageB = 0.1931833275037836f;
constexpr float kTwoStageMid = static_cast<float>(1.0 - 2.0 * 0.1931833275037836);

struct Args {
  // product of t: W (d, k); sparse coding: Φ (p, b); logreg: Xs = −s·X (o, d)
  const float* p0;
  const float* p1;  // sparse coding: the patch (p,)
  // product of t: ν+1, ν, ½(ν+1), 1/ν; sparse coding: λ, σ⁻², ½σ⁻², ε;
  // logreg: 1/σ₀², ½/σ₀²
  float k0, k1, k2, k3;
  const float *x, *v, *g, *u, *h_back, *valid;
  float *xo, *vo, *go, *uo, *hbo, *valido, *w, *wx, *wx2;
  int* evals;
  float *xs, *ws;  // stream emissions (EMIT only)
  int* es;
  int n, num_iters, thin, m, fixed_uniform;
  uint32_t seed;
  float eps, beta;
  const float* mass;  // (2, d): M^-1 and sqrt(M), or nullptr (identity)
  int two_stage;
  float* scratch;  // NUTS: the chains' tree state, (nuts::rows(m), d, n), where it is not
  // kept in shared memory (NutsTile::ONCHIP)
  // NUTS PROF instances: per block and observer, the cycles of each phase
  unsigned long long* prof;
};

// Shared-memory layout, in floats. D: state dims; K: rows of the energy's
// intermediate (product of t: nbasis; sparse coding: npixels; logreg: nobs).
// The f32 parameter copies A1/A2 exist only at kHighest (0 floats at the
// bf16 precisions, which read the A fragments instead). The bf16 instances
// add the parameter matrix's A fragments at FRAG, in 32-bit words:
// contraction 1's hi, contraction 2's hi, then (bf16x3) the two lo copies,
// each kWords long.
template <int E, int D, int K, int C, int P>
struct Layout {
  static_assert(D % 4 == 0 && K % 4 == 0 && C % 2 == 0, "float4 tiles");
  static constexpr int NC = 2 * C;          // trajectory columns
  static constexpr int kF32 = P == kHighest ? D * K : 0;  // one f32 copy
  static constexpr int A1 = 0;              // [D][K]: W | Φᵀ | Xsᵀ
  static constexpr int A2 = A1 + kF32;      // [K][D]: Wᵀ | Φ | Xs
  static constexpr int PATCH = A2 + kF32;   // [K]
  static constexpr int X = PATCH + K;       // [D][NC] trajectory positions
  static constexpr int V = X + D * NC;      // [D][NC] momenta
  static constexpr int G = V + D * NC;      // [D][NC] gradients
  static constexpr int Y = G + D * NC;      // [K][NC] y | r | z
  static constexpr int Z = Y + K * NC;      // [K][NC] dU/dy | σ(z)
  static constexpr int HEND = Z + (E != kSparseCoding ? K * NC : 0);  // [NC]
  static constexpr int UEND = HEND + NC;    // [NC]
  static constexpr int DWELL = UEND + NC;   // [C]
  static constexpr int SEL = DWELL + C;     // [NC] choice, as int
  static constexpr int MASS = SEL + NC;     // [2D] M^-1, sqrt(M) (1 without)
  static constexpr int FRAG = (MASS + 2 * D + 3) / 4 * 4;  // 16-byte aligned
  static constexpr int kWords = pad16(K) * pad16(D) / 2;  // one copy of one contraction
  static constexpr int kCopies = P == kHighest ? 0 : P == kBf16x3 ? 2 : 1;
  static constexpr int kFloats = P == kHighest ? MASS + 2 * D : FRAG + 2 * kCopies * kWords;
};

// out[r][col] = Σ_k A[k][r]·B[k][col] for r < R, col < NC, handed to
// epi(r, col, value) element by element: A is [KD][R], B is [KD][NC], both
// row-major f32 in shared memory.
//
// kHighest: each task sums a 4×4 tile in registers in FP32 FMA. With STUB
// the sum is replaced by 1e-3·B[0][col] on every row (MatmulEnergySpec._dot's
// stub_dots ablation): the tiles, epilogues and barriers stay, the
// multiply-adds go.
//
// The bf16 precisions: warp w takes m16n8 output tiles w, w + T/32, ...;
// AH (and AL, bf16x3) hold A as bf16 A fragments, the (m-tile, k-tile)
// fragment at uint4 (mt·KT + kt)·32 + lane (load_params); B's fragments
// are split from f32 as they load, 0 past row KD. Output rows past R (the
// padding) are dropped.
template <int KD, int R, int NC, int T, bool STUB, int P, class Epi>
__device__ __forceinline__ void contract(const float* __restrict__ A,
                                         const uint32_t* __restrict__ AH,
                                         const uint32_t* __restrict__ AL,
                                         const float* __restrict__ B, Epi epi) {
  if constexpr (P == kHighest || STUB) {
    constexpr int CG = NC / 4, TASKS = (R / 4) * CG;
    for (int task = threadIdx.x; task < TASKS; task += T) {
      const int r0 = (task / CG) * 4, c0 = (task % CG) * 4;
      float acc[4][4] = {};
      if constexpr (STUB) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = B[c0 + j] * 1e-3f;
      } else {
#pragma unroll 4
        for (int k = 0; k < KD; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(A + k * R + r0);
          const float4 b = *reinterpret_cast<const float4*>(B + k * NC + c0);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r0 + i, c0 + j, acc[i][j]);
    }
  } else {
    constexpr int MT = pad16(R) / 16, KT = pad16(KD) / 16, NT = NC / 8;
    static_assert(NC % 8 == 0, "n-tiles of 8 columns");
    const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const uint4* AH4 = reinterpret_cast<const uint4*>(AH);
    const uint4* AL4 = reinterpret_cast<const uint4*>(AL);
    for (int tile = threadIdx.x / 32; tile < MT * NT; tile += T / 32) {
      const int mt = tile / NT, col = (tile % NT) * 8 + g;
      float hh[4] = {}, hl[4] = {}, lh[4] = {};
      auto b_at = [&](int k) { return k < KD ? B[k * NC + col] : 0.f; };
#pragma unroll 2
      for (int kt = 0; kt < KT; ++kt) {
        const int k = 16 * kt + 2 * q;
        uint32_t bh0, bl0, bh1, bl1;
        split_bf16(b_at(k), b_at(k + 1), bh0, bl0);
        split_bf16(b_at(k + 8), b_at(k + 9), bh1, bl1);
        const uint4 av = AH4[(mt * KT + kt) * 32 + lane];
        const uint32_t ah[4] = {av.x, av.y, av.z, av.w};
        mma_bf16(hh, ah, bh0, bh1);
        if constexpr (P != kDefault) mma_bf16(hl, ah, bl0, bl1);
        if constexpr (P == kBf16x3) {
          const uint4 lv = AL4[(mt * KT + kt) * 32 + lane];
          const uint32_t al[4] = {lv.x, lv.y, lv.z, lv.w};
          mma_bf16(lh, al, bh0, bh1);
        }
      }
      // rows g and g+8 of the m-tile, columns 2q and 2q+1 of the n-tile
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = 16 * mt + g + 8 * (h >> 1), c = (tile % NT) * 8 + 2 * q + (h & 1);
        float v = hh[h];
        if constexpr (P == kBf16x3) v = hh[h] + (hl[h] + lh[h]);
        if constexpr (P == kBf16x2) v = hh[h] + hl[h];
        if (r < R) epi(r, c, v);
      }
    }
  }
}

__device__ __forceinline__ float log_rate(float h_to, float h_cur) {
  const float raw = -0.5f * (h_to - h_cur);
  const bool ok = fabsf(h_to) < 1e30f && h_to == h_to;
  // written so a NaN raw stays NaN, as jnp.minimum keeps it
  return ok ? (raw > kLogRateMax ? kLogRateMax : raw) : kNegInf;
}

__device__ __forceinline__ void kadd(float& s, float& c, float inc) {
  const float y = inc - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// the chain's energy at column col from the last contraction's y or r
template <int E, int D, int K, int NC>
__device__ __forceinline__ float column_energy(const float* X, const float* Y, int col,
                                               const Args& a) {
  if constexpr (E == kProductOfT) {
    float s = 0.f;
    for (int j = 0; j < K; ++j) {
      const float y = Y[j * NC + col];
      s += log1pf(y * y * a.k3);
    }
    return a.k2 * s;
  } else if constexpr (E == kSparseCoding) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < D; ++i) {
      const float av = X[i * NC + col];
      s1 += sqrtf(av * av + a.k3);
    }
    for (int p = 0; p < K; ++p) {
      const float r = Y[p * NC + col];
      s2 += r * r;
    }
    return a.k0 * s1 + a.k2 * s2;
  } else {
    // Σ softplus(z) with the stable form max(z, 0) + log1p(e^{−|z|}), and
    // the prior ½σ₀⁻²‖θ‖²
    float s1 = 0.f, s2 = 0.f;
    for (int o = 0; o < K; ++o) {
      const float z = Y[o * NC + col];
      s1 += fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    }
    for (int i = 0; i < D; ++i) {
      const float th = X[i * NC + col];
      s2 += th * th;
    }
    return s1 + a.k1 * s2;
  }
}

// ½ Σ (V·V)·M^-1 down column col (BR=false: no mass compiled in)
template <int D, int NC, bool BR>
__device__ __forceinline__ float column_halfsq(const float* V, const float* IM, int col) {
  float s = 0.f;
  for (int i = 0; i < D; ++i) s += V[i * NC + col] * V[i * NC + col] * (BR ? IM[i] : 1.f);
  return 0.5f * s;
}

// Box-Muller normal (cosine branch) of dim i for a chain: words i and D+i
// of the family tag's draw starting at slot slot0, times sqrt(M)
template <int D>
__device__ __forceinline__ float normal_of(const Args& a, uint32_t chain, uint32_t t,
                                           int i, uint32_t tag, uint32_t slot0,
                                           float sqrt_m, uint2 key) {
  const float u1 = a.fixed_uniform ? 0x1p-25f
                                   : philox_uniform(philox_word(chain, t, i, key, tag, slot0));
  const float u2 = a.fixed_uniform
      ? 0x1p-25f
      : philox_uniform(philox_word(chain, t, D + i, key, tag, slot0));
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2) * sqrt_m;
}

// A[k][m] of contraction c (1: A1, K rows m of D deep; 2: A2, D rows of K
// deep) read from p0, 0 in the padding
template <int E, int D, int K>
__device__ __forceinline__ float param_at(const Args& a, int c, int m, int k) {
  if (m >= (c == 1 ? K : D) || k >= (c == 1 ? D : K)) return 0.f;
  if constexpr (E == kProductOfT)  // p0 = W (D, K): A1[k][m] = W[k][m], A2[k][m] = W[m][k]
    return c == 1 ? a.p0[k * K + m] : a.p0[m * K + k];
  else  // p0 = Φ or Xs (K, D): A1[k][m] = Φ[m][k], A2[k][m] = Φ[k][m]
    return c == 1 ? a.p0[m * D + k] : a.p0[k * D + m];
}

// The parameter matrix in both orientations (P kHighest: f32 at A1, A2;
// otherwise bf16 A fragments of both contractions at frag: Layout::FRAG),
// the patch and the mass into the block's shared memory, then a barrier.
template <int E, int D, int K, int T, bool BR, int P>
__device__ __forceinline__ void load_params(const Args& a, float* A1, float* A2, float* patch,
                                            float* IM, uint32_t* frag) {
  const int tid = threadIdx.x;
  if constexpr (P == kHighest) {
    for (int idx = tid; idx < D * K; idx += T) {
      const float val = a.p0[idx];
      if constexpr (E == kProductOfT) {  // p0 = W (D, K)
        A1[idx] = val;
        A2[(idx % K) * D + idx / K] = val;
      } else {  // p0 = Φ or Xs (K, D)
        A2[idx] = val;
        A1[(idx % D) * K + idx / D] = val;
      }
    }
  } else {
    // word w of contraction c: register h of lane (g, q) of fragment
    // (mt, kt), holding A[k][m], A[k+1][m] (contract's A-fragment order)
    constexpr int W = Layout<E, D, K, 16, P>::kWords;
    for (int w = tid; w < 2 * W; w += T) {
      const int c = w < W ? 1 : 2, wi = w % W;
      const int kt_count = pad16(c == 1 ? D : K) / 16;
      const int h = wi % 4, lane = (wi / 4) % 32, blk = wi / 128;
      const int mt = blk / kt_count, kt = blk % kt_count, g = lane / 4, q = lane % 4;
      const int m = 16 * mt + g + 8 * (h & 1), k = 16 * kt + 8 * (h >> 1) + 2 * q;
      uint32_t hi, lo;
      split_bf16(param_at<E, D, K>(a, c, m, k), param_at<E, D, K>(a, c, m, k + 1), hi, lo);
      frag[w] = hi;
      if constexpr (P == kBf16x3) frag[2 * W + w] = lo;
    }
  }
  if constexpr (E == kSparseCoding)
    for (int idx = tid; idx < K; idx += T) patch[idx] = a.p1[idx];
  if (BR)
    for (int idx = tid; idx < 2 * D; idx += T) IM[idx] = a.mass ? a.mass[idx] : 1.f;
  __syncthreads();
}

// v −= c_kick·g (if kick), x += c_drift·M^-1·v on all columns, then a
// barrier
template <int D, int NC, int T, bool BR>
__device__ __forceinline__ void kick_drift_tile(float* X, float* V, const float* G,
                                                const float* IM, bool kick, float c_kick,
                                                float c_drift) {
  float4* X4 = reinterpret_cast<float4*>(X);
  float4* V4 = reinterpret_cast<float4*>(V);
  const float4* G4 = reinterpret_cast<const float4*>(G);
  for (int q = threadIdx.x; q < D * NC / 4; q += T) {
    float4 xq = X4[q], vq = V4[q];
    if (kick) {
      const float4 gq = G4[q];
      vq.x = vq.x - c_kick * gq.x;
      vq.y = vq.y - c_kick * gq.y;
      vq.z = vq.z - c_kick * gq.z;
      vq.w = vq.w - c_kick * gq.w;
    }
    const float im = BR ? IM[(4 * q) / NC] : 1.f;
    xq.x = xq.x + c_drift * (im * vq.x);
    xq.y = xq.y + c_drift * (im * vq.y);
    xq.z = xq.z + c_drift * (im * vq.z);
    xq.w = xq.w + c_drift * (im * vq.w);
    X4[q] = xq;
    V4[q] = vq;
  }
  __syncthreads();
}

// The gradient epilogues' arithmetic: RN rounds every operation on its own,
// as the plain version does (NUTS); otherwise nvcc may fuse a product into
// the sum that follows it (mm_kernel's bodies)
template <bool RN>
__device__ __forceinline__ float mul_(float x, float y) {
  if constexpr (RN) return __fmul_rn(x, y); else return x * y;
}
template <bool RN>
__device__ __forceinline__ float add_(float x, float y) {
  if constexpr (RN) return __fadd_rn(x, y); else return x + y;
}
template <bool RN>
__device__ __forceinline__ float sub_(float x, float y) {
  if constexpr (RN) return __fsub_rn(x, y); else return x - y;
}
template <bool RN>
__device__ __forceinline__ float div_(float x, float y) {
  if constexpr (RN) return __fdiv_rn(x, y); else return x / y;
}

// g = ∇U(X) on all columns by the energy's two contractions at precision P
// (frag: the bf16 fragments, Layout::FRAG): y, r or z into Y (product of t
// and logreg also dU/dy or σ(z) into Z), then between() (a barrier), then
// each gradient element to sink(r·NC + c, g)
template <int E, int D, int K, int NC, int T, bool STUB, int P, bool RN, class Between,
          class Sink>
__device__ __forceinline__ void gradient_tile(const float* A1, const float* A2,
                                              const uint32_t* frag, const float* patch,
                                              const float* X, float* Y, float* Z, const Args& a,
                                              Between between, Sink sink) {
  // hi and lo fragments of contraction 1 (A1) and 2 (A2)
  constexpr int W = Layout<E, D, K, NC / 2, P>::kWords;
  const uint32_t *h1 = frag, *h2 = frag + W, *l1 = frag + 2 * W, *l2 = frag + 3 * W;
  if constexpr (E == kProductOfT) {
    // y = Wᵀx and dU/dy = (ν+1)·y/(ν + y²); g = W·dU/dy
    contract<D, K, NC, T, STUB, P>(A1, h1, l1, X, [&](int r, int c, float y) {
      Y[r * NC + c] = y;
      Z[r * NC + c] = div_<RN>(mul_<RN>(a.k0, y), add_<RN>(a.k1, mul_<RN>(y, y)));
    });
    between();
    contract<K, D, NC, T, STUB, P>(A2, h2, l2, Z,
                                   [&](int r, int c, float gv) { sink(r * NC + c, gv); });
  } else if constexpr (E == kSparseCoding) {
    // r = patch − Φa; g = λ·a/√(a²+ε) − σ⁻²·Φᵀr
    contract<D, K, NC, T, STUB, P>(A1, h1, l1, X, [&](int r, int c, float v) {
      Y[r * NC + c] = sub_<RN>(patch[r], v);
    });
    between();
    contract<K, D, NC, T, STUB, P>(A2, h2, l2, Y, [&](int r, int c, float v) {
      const int idx = r * NC + c;
      const float av = X[idx];
      const float s = sqrtf(add_<RN>(mul_<RN>(av, av), a.k3));
      sink(idx, sub_<RN>(mul_<RN>(a.k0, div_<RN>(av, s)), mul_<RN>(a.k1, v)));
    });
  } else {
    // z = Xs·θ and σ(z); g = Xsᵀσ(z) + θ/σ₀²
    contract<D, K, NC, T, STUB, P>(A1, h1, l1, X, [&](int r, int c, float z) {
      Y[r * NC + c] = z;
      Z[r * NC + c] = div_<RN>(1.0f, add_<RN>(1.0f, expf(-z)));
    });
    between();
    contract<K, D, NC, T, STUB, P>(A2, h2, l2, Z, [&](int r, int c, float v) {
      const int idx = r * NC + c;
      sink(idx, add_<RN>(v, mul_<RN>(X[idx], a.k0)));
    });
  }
}

// g = ∇U(X) on all columns (gradient_tile), the closing kick v −= c_kick·g,
// then a barrier
template <int E, int D, int K, int NC, int T, bool STUB, int P>
__device__ __forceinline__ void force_kick_tile(const float* A1, const float* A2,
                                                const uint32_t* frag, const float* patch,
                                                const float* X, float* V, float* G, float* Y,
                                                float* Z, const Args& a, float c_kick) {
  gradient_tile<E, D, K, NC, T, STUB, P, false>(
      A1, A2, frag, patch, X, Y, Z, a, [] { __syncthreads(); },
      [&](int idx, float gv) {
        G[idx] = gv;
        V[idx] = V[idx] - c_kick * gv;
      });
  __syncthreads();
}

// VAR: kMjhmc (both trajectories of C chains in the NC = 2C columns), or
// kControl / kMalt (the forward trajectories of NC chains, one a column).
// BR=false compiles neither the mass nor the two-stage integrator (MJHMC's
// fast path, as the TPU kernel compiles them statically); BR=true takes
// both from the arguments.
template <int E, int D, int K, int C, int T, int VAR, bool EMIT, bool STUB, bool BR, int P>
__global__ void __launch_bounds__(T) mm_kernel(Args a) {
  using L = Layout<E, D, K, C, P>;
  constexpr int NC = L::NC;
  constexpr bool MJ = VAR == kMjhmc;
  constexpr int CH = MJ ? C : NC;           // chains per block
  constexpr int NE = (D * CH + T - 1) / T;  // (dim, chain) elements per thread
  static_assert(T >= NC, "one thread per trajectory column");

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* A1 = sm + L::A1;
  float* A2 = sm + L::A2;
  float* patch = sm + L::PATCH;
  float* X = sm + L::X;
  float* V = sm + L::V;
  float* G = sm + L::G;
  float* Y = sm + L::Y;
  float* Z = sm + L::Z;
  float* hend = sm + L::HEND;
  float* uend = sm + L::UEND;
  float* dwell_s = sm + L::DWELL;
  int* sel_s = reinterpret_cast<int*>(sm + L::SEL);
  float* IM = sm + L::MASS;  // [D] M^-1, then [D] sqrt(M)
  uint32_t* frag = reinterpret_cast<uint32_t*>(sm + L::FRAG);  // bf16 instances
  float* SQM = IM + D;

  const int tid = threadIdx.x;
  const int chain0 = blockIdx.x * CH;
  const size_t n = a.n;
  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  load_params<E, D, K, T, BR, P>(a, A1, A2, patch, IM, frag);

  // owned elements e = tid + k·T: dim e / CH, chain e % CH of the tile; the
  // chains past n (ragged last tile) run on zeros and are never stored
  float x[NE], v[NE], g[NE], wx[NE], wxc[NE], wx2[NE], wx2c[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = tid + k * T, i = e / CH, c = e % CH;
    const bool live = e < D * CH && chain0 + c < a.n;
    const size_t gi = (size_t)i * n + chain0 + c;
    x[k] = live ? a.x[gi] : 0.f;
    v[k] = live ? a.v[gi] : 0.f;
    g[k] = live ? a.g[gi] : 0.f;
    wx[k] = wxc[k] = wx2[k] = wx2c[k] = 0.f;
  }
  // per-chain scalars, held by thread c < CH for chain c of the tile
  const int chain = chain0 + tid;
  const bool chain_live = tid < CH && chain < a.n;
  float u = chain_live ? a.u[chain] : 0.f;
  float h_back = chain_live ? a.h_back[chain] : 0.f;
  float valid = chain_live ? a.valid[chain] : 0.f;
  float w = 0.f, wc = 0.f, h_cur = 0.f;
  int evals = 0;

  const bool two_stage = BR && a.two_stage;
  const int m_cost = two_stage ? 2 * a.m : a.m;
  const float sb = sqrtf(a.beta), sb1 = sqrtf(fmaxf(1.f - a.beta, 0.f));  // control
  // MALT: beta is the friction; rounded one operation at a time
  const float eta = expf(__fmul_rn(__fmul_rn(-a.beta, eps), 0.5f));
  const float sig = sqrtf(fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(eta, eta))));
  constexpr uint32_t kBlocks = (2 * D + 3) / 4;  // slots of one O-step's noise
  float ul = 0.f, delta = 0.f, h_in = 0.f;        // MALT, per column thread

  // the O half-step of MALT on every owned element: V <- eta V + sig z
  auto o_step = [&](int t, int o) {
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = tid + k * T, i = e / CH, c = e % CH;
      if (e < D * CH) {
        const float z = normal_of<D>(a, chain0 + c, t, i, kTagMaltNoise, o * kBlocks,
                                     BR ? SQM[i] : 1.f, key);
        V[i * NC + c] = eta * V[i * NC + c] + sig * z;
      }
    }
  };
  auto kick_drift = [&](bool kick, float c_kick, float c_drift) {
    kick_drift_tile<D, NC, T, BR>(X, V, G, IM, kick, c_kick, c_drift);
  };
  auto force_kick = [&](float c_kick) {
    force_kick_tile<E, D, K, NC, T, STUB, P>(A1, A2, frag, patch, X, V, G, Y, Z, a, c_kick);
  };
  // one integrator step on all columns: leapfrog, or the two-stage splitting
  auto integrator_step = [&]() {
    if (two_stage) {
      const float cb = kTwoStageB * eps, cm = kTwoStageMid * eps;
      kick_drift(true, cb, he);
      force_kick(cm);
      kick_drift(false, 0.f, he);
      force_kick(cb);
    } else {
      kick_drift(true, he, eps);
      force_kick(he);
    }
  };

  for (int t = 0; t < a.num_iters; ++t) {
    // the columns: MJHMC forward from (x, v) in column c and backward from
    // (x, -v) in C + c; control from the corrupted v; MALT from v0 ~ N(0, M)
    // (kept in v until the decision)
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = tid + k * T, i = e / CH, c = e % CH;
      if (e < D * CH) {
        X[i * NC + c] = x[k];
        G[i * NC + c] = g[k];
        if constexpr (MJ) {
          X[i * NC + C + c] = x[k];
          G[i * NC + C + c] = g[k];
          V[i * NC + c] = v[k];
          V[i * NC + C + c] = -v[k];
        } else if constexpr (VAR == kControl) {
          const float xi = normal_of<D>(a, chain0 + c, t, i, kTagControl, 0u,
                                        BR ? SQM[i] : 1.f, key);
          v[k] = sb1 * v[k] + sb * xi;
          V[i * NC + c] = v[k];
        } else {
          v[k] = normal_of<D>(a, chain0 + c, t, i, kTagMaltRefresh, 0u, BR ? SQM[i] : 1.f,
                              key);
          V[i * NC + c] = v[k];
        }
      }
    }
    __syncthreads();
    // the chain's current H (MALT: its trajectory's U and Δ start)
    if (tid < CH) {
      if constexpr (VAR == kMalt) {
        ul = u;
        delta = 0.f;
      } else {
        h_cur = u + column_halfsq<D, NC, BR>(V, IM, tid);
      }
    }
    __syncthreads();

    for (int step = 0; step < a.m; ++step) {
      if constexpr (VAR == kMalt) {
        o_step(t, 2 * step);
        __syncthreads();
        if (tid < CH) h_in = ul + column_halfsq<D, NC, BR>(V, IM, tid);
        __syncthreads();
        integrator_step();
        // the BAB step's energy error, from this step's y or r
        if (tid < CH) {
          ul = column_energy<E, D, K, NC>(X, Y, tid, a);
          delta = delta + (ul + column_halfsq<D, NC, BR>(V, IM, tid) - h_in);
        }
        __syncthreads();
        o_step(t, 2 * step + 1);
        __syncthreads();
      } else {
        integrator_step();
      }
    }

    // endpoint energies of the trajectories from the last step's y or r
    if (!(VAR == kMalt) && tid < NC) {
      const float uc = column_energy<E, D, K, NC>(X, Y, tid, a);
      uend[tid] = uc;
      hend[tid] = uc + column_halfsq<D, NC, BR>(V, IM, tid);
    }
    __syncthreads();

    const bool emit_now = EMIT && (t + 1) % a.thin == 0;
    const size_t emit_row = t / a.thin;
    if (tid < CH) {
      if constexpr (MJ) {
        const float h_l = hend[tid];
        const float h_b = valid > 0.5f ? h_back : hend[C + tid];
        const float log_gl = log_rate(h_l, h_cur);
        const float log_glf = log_rate(h_b, h_cur);
        const float gamma_l = expf(log_gl < kNegInf ? kNegInf : log_gl);
        const float df = expf(log_glf) - gamma_l;
        const float gamma_f = df < 0.f ? 0.f : df;
        const float total = gamma_l + gamma_f + a.beta;
        const float dwell = 1.0f / total;

        // categorical clock choice by inverse CDF from one uniform (word 0)
        const float u0 = a.fixed_uniform
            ? 0x1p-25f
            : philox_uniform(philox_word(chain, t, 0u, key));
        const float u_sel = u0 * total;
        const bool is_l = u_sel < gamma_l;
        const bool is_f = !is_l && u_sel < gamma_l + gamma_f;
        dwell_s[tid] = dwell;
        sel_s[tid] = is_l ? kL : (is_f ? kF : kR);

        evals += valid > 0.5f ? m_cost : 2 * m_cost;
        kadd(w, wc, dwell);
        if (emit_now && chain_live) {
          a.ws[emit_row * n + chain] = dwell;
          a.es[emit_row * n + chain] = evals;
        }
        if (is_l) {
          u = uend[tid];
          h_back = h_cur;
        } else if (is_f) {
          h_back = h_l;
        }
        valid = (is_l || is_f) ? 1.f : 0.f;
      } else {
        // Metropolis on H_L (control) or on Δ (MALT); a non-finite value
        // rejects, a NaN log-ratio too (as jnp.minimum keeps NaN)
        const float h = VAR == kControl ? hend[tid] : delta;
        const float lr = VAR == kControl ? h_cur - h : -delta;
        const bool ok = fabsf(h) < 1e30f && h == h;
        const float lp = lr > 0.f ? 0.f : lr;
        const float pacc = ok ? expf(lp) : 0.f;
        const uint32_t tag = VAR == kControl ? kTagControl : kTagMaltRefresh;
        const float um = a.fixed_uniform
            ? 0x1p-25f
            : philox_uniform(philox_word(chain, t, 2 * D, key, tag));
        const bool acc = um < pacc;
        sel_s[tid] = acc ? kL : kR;
        if (acc) u = VAR == kControl ? uend[tid] : ul;
        evals += m_cost;
        kadd(w, wc, 1.f);
        if (emit_now && chain_live) {
          a.ws[emit_row * n + chain] = 1.f;
          a.es[emit_row * n + chain] = evals;
        }
      }
    }
    __syncthreads();

    // MJHMC: accumulators and emissions take the pre-transition x, then the
    // move; control and MALT: the move (flip on reject; MALT −v0), then the
    // post-transition x with weight 1
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = tid + k * T, i = e / CH, c = e % CH;
      if (e < D * CH) {
        const int sel = sel_s[c];
        if constexpr (MJ) {
          const float dwell = dwell_s[c];
          kadd(wx[k], wxc[k], dwell * x[k]);
          kadd(wx2[k], wx2c[k], dwell * x[k] * x[k]);
          if (emit_now && chain0 + c < a.n)
            a.xs[(emit_row * D + i) * n + chain0 + c] = x[k];
          if (sel == kL) {
            x[k] = X[i * NC + c];
            v[k] = V[i * NC + c];
            g[k] = G[i * NC + c];
          } else if (sel == kF) {
            v[k] = -v[k];
          } else {
            // refresh by Box-Muller's cosine branch from words 1+i, 1+D+i
            const float u1 = a.fixed_uniform
                ? 0x1p-25f
                : philox_uniform(philox_word(chain0 + c, t, 1 + i, key));
            const float u2 = a.fixed_uniform
                ? 0x1p-25f
                : philox_uniform(philox_word(chain0 + c, t, 1 + D + i, key));
            v[k] = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2) * (BR ? SQM[i] : 1.f);
          }
        } else {
          if (sel == kL) {
            x[k] = X[i * NC + c];
            v[k] = V[i * NC + c];
            g[k] = G[i * NC + c];
          } else {
            v[k] = -v[k];
          }
          kadd(wx[k], wxc[k], x[k]);
          kadd(wx2[k], wx2c[k], x[k] * x[k]);
          if (emit_now && chain0 + c < a.n)
            a.xs[(emit_row * D + i) * n + chain0 + c] = x[k];
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = tid + k * T, i = e / CH, c = e % CH;
    if (e < D * CH && chain0 + c < a.n) {
      const size_t gi = (size_t)i * n + chain0 + c;
      a.xo[gi] = x[k];
      a.vo[gi] = v[k];
      a.go[gi] = g[k];
      a.wx[gi] = wx[k];
      a.wx2[gi] = wx2[k];
    }
  }
  if (chain_live) {
    a.uo[chain] = u;
    a.hbo[chain] = h_back;
    a.valido[chain] = valid;
    a.w[chain] = w;
    a.evals[chain] = evals;
  }
}

// The presets' shapes, one per energy: D state dims, K rows of the
// intermediate, T threads a block; every mm_kernel tile is C = 16 chains
// (NC = 32 trajectory columns)
template <int E> struct Shape;
template <> struct Shape<kProductOfT> { static constexpr int D = 36, K = 36, T = 96; };
template <> struct Shape<kSparseCoding> { static constexpr int D = 128, K = 64, T = 256; };
template <> struct Shape<kLogreg> { static constexpr int D = 16, K = 256, T = 128; };
constexpr int kC = 16;

// ---------------------------------------------------------------------------
// NUTS: the step body _make_step_nuts (pallas_mjhmc.py:1011-1210) on the
// matmul energies, with the semantics of the elementwise nuts_kernel
// (mjhmc_engine.cuh): per chain and iteration a fresh v0 ~ N(0, M)
// (tag 1), up to max_depth doubling rounds in directions drawn from tag 2,
// progressive multinomial sampling with leaf uniforms drawn from tag 3 by
// tree position, the binary-counter U-turn stack, divergence at |h| ≥
// 1e30, NaN or ΔH > 1000, the biased merge and the global U-turn; output
// (x_prop, v0, g_prop, u_prop) with h_back and valid passed through, the
// post-transition x with weight 1, and evals equal to the integrated leaves.
//
// Design: a block runs the NC chains of its tile in lockstep, one column
// each, as the TPU's lane block does (NUTS has no backward trajectory).
// The tiles are narrow (NutsTile: 8 chains for product of t and logistic
// regression, 16 for sparse coding), so that the presets' widths make
// 256-512 blocks, two or more resident on each of the 132 SMs, and a tile
// runs few leaves that only its deepest tree needs. Each leaf is one
// leapfrog step of every column: the energy's two contractions over the
// tile through contract() (mma.sync at the bf16 precisions), whose
// epilogues write y, r or z and the gradient of every column. The rest is
// the work of the element owners: thread tid owns column c = tid % NC and
// the dims (and the rows of the intermediate) r, r + R, ... (r = tid / NC,
// R = T / NC). An owner keeps the trajectory's x, v, g and the chain's
// sample x, g of its elements in registers, runs their kick-drift and
// closing kick (a column that is done or stopped keeps its state), and
// reads and writes their rows of the tree state, which no other thread
// touches, so the tree state needs no barrier. A column's sums (its
// energy, ½vᵀM⁻¹v, the U-turn projections) are each owner's partial sum in
// its dim order, then the R partials added in row order through shared
// memory (red); every owner of the column reads them, so all R owners keep
// the chain's scalars (u, h0, the log weights, done, stop, the direction,
// the leaf count) alike and no flag is broadcast. A leaf takes four
// barriers: the __syncthreads_or that decides whether it runs, after the
// owners' kick-drift, one after each contraction, and one before the
// partials are read; a round one more, for its end's U-turn check. Every
// draw is keyed by (chain, iteration, slot, tag), so no chain's result
// depends on the tiling.
//
// The tree state (both endpoints' x, v, g in the trajectory frame, the
// subtree proposal's x, g and the 2(max_depth − 1) U-turn stack rows,
// nuts::rows) is rows(max_depth)·D floats a chain. It lives in shared
// memory where the tile's fits beside the rest (product of t 25 KB and
// logreg 11 KB a tile at max_depth 8), else (sparse coding, 11 KB a chain)
// in the (rows, D, n) scratch buffer in device memory that the wrapper
// allocates, where an owner's loads are independent (all in flight at
// once) and a warp's are coalesced across the tile's chains. The
// elementwise arithmetic rounds one IEEE operation at a time, as the plain
// version does; the contractions and the column sums add in other orders
// than torch.matmul and the plain version's sums, so trees are held to the
// plain version at a tolerance, not bit for bit.
//
// What bounds it: latency, not the card's rates (the operations are a few
// percent of the bound's time, PERF.md §6). A leaf is a chain of dependent
// steps between four barriers, the two contractions a third to a half of
// its cycles, then the owners' partials and column sums and the tree
// bookkeeping, and a tile runs as many leaves as its deepest tree. Two to
// four resident blocks an SM overlap one block's barriers with another's
// work. Sparse coding also waits on its stack rows in device memory, and
// its instances sit at the 128 registers a thread that two blocks an SM
// allow, with some spills (PERF.md §6 lists the breakdown, the registers
// and the spills).
namespace nuts {

constexpr int kMaxDepth = 10;
constexpr float kDivThreshold = 1000.0f;
// tree rows: the tree endpoints, the subtree proposal, then the stack
// (x, v of span row mm at kStack + 2(mm − 1))
enum Row { kXM = 0, kVM, kGM, kXP, kVP, kGP, kXS, kGS, kStack };
__host__ __device__ constexpr int rows(int max_depth) { return kStack + 2 * (max_depth - 1); }
// the column sums' slots in red: the round end's two U-turn projections,
// a leaf's two energy terms (kE1 is also ½v0ᵀM⁻¹v0 at an iteration's
// start) and ½vᵀM⁻¹v, then two for each U-turn span that can close at a
// leaf. A slot is written again only after a barrier that follows its reads.
enum Slot { kEndM = 0, kEndP, kE1, kE2, kHalf, kSpan };
__host__ __device__ constexpr int slots(int max_depth) { return kSpan + 2 * (max_depth - 1); }

// jnp.logaddexp: max + log1p(exp(−|Δ|)), or a + b where Δ is NaN
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = __fsub_rn(a, b);
  if (d != d) return __fadd_rn(a, b);
  return __fadd_rn(a > b ? a : b, log1pf(expf(-fabsf(d))));
}

__device__ __forceinline__ float uniform(const Args& a, uint32_t word) {
  return a.fixed_uniform ? 0x1p-25f : philox_uniform(word);
}

// The PROF instances' per-leaf phase breakdown: clock64() stamps by two
// observers, thread 0 and the first thread of the last warp, each phase's
// cycles summed (the wait inside each block barrier apart, kPhBarrier), and
// the block's leaf steps; written to prof[(block·2 + observer)·kPhases + phase]
enum Phase {
  kPhKickDrift = 0, kPhContract1, kPhContract2, kPhEnergy, kPhMultinomial, kPhStack,
  kPhLeafUturn, kPhRoundEnd, kPhBarrier, kPhOther, kPhLeaves, kPhases
};
template <bool ON>
struct Prof {
  long long last = 0;
  long long acc[kPhases] = {};
  __device__ __forceinline__ void start() {
    if constexpr (ON) last = clock64();
  }
  __device__ __forceinline__ void mark(int ph) {
    if constexpr (ON) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void sync(int ph) {
    mark(ph);
    __syncthreads();
    mark(kPhBarrier);
  }
  __device__ __forceinline__ bool sync_or(int ph, bool p) {
    mark(ph);
    const bool any = __syncthreads_or(p);
    mark(kPhBarrier);
    return any;
  }
  __device__ __forceinline__ void leaf() {
    if constexpr (ON) ++acc[kPhLeaves];
  }
  __device__ __forceinline__ void write(const Args& a, int T) {
    if constexpr (ON) {
      const int o = threadIdx.x == 0 ? 0 : threadIdx.x == T - 32 ? 1 : -1;
      if (o >= 0)
        for (int ph = 0; ph < kPhases; ++ph)
          a.prof[((size_t)blockIdx.x * 2 + o) * kPhases + ph] = acc[ph];
    }
  }
};

}  // namespace nuts

// The NUTS tile of energy E: NC chains (one column each) and T threads a
// block, T a multiple of NC so that a thread's elements lie in one column;
// __launch_bounds__ asks for MINB blocks an SM; ONCHIP keeps the tree state
// in shared memory (ops/cuda_mjhmc.py mirrors this, NUTS_MM_TILES)
template <int E> struct NutsTile;
template <> struct NutsTile<kProductOfT> {
  static constexpr int NC = 8, T = 96, MINB = 4;
  static constexpr bool ONCHIP = true;
};
template <> struct NutsTile<kSparseCoding> {
  static constexpr int NC = 16, T = 256, MINB = 2;
  static constexpr bool ONCHIP = false;
};
template <> struct NutsTile<kLogreg> {
  static constexpr int NC = 8, T = 128, MINB = 3;
  static constexpr bool ONCHIP = true;
};

// The NUTS kernel's shared memory, in floats: the parameter matrix as
// load_params writes it (f32 copies A1, A2 at kHighest, else the bf16 A
// fragments at FRAG), the patch, X and G (D × NC), Y and Z (K × NC; no Z
// at sparse coding) and the mass; then, sized by max_depth, the tree state
// (ONCHIP) and the column sums' partials, slots × T
// (ops/cuda_mjhmc.py::nuts_mm_smem_bytes mirrors this)
template <int E, int P>
struct NutsLayout {
  static constexpr int D = Shape<E>::D, K = Shape<E>::K;
  static constexpr int NC = NutsTile<E>::NC, T = NutsTile<E>::T, R = T / NC;
  static_assert(T % NC == 0 && D % R == 0 && K % R == 0, "a thread's elements in one column");
  static_assert(NC % 8 == 0, "mma.sync n-tiles of 8 columns");
  using PL = Layout<E, D, K, NC / 2, P>;  // the parameter matrix's sizes
  static constexpr int A1 = 0;
  static constexpr int A2 = A1 + PL::kF32;
  static constexpr int PATCH = A2 + PL::kF32;
  static constexpr int X = PATCH + K;
  static constexpr int G = X + D * NC;
  static constexpr int Y = G + D * NC;
  static constexpr int Z = Y + K * NC;
  static constexpr int MASS = Z + (E != kSparseCoding ? K * NC : 0);  // [2D]
  static constexpr int FRAG = (MASS + 2 * D + 3) / 4 * 4;  // 16-byte aligned
  static constexpr int TREE = FRAG + 2 * PL::kCopies * PL::kWords;
  __host__ __device__ static constexpr int red(int max_depth) {
    return TREE + (NutsTile<E>::ONCHIP ? nuts::rows(max_depth) * D * NC : 0);
  }
  __host__ __device__ static constexpr int floats(int max_depth) {
    return red(max_depth) + nuts::slots(max_depth) * T;
  }
};

// The sum down column c of slot s of red, where each of a block's T threads
// put one partial at red[s·T + tid] and a column's owners are the threads
// c, c + NC, ...: their T / NC partials added in that order
template <int T, int NC>
__device__ __forceinline__ float column_sum(const float* red, int s, int c) {
  const float* p = red + s * T + c;
  float acc = p[0];
#pragma unroll
  for (int j = 1; j < T / NC; ++j) acc = __fadd_rn(acc, p[j * NC]);
  return acc;
}

template <int E, bool EMIT, bool BR, int P, bool PROF>
__global__ void __launch_bounds__(NutsTile<E>::T, NutsTile<E>::MINB) nuts_mm_kernel(Args a) {
  using namespace nuts;
  using L = NutsLayout<E, P>;
  constexpr int D = L::D, K = L::K, NC = L::NC, T = L::T, R = L::R;
  constexpr int NE = D / R, NK = K / R;  // a thread's dims and rows of the intermediate

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* X = sm + L::X;
  float* G = sm + L::G;
  float* Y = sm + L::Y;
  float* IM = sm + L::MASS;  // [D] M^-1, then [D] sqrt(M)
  const int max_depth = a.m;
  float* tree_s = sm + L::TREE;           // ONCHIP: [rows][D][NC]
  float* red = sm + L::red(max_depth);    // [slots][T]

  const int tid = threadIdx.x, c = tid % NC, r = tid / NC;
  const int chain = blockIdx.x * NC + c;
  const size_t n = a.n;
  const bool chain_live = chain < a.n;
  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  Prof<PROF> prof;
  prof.start();
  load_params<E, D, K, T, BR, P>(a, sm + L::A1, sm + L::A2, sm + L::PATCH, IM,
                                 reinterpret_cast<uint32_t*>(sm + L::FRAG));

  auto dim = [&](int k) { return r + k * R; };  // the thread's k-th dim
  auto im = [&](int i) { return BR ? IM[i] : 1.f; };
  // tree row rr, dim i of the thread's chain (only its owners touch it)
  auto tree = [&](int rr, int i) -> float& {
    if constexpr (NutsTile<E>::ONCHIP)
      return tree_s[(rr * D + i) * NC + c];
    else
      return a.scratch[((size_t)rr * D + i) * n + chain];
  };
  auto put = [&](int s, float part) { red[s * T + tid] = part; };
  auto col_sum = [&](int s) { return column_sum<T, NC>(red, s, c); };
  // acc + ((xa − xb)·w)·M^-1 of dim i (a U-turn projection's term)
  auto proj = [&](float acc, float xa, float xb, float w, int i) {
    return __fadd_rn(acc, __fmul_rn(__fmul_rn(__fsub_rn(xa, xb), w), im(i)));
  };

  // the chain's sample (x, g) and Kahan moments, and the trajectory (xt,
  // vt, gt), of the thread's elements; the chains past n (ragged last
  // tile) are never live
  float x[NE], g[NE], wx[NE], wxc[NE], wx2[NE], wx2c[NE], xt[NE], vt[NE], gt[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const size_t gi = (size_t)dim(k) * n + chain;
    x[k] = chain_live ? a.x[gi] : 0.f;
    g[k] = chain_live ? a.g[gi] : 0.f;
    wx[k] = wxc[k] = wx2[k] = wx2c[k] = 0.f;
    xt[k] = vt[k] = gt[k] = 0.f;
    if (chain_live && a.num_iters == 0) a.vo[gi] = a.v[gi];  // each iteration writes its v0
  }
  // the chain's scalars, kept alike by its R owners
  float u = chain_live ? a.u[chain] : 0.f;
  float w = 0.f, wc = 0.f;
  int evals = 0;
  float h0 = 0.f, log_w_tree = 0.f, log_w_sub = kNegInf, us = 0.f;
  bool done = true, stop = false, right = false;
  uint32_t merge_word = 0;
  int nl = 0;

  for (int t = 0; t < a.num_iters; ++t) {
    // a fresh momentum v0 ~ N(0, M) (words i and D+i of tag 1); both tree
    // endpoints start at the chain's point
    float hv = 0.f;
    if (chain_live) {
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        const int i = dim(k);
        const float v0 = normal_of<D>(a, chain, t, i, kTagNutsMomentum, 0u,
                                      BR ? IM[D + i] : 1.f, key);
        a.vo[(size_t)i * n + chain] = v0;
        tree(kXM, i) = tree(kXP, i) = x[k];
        tree(kVM, i) = tree(kVP, i) = v0;
        tree(kGM, i) = tree(kGP, i) = g[k];
        hv = __fadd_rn(hv, __fmul_rn(__fmul_rn(v0, v0), im(i)));
      }
    }
    put(kE1, hv);
    prof.sync(kPhOther);
    done = !chain_live;
    h0 = __fadd_rn(u, __fmul_rn(0.5f, col_sum(kE1)));
    log_w_tree = 0.f;
    nl = 0;

    for (int jj = 0; jj < max_depth; ++jj) {
      if (!prof.sync_or(kPhOther, !done)) break;
      // the round's direction, and the integration frame: outward from the
      // chosen endpoint (the minus end's momentum negated)
      stop = false;
      log_w_sub = kNegInf;
      if (!done) {
        const uint4 rr = philox4x32_10(make_uint4(chain, t, jj, kTagNutsRound), key);
        right = uniform(a, rr.x) < 0.5f;
        merge_word = rr.y;
#pragma unroll
        for (int k = 0; k < NE; ++k) {
          const int i = dim(k);
          xt[k] = tree(right ? kXP : kXM, i);
          vt[k] = right ? tree(kVP, i) : -tree(kVM, i);
          gt[k] = tree(right ? kGP : kGM, i);
        }
      }
      prof.mark(kPhOther);

      const int leaves = 1 << jj;
      const uint32_t k0 = leaves - 1;  // tree position of the round's first leaf
      for (int leaf = 0; leaf < leaves; ++leaf) {
        const bool act = !done && !stop;
        // the owners' half kick and drift, into X for the contractions
        if (act) {
#pragma unroll
          for (int k = 0; k < NE; ++k) {
            const int i = dim(k);
            vt[k] = __fsub_rn(vt[k], __fmul_rn(he, gt[k]));
            xt[k] = __fadd_rn(xt[k], __fmul_rn(eps, BR ? __fmul_rn(IM[i], vt[k]) : vt[k]));
            X[i * NC + c] = xt[k];
          }
        }
        if (!prof.sync_or(kPhKickDrift, act)) break;
        prof.leaf();
        // the leaf's gradient, rounded one operation at a time
        gradient_tile<E, D, K, NC, T, false, P, true>(
            sm + L::A1, sm + L::A2, reinterpret_cast<const uint32_t*>(sm + L::FRAG),
            sm + L::PATCH, X, Y, sm + L::Z, a, [&] { prof.sync(kPhContract1); },
            [&](int idx, float gv) { G[idx] = gv; });
        prof.sync(kPhContract2);
        // the owners' closing kick and partial sums: the energy's terms,
        // v²·M^-1, and the U-turn projections of the spans of size 2^mm
        // that end at this leaf (2^mm divides leaf + 1) against their left
        // ends stored at earlier leaves
        if (act) {
          float e1 = 0.f, e2 = 0.f;
          hv = 0.f;
#pragma unroll
          for (int k = 0; k < NE; ++k) {
            const int i = dim(k);
            gt[k] = G[i * NC + c];
            vt[k] = __fsub_rn(vt[k], __fmul_rn(he, gt[k]));
            hv = __fadd_rn(hv, __fmul_rn(__fmul_rn(vt[k], vt[k]), im(i)));
            if constexpr (E == kSparseCoding)  // λ-term √(a²+ε)
              e1 = __fadd_rn(e1, sqrtf(__fadd_rn(__fmul_rn(xt[k], xt[k]), a.k3)));
            else if constexpr (E == kLogreg)  // the prior's θ²
              e1 = __fadd_rn(e1, __fmul_rn(xt[k], xt[k]));
          }
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            const float y = Y[dim(k) * NC + c];
            if constexpr (E == kProductOfT)  // log1p(y²/ν)
              e2 = __fadd_rn(e2, log1pf(__fmul_rn(__fmul_rn(y, y), a.k3)));
            else if constexpr (E == kSparseCoding)  // r²
              e2 = __fadd_rn(e2, __fmul_rn(y, y));
            else  // softplus(z) = max(z, 0) + log1p(e^{−|z|})
              e2 = __fadd_rn(e2, __fadd_rn(fmaxf(y, 0.f), log1pf(expf(-fabsf(y)))));
          }
          put(kE1, e1);
          put(kE2, e2);
          put(kHalf, hv);
          prof.mark(kPhEnergy);
          for (int mm = 1; mm <= jj && ((leaf + 1) & ((1 << mm) - 1)) == 0; ++mm) {
            const int row = kStack + 2 * (mm - 1);
            float d1 = 0.f, d2 = 0.f;
#pragma unroll
            for (int k = 0; k < NE; ++k) {
              const int i = dim(k);
              const float sx = tree(row, i), sv = tree(row + 1, i);
              d1 = proj(d1, xt[k], sx, sv, i);
              d2 = proj(d2, xt[k], sx, vt[k], i);
            }
            put(kSpan + 2 * (mm - 1), d1);
            put(kSpan + 2 * (mm - 1) + 1, d2);
          }
          prof.mark(kPhLeafUturn);
        }
        prof.sync(kPhLeafUturn);
        if (act) {
          // the leaf's energy, divergence and progressive multinomial sampling
          float ul;
          if constexpr (E == kProductOfT)
            ul = __fmul_rn(a.k2, col_sum(kE2));
          else if constexpr (E == kSparseCoding)
            ul = __fadd_rn(__fmul_rn(a.k0, col_sum(kE1)), __fmul_rn(a.k2, col_sum(kE2)));
          else
            ul = __fadd_rn(col_sum(kE2), __fmul_rn(a.k1, col_sum(kE1)));
          const float h = __fadd_rn(ul, __fmul_rn(0.5f, col_sum(kHalf)));
          prof.mark(kPhEnergy);
          ++nl;
          const float dh = __fsub_rn(h, h0);
          const bool div = fabsf(h) >= 1e30f || h != h || dh > kDivThreshold;
          const float lw_leaf = div ? kNegInf : -dh;
          const float lw_new = logaddexp(log_w_sub, lw_leaf);
          const float lu = logf(uniform(a, philox_word(chain, t, k0 + leaf, key, kTagNutsLeaf)));
          const bool taken = !div && lu < __fsub_rn(lw_leaf, lw_new);
          if (taken) us = ul;
          log_w_sub = lw_new;
          prof.mark(kPhMultinomial);
          bool turning = false;
          for (int mm = 1; mm <= jj && ((leaf + 1) & ((1 << mm) - 1)) == 0; ++mm)
            turning = turning || col_sum(kSpan + 2 * (mm - 1)) < 0.f ||
                      col_sum(kSpan + 2 * (mm - 1) + 1) < 0.f;
          stop = div || turning;
          prof.mark(kPhLeafUturn);
          // the taken leaf becomes the subtree's proposal; leaf i opens the
          // stack spans of size 2^mm that divide i
#pragma unroll
          for (int k = 0; k < NE; ++k) {
            const int i = dim(k);
            if (taken) {
              tree(kXS, i) = xt[k];
              tree(kGS, i) = gt[k];
            }
            for (int mm = 1; mm <= jj && (leaf & ((1 << mm) - 1)) == 0; ++mm) {
              tree(kStack + 2 * (mm - 1), i) = xt[k];
              tree(kStack + 2 * (mm - 1) + 1, i) = vt[k];
            }
          }
          prof.mark(kPhStack);
        }
      }

      // the biased merge of a completed subtree, then the tree's extension
      // (back to the trajectory frame) and the U-turn between its endpoints
      if (!done && !stop) {
        const bool merge = logf(uniform(a, merge_word)) < __fsub_rn(log_w_sub, log_w_tree);
        if (merge) u = us;
        log_w_tree = logaddexp(log_w_tree, log_w_sub);
        float dm = 0.f, dp = 0.f;
#pragma unroll
        for (int k = 0; k < NE; ++k) {
          const int i = dim(k);
          if (merge) {
            x[k] = tree(kXS, i);
            g[k] = tree(kGS, i);
          }
          float xp, vp, xm, vm;
          if (right) {
            tree(kXP, i) = xp = xt[k];
            tree(kVP, i) = vp = vt[k];
            tree(kGP, i) = gt[k];
            xm = tree(kXM, i);
            vm = tree(kVM, i);
          } else {
            tree(kXM, i) = xm = xt[k];
            tree(kVM, i) = vm = -vt[k];
            tree(kGM, i) = gt[k];
            xp = tree(kXP, i);
            vp = tree(kVP, i);
          }
          dm = proj(dm, xp, xm, vm, i);
          dp = proj(dp, xp, xm, vp, i);
        }
        put(kEndM, dm);
        put(kEndP, dp);
      }
      prof.sync(kPhRoundEnd);
      if (!done) done = stop || col_sum(kEndM) < 0.f || col_sum(kEndP) < 0.f;
      prof.mark(kPhRoundEnd);
    }

    // the post-transition x, weight 1
    const bool emit_now = EMIT && (t + 1) % a.thin == 0;
    const size_t emit_row = t / a.thin;
    if (chain_live) {
      evals += nl;
      kadd(w, wc, 1.f);
      if (emit_now && r == 0) {
        a.ws[emit_row * n + chain] = 1.f;
        a.es[emit_row * n + chain] = evals;
      }
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        kadd(wx[k], wxc[k], x[k]);
        kadd(wx2[k], wx2c[k], x[k] * x[k]);
        if (emit_now) a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
      }
    }
    prof.mark(kPhOther);
  }

  if (chain_live) {
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const size_t gi = (size_t)dim(k) * n + chain;
      a.xo[gi] = x[k];
      a.go[gi] = g[k];
      a.wx[gi] = wx[k];
      a.wx2[gi] = wx2[k];
    }
    if (r == 0) {
      a.uo[chain] = u;
      a.hbo[chain] = a.h_back[chain];
      a.valido[chain] = a.valid[chain];
      a.w[chain] = w;
      a.evals[chain] = evals;
    }
  }
  prof.mark(kPhOther);
  prof.write(a, T);
}

// NUTS of energy E at precision P, run or stream (EMIT), without (BR=false)
// or with an inverse mass; the PROF instance writes the breakdown to a.prof
template <int E, int P, bool EMIT, bool BR, bool PROF = false>
cudaError_t launch_nuts(const Args& a, cudaStream_t stream) {
  using L = NutsLayout<E, P>;
  if (!NutsTile<E>::ONCHIP && !a.scratch) return cudaErrorInvalidValue;
  const int bytes = L::floats(a.m) * (int)sizeof(float);
  void (*kernel)(Args) = nuts_mm_kernel<E, EMIT, BR, P, PROF>;
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + L::NC - 1) / L::NC, L::T, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int E, int D, int K, int C, int T, int VAR, bool EMIT, bool STUB, bool BR, int P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = Layout<E, D, K, C, P>::kFloats * sizeof(float);
  constexpr int CH = VAR == kMjhmc ? C : 2 * C;  // chains per block
  void (*kernel)(Args) = mm_kernel<E, D, K, C, T, VAR, EMIT, STUB, BR, P>;
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + CH - 1) / CH, T, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Step body VAR of energy E at precision P, run or stream (emit): MJHMC and
// NUTS without a mass and with the leapfrog take their fast-path instances
// (BR=false; NUTS takes no other integrator), the rest the BR=true ones.
template <int E, int P, int VAR>
cudaError_t launch_body(const Args& a, bool emit, cudaStream_t s) {
  using S = Shape<E>;
  if constexpr (VAR == kNuts) {
    if (!a.mass && !a.two_stage)
      return emit ? launch_nuts<E, P, true, false>(a, s) : launch_nuts<E, P, false, false>(a, s);
    return emit ? launch_nuts<E, P, true, true>(a, s) : launch_nuts<E, P, false, true>(a, s);
  }
  if constexpr (VAR == kMjhmc) {
    if (!a.mass && !a.two_stage)
      return emit ? launch<E, S::D, S::K, kC, S::T, VAR, true, false, false, P>(a, s)
                  : launch<E, S::D, S::K, kC, S::T, VAR, false, false, false, P>(a, s);
  }
  return emit ? launch<E, S::D, S::K, kC, S::T, VAR, true, false, true, P>(a, s)
              : launch<E, S::D, S::K, kC, S::T, VAR, false, false, true, P>(a, s);
}

// The NUTS run of energy E at precision P without a mass: its PROF
// instance (the per-leaf phase breakdown into a.prof; nothing on the main
// path runs it), and its tile: chains and threads a block, shared-memory
// bytes at max_depth, and the blocks an SM holds at once (the card's
// occupancy query, which counts registers too)
template <int E, int P>
cudaError_t launch_nuts_prof(const Args& a, cudaStream_t s) {
  return launch_nuts<E, P, false, false, true>(a, s);
}
template <int E, int P>
cudaError_t nuts_tile(int max_depth, int* out) {
  using L = NutsLayout<E, P>;
  out[0] = L::NC;
  out[1] = L::T;
  out[2] = L::floats(max_depth) * (int)sizeof(float);
  void (*kernel)(Args) = nuts_mm_kernel<E, false, false, P, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, L::T, out[2]);
}

// The precision sweep's instances: the MJHMC leapfrog run without a mass
// of energy E at precision P (anything else is refused)
template <int E, int P>
cudaError_t launch_sweep(const Args& a, bool emit, cudaStream_t s) {
  using S = Shape<E>;
  if (emit || a.mass || a.two_stage) return cudaErrorInvalidValue;
  return launch<E, S::D, S::K, kC, S::T, kMjhmc, false, false, false, P>(a, s);
}

// The instances, each compiled in the source named beside it (an instance
// declared here and compiled nowhere fails the build's link): every body at
// kHighest and at the JAX preset's default precision (ProductOfTSpec and
// LogregSpec "default", SparseCodingSpec "bf16x3"), and the sweep's other
// two precisions of product of t and sparse coding
// (cuda_mjhmc.MM_KERNEL_PRECISIONS)
using Launch = cudaError_t(const Args&, bool, cudaStream_t);
// mjhmc_mm_engine.cu
extern template Launch launch_body<kProductOfT, kHighest, kMjhmc>;
extern template Launch launch_body<kProductOfT, kHighest, kControl>;
extern template Launch launch_body<kProductOfT, kHighest, kMalt>;
// mm_nuts_product_of_t.cu
extern template Launch launch_body<kProductOfT, kHighest, kNuts>;
extern template cudaError_t nuts_tile<kProductOfT, kHighest>(int, int*);
// mm_engine_sparse_coding.cu
extern template Launch launch_body<kSparseCoding, kHighest, kMjhmc>;
extern template Launch launch_body<kSparseCoding, kHighest, kControl>;
extern template Launch launch_body<kSparseCoding, kHighest, kMalt>;
// mm_nuts_sparse_coding.cu
extern template Launch launch_body<kSparseCoding, kHighest, kNuts>;
extern template cudaError_t nuts_tile<kSparseCoding, kHighest>(int, int*);
// mm_engine_logreg.cu
extern template Launch launch_body<kLogreg, kHighest, kMjhmc>;
extern template Launch launch_body<kLogreg, kHighest, kControl>;
extern template Launch launch_body<kLogreg, kHighest, kMalt>;
// mm_nuts_logreg.cu
extern template Launch launch_body<kLogreg, kHighest, kNuts>;
extern template cudaError_t nuts_tile<kLogreg, kHighest>(int, int*);
// mm_engine_product_of_t_default.cu
extern template Launch launch_body<kProductOfT, kDefault, kMjhmc>;
extern template Launch launch_body<kProductOfT, kDefault, kControl>;
extern template Launch launch_body<kProductOfT, kDefault, kMalt>;
// mm_nuts_product_of_t_default.cu
extern template Launch launch_body<kProductOfT, kDefault, kNuts>;
extern template cudaError_t launch_nuts_prof<kProductOfT, kDefault>(const Args&, cudaStream_t);
extern template cudaError_t nuts_tile<kProductOfT, kDefault>(int, int*);
// mm_engine_sparse_coding_bf16x3.cu
extern template Launch launch_body<kSparseCoding, kBf16x3, kMjhmc>;
extern template Launch launch_body<kSparseCoding, kBf16x3, kControl>;
extern template Launch launch_body<kSparseCoding, kBf16x3, kMalt>;
// mm_nuts_sparse_coding_bf16x3.cu
extern template Launch launch_body<kSparseCoding, kBf16x3, kNuts>;
extern template cudaError_t launch_nuts_prof<kSparseCoding, kBf16x3>(const Args&, cudaStream_t);
extern template cudaError_t nuts_tile<kSparseCoding, kBf16x3>(int, int*);
// mm_engine_logreg_default.cu
extern template Launch launch_body<kLogreg, kDefault, kMjhmc>;
extern template Launch launch_body<kLogreg, kDefault, kControl>;
extern template Launch launch_body<kLogreg, kDefault, kMalt>;
// mm_nuts_logreg_default.cu
extern template Launch launch_body<kLogreg, kDefault, kNuts>;
extern template cudaError_t launch_nuts_prof<kLogreg, kDefault>(const Args&, cudaStream_t);
extern template cudaError_t nuts_tile<kLogreg, kDefault>(int, int*);
// mm_sweep.cu
extern template Launch launch_sweep<kProductOfT, kBf16x3>;
extern template Launch launch_sweep<kProductOfT, kBf16x2>;
extern template Launch launch_sweep<kSparseCoding, kBf16x2>;
extern template Launch launch_sweep<kSparseCoding, kDefault>;

}  // namespace mm
}  // namespace mjhmc
