// Fused MJHMC, control HMC and MALT engines for the matmul energies on
// Hopper (sm_90a): a whole sampling run in one launch. This header holds the
// kernel as a template; mjhmc_mm_engine.cu compiles the product-of-t
// instances and the C entry, mm_engine_sparse_coding.cu the sparse-coding
// instances, each by its own nvcc (ops/_build.py).
//
// Replaces the TPU kernels _mjhmc_mm_kernel and _mjhmc_mm_stream_kernel
// (mjhmc_tpu/ops/pallas_mjhmc.py:1265 and :1596) with the step bodies
// _make_step (:714, "mjhmc"), _make_step_control (:863) and _make_step_malt
// (:938), the ProductOfTSpec (:379) and SparseCodingSpec (:468) energies,
// a diagonal inverse mass and the two-stage integrator. One templated
// kernel serves all: EMIT=false is the run, EMIT=true also streams every
// thin-th iteration's x (MJHMC: pre-transition, with its dwell weight;
// control and MALT: post-transition, weight 1) and cumulative evals with
// plain coalesced stores (no row padding).
//
// Design: a block owns a tile of chains. It loads the parameter matrix
// (W, or Φ and the patch) into shared memory once, in both orientations,
// so that each contraction reads it along contiguous rows. The trajectories
// of the tile are the NC = 2C columns of (d, NC) arrays X, V, G in shared
// memory: MJHMC spends them on the forward and backward trajectories of C
// chains, control and MALT (forward trajectories only) on 2C chains, so all
// three bodies run the same tile width. Every leapfrog step runs the
// energy's two contractions over all NC columns at once (product of t: y =
// Wᵀx, then W·dU/dy; sparse coding: r = patch − Φa, then Φᵀr), each thread
// summing a 4×4 register tile in FP32 FMA, with __syncthreads() between the
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
// What bounds it: FP32 FMA throughput in the contractions (~3.3e5 multiply-adds
// per chain and iteration for sparse coding at M=10, ~1.3e4 for product of
// t at M=5) and the latency of the 3M+4 block barriers per iteration (MALT
// adds four per step; two-stage doubles the contractions); and shared
// memory per block (~124 KB for sparse coding at C=16, so one block per
// SM), which caps the warps an SM holds. MALT also draws (2M+1)·d normals
// per chain and iteration, each from two Philox blocks (the owner of
// element (i, chain) computes words i and d+i), which at product of t's
// small k is comparable to the contractions. The 4×4 register tiles give
// each thread 16 independent FMA chains per shared-memory load pair, and
// the warps of a tile read the same matrix row (broadcast) and neighbouring
// columns of the state. Control and MALT hold twice the (dim, chain)
// elements per thread (16 at sparse coding), which raises register
// pressure. Tensor cores (3xTF32 or split-bf16 mma) are left for later: a
// single TF32 or bf16 pass is not accurate enough for sparse coding, whose
// fit term multiplies the residual error by σ⁻² = 100.
//
// Random numbers: Philox4x32-10 keyed (seed, 0), laid out in philox.cuh:
// MJHMC counter (chain, iteration, block, 0), 1 + 2d words per iteration
// (word 0 picks the clock, drawn by the chain's thread; words 1+i and 1+d+i
// make dim i's Box-Muller normal, drawn by the thread owning element (i,
// chain)); control tag 4, MALT tags 5 and 6, each normal from words i and
// d+i and the Metropolis uniform from word 2d. The plain PyTorch version
// (ops/cuda_mjhmc.py) computes the same words. No fast-math: the Kahan sums
// and the plain-version comparisons need IEEE arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mjhmc {
namespace mm {

constexpr float kLogRateMax = 25.0f;
constexpr float kNegInf = -1e30f;
constexpr float kTwoPi = 6.283185307179586f;

enum Energy { kProductOfT = 0, kSparseCoding = 1 };
enum Choice { kL = 0, kF = 1, kR = 2 };
// the step bodies, numbered as the elementwise kernel's (NUTS is not here)
enum Variant { kMjhmc = 0, kControl = 2, kMalt = 3 };

// BCSS two-stage coefficient b and 1 - 2b, rounded to float once
constexpr float kTwoStageB = 0.1931833275037836f;
constexpr float kTwoStageMid = static_cast<float>(1.0 - 2.0 * 0.1931833275037836);

struct Args {
  const float* p0;  // product of t: W (d, k); sparse coding: Φ (p, b)
  const float* p1;  // sparse coding: the patch (p,)
  // product of t: ν+1, ν, ½(ν+1), 1/ν; sparse coding: λ, σ⁻², ½σ⁻², ε
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
};

// Shared-memory layout, in floats. D: state dims; K: rows of the energy's
// intermediate (product of t: nbasis; sparse coding: npixels).
template <int E, int D, int K, int C>
struct Layout {
  static_assert(D % 4 == 0 && K % 4 == 0 && C % 2 == 0, "float4 tiles");
  static constexpr int NC = 2 * C;          // trajectory columns
  static constexpr int A1 = 0;              // [D][K]: W | Φᵀ
  static constexpr int A2 = A1 + D * K;     // [K][D]: Wᵀ | Φ
  static constexpr int PATCH = A2 + K * D;  // [K]
  static constexpr int X = PATCH + K;       // [D][NC] trajectory positions
  static constexpr int V = X + D * NC;      // [D][NC] momenta
  static constexpr int G = V + D * NC;      // [D][NC] gradients
  static constexpr int Y = G + D * NC;      // [K][NC] y | r
  static constexpr int Z = Y + K * NC;      // [K][NC] dU/dy (product of t)
  static constexpr int HEND = Z + (E == kProductOfT ? K * NC : 0);  // [NC]
  static constexpr int UEND = HEND + NC;    // [NC]
  static constexpr int DWELL = UEND + NC;   // [C]
  static constexpr int SEL = DWELL + C;     // [NC] choice, as int
  static constexpr int MASS = SEL + NC;     // [2D] M^-1, sqrt(M) (1 without)
  static constexpr int kFloats = MASS + 2 * D;
};

// out[r][col] = Σ_k A[k][r]·B[k][col] for r < R, col < NC: A is [KD][R],
// B is [KD][NC], both row-major in shared memory. Each task sums a 4×4
// tile in registers and hands it to epi(r0, c0, acc). With STUB the sum is
// replaced by 1e-3·B[0][col] on every row (MatmulEnergySpec._dot's
// stub_dots ablation): the tiles, epilogues and barriers stay, the
// multiply-adds go.
template <int KD, int R, int NC, int T, bool STUB, class Epi>
__device__ __forceinline__ void contract(const float* __restrict__ A,
                                         const float* __restrict__ B, Epi epi) {
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
    epi(r0, c0, acc);
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
  } else {
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

// VAR: kMjhmc (both trajectories of C chains in the NC = 2C columns), or
// kControl / kMalt (the forward trajectories of NC chains, one a column).
// BR=false compiles neither the mass nor the two-stage integrator (MJHMC's
// fast path, as the TPU kernel compiles them statically); BR=true takes
// both from the arguments.
template <int E, int D, int K, int C, int T, int VAR, bool EMIT, bool STUB, bool BR>
__global__ void __launch_bounds__(T) mm_kernel(Args a) {
  using L = Layout<E, D, K, C>;
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
  float* SQM = IM + D;

  const int tid = threadIdx.x;
  const int chain0 = blockIdx.x * CH;
  const size_t n = a.n;
  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  // the parameter matrix in both orientations, the patch and the mass
  for (int idx = tid; idx < D * K; idx += T) {
    const float val = a.p0[idx];
    if constexpr (E == kProductOfT) {  // p0 = W (D, K)
      A1[idx] = val;
      A2[(idx % K) * D + idx / K] = val;
    } else {  // p0 = Φ (K, D)
      A2[idx] = val;
      A1[(idx % D) * K + idx / D] = val;
    }
  }
  if constexpr (E == kSparseCoding)
    for (int idx = tid; idx < K; idx += T) patch[idx] = a.p1[idx];
  if (BR)
    for (int idx = tid; idx < 2 * D; idx += T) IM[idx] = a.mass ? a.mass[idx] : 1.f;

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
  // v −= c_kick·g (if kick), x += c_drift·M^-1·v on all columns
  auto kick_drift = [&](bool kick, float c_kick, float c_drift) {
    float4* X4 = reinterpret_cast<float4*>(X);
    float4* V4 = reinterpret_cast<float4*>(V);
    const float4* G4 = reinterpret_cast<const float4*>(G);
    for (int q = tid; q < D * NC / 4; q += T) {
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
  };
  // g = ∇U(X) on all columns by the energy's two contractions, then the
  // closing kick v −= c_kick·g
  auto force_kick = [&](float c_kick) {
    if constexpr (E == kProductOfT) {
      // y = Wᵀx; keep y (for the energies) and dU/dy
      contract<D, K, NC, T, STUB>(A1, X, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float y = acc[i][j];
            Y[(r0 + i) * NC + c0 + j] = y;
            Z[(r0 + i) * NC + c0 + j] = a.k0 * y / (a.k1 + y * y);
          }
      });
      __syncthreads();
      // g = W·dU/dy, and the closing kick
      contract<K, D, NC, T, STUB>(A2, Z, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int idx = (r0 + i) * NC + c0 + j;
            G[idx] = acc[i][j];
            V[idx] = V[idx] - c_kick * acc[i][j];
          }
      });
    } else {
      // r = patch − Φa
      contract<D, K, NC, T, STUB>(A1, X, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Y[(r0 + i) * NC + c0 + j] = patch[r0 + i] - acc[i][j];
      });
      __syncthreads();
      // g = λ·a/√(a²+ε) − σ⁻²·Φᵀr, and the closing kick
      contract<K, D, NC, T, STUB>(A2, Y, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int idx = (r0 + i) * NC + c0 + j;
            const float av = X[idx];
            const float s = sqrtf(av * av + a.k3);
            const float gv = a.k0 * (av / s) - a.k1 * acc[i][j];
            G[idx] = gv;
            V[idx] = V[idx] - c_kick * gv;
          }
      });
    }
    __syncthreads();
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

template <int E, int D, int K, int C, int T, int VAR, bool EMIT, bool STUB, bool BR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = Layout<E, D, K, C>::kFloats * sizeof(float);
  constexpr int CH = VAR == kMjhmc ? C : 2 * C;  // chains per block
  void (*kernel)(Args) = mm_kernel<E, D, K, C, T, VAR, EMIT, STUB, BR>;
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + CH - 1) / CH, T, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the run and stream instances of one energy shape and variant; MJHMC
// without a mass and with the leapfrog takes its fast-path instances
template <int E, int D, int K, int C, int T, int VAR>
cudaError_t launch_emit(const Args& a, bool emit, cudaStream_t s) {
  if constexpr (VAR == kMjhmc) {
    if (!a.mass && !a.two_stage)
      return emit ? launch<E, D, K, C, T, VAR, true, false, false>(a, s)
                  : launch<E, D, K, C, T, VAR, false, false, false>(a, s);
  }
  return emit ? launch<E, D, K, C, T, VAR, true, false, true>(a, s)
              : launch<E, D, K, C, T, VAR, false, false, true>(a, s);
}

// the sparse-coding instances (mm_engine_sparse_coding.cu)
cudaError_t launch_sparse_coding(int variant, const Args& a, bool emit, cudaStream_t s);

}  // namespace mm
}  // namespace mjhmc
