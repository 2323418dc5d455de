// Fused MJHMC engine for the matmul energies on Hopper (sm_90a): a whole
// sampling run in one launch.
//
// Replaces the TPU kernels _mjhmc_mm_kernel and _mjhmc_mm_stream_kernel
// (mjhmc_tpu/ops/pallas_mjhmc.py:1265 and :1596), both built from the step
// body _make_step (:714, variant "mjhmc", leapfrog, no inverse mass) with the
// ProductOfTSpec (:379) and SparseCodingSpec (:468) energies. One templated
// kernel serves both: EMIT=false is the run, EMIT=true also streams every
// thin-th iteration's pre-transition x, dwell weight and cumulative evals
// with plain coalesced stores (no row padding).
//
// Design: a block owns a tile of C chains. It loads the parameter matrix
// (W, or Φ and the patch) into shared memory once, in both orientations,
// so that each contraction reads it along contiguous rows. The forward and
// backward trajectories of the tile are the 2C columns of (d, 2C) arrays
// X, V, G in shared memory; every leapfrog step runs the energy's two
// contractions over all 2C columns at once (product of t: y = Wᵀx, then
// W·dU/dy; sparse coding: r = patch − Φa, then Φᵀr), each thread summing a
// 4×4 register tile in FP32 FMA, with __syncthreads() between the phases.
// The endpoint energies reuse the last step's y or r. The current point
// (x, v, g) and the Kahan pairs of each (dim, chain) element live in
// registers of the thread that owns the element; the per-chain scalars
// (u, h_back, valid, Σw, evals) in registers of one thread per chain.
//
// What bounds it: FP32 FMA throughput in the contractions (~3.3e5 multiply-adds
// per chain and iteration for sparse coding at M=10, ~1.3e4 for product of
// t at M=5) and the latency of the 3M+4 block barriers per iteration; and
// shared memory per block (~124 KB for sparse coding at C=16, so one block
// per SM), which caps the warps an SM holds. The 4×4 register tiles give
// each thread 16 independent FMA chains per shared-memory load pair, and
// the warps of a tile read the same matrix row (broadcast) and neighbouring
// columns of the state. Tensor cores (3xTF32 or split-bf16 mma) are left for
// later: a single TF32 or bf16 pass is not accurate enough for sparse
// coding, whose fit term multiplies the residual error by σ⁻² = 100.
//
// Random numbers: Philox4x32-10 keyed (seed, 0), counter (chain, iteration,
// block, 0), 1 + 2d words per iteration: word 0 picks the clock (drawn by
// the chain's thread), words 1+i and 1+d+i make dim i's Box-Muller normal
// (drawn by the thread owning element (i, chain)). The plain PyTorch version
// (ops/cuda_mjhmc.py) computes the same words. No fast-math: the Kahan sums
// and the plain-version comparisons need IEEE arithmetic.
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
};

// Shared-memory layout, in floats. D: state dims; K: rows of the energy's
// intermediate (product of t: nbasis; sparse coding: npixels).
template <int E, int D, int K, int C>
struct Layout {
  static_assert(D % 4 == 0 && K % 4 == 0 && C % 2 == 0, "float4 tiles");
  static constexpr int NC = 2 * C;          // forward and backward columns
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
  static constexpr int SEL = DWELL + C;     // [C] choice, as int
  static constexpr int kFloats = SEL + C;
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

template <int E, int D, int K, int C, int T, bool EMIT, bool STUB>
__global__ void __launch_bounds__(T) mm_kernel(Args a) {
  using L = Layout<E, D, K, C>;
  constexpr int NC = L::NC;
  constexpr int NE = (D * C + T - 1) / T;  // (dim, chain) elements per thread
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

  const int tid = threadIdx.x;
  const int chain0 = blockIdx.x * C;
  const size_t n = a.n;
  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  // the parameter matrix in both orientations, and the patch
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

  // owned elements e = tid + k·T: dim e / C, chain e % C of the tile; the
  // chains past n (ragged last tile) run on zeros and are never stored
  float x[NE], v[NE], g[NE], wx[NE], wxc[NE], wx2[NE], wx2c[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = tid + k * T, i = e / C, c = e % C;
    const bool live = e < D * C && chain0 + c < a.n;
    const size_t gi = (size_t)i * n + chain0 + c;
    x[k] = live ? a.x[gi] : 0.f;
    v[k] = live ? a.v[gi] : 0.f;
    g[k] = live ? a.g[gi] : 0.f;
    wx[k] = wxc[k] = wx2[k] = wx2c[k] = 0.f;
  }
  // per-chain scalars, held by thread c < C for chain c of the tile
  const int chain = chain0 + tid;
  const bool chain_live = tid < C && chain < a.n;
  float u = chain_live ? a.u[chain] : 0.f;
  float h_back = chain_live ? a.h_back[chain] : 0.f;
  float valid = chain_live ? a.valid[chain] : 0.f;
  float w = 0.f, wc = 0.f, h_cur = 0.f;
  int evals = 0;

  for (int t = 0; t < a.num_iters; ++t) {
    // forward from (x, v) and backward from (x, -v): columns c and C + c
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = tid + k * T, i = e / C, c = e % C;
      if (e < D * C) {
        X[i * NC + c] = X[i * NC + C + c] = x[k];
        V[i * NC + c] = v[k];
        V[i * NC + C + c] = -v[k];
        G[i * NC + c] = G[i * NC + C + c] = g[k];
      }
    }
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int i = 0; i < D; ++i) s += V[i * NC + tid] * V[i * NC + tid];
      h_cur = u + 0.5f * s;
    }
    __syncthreads();

    for (int step = 0; step < a.m; ++step) {
      // half kick and drift on all 2C columns (V then holds the half-step v)
      float4* X4 = reinterpret_cast<float4*>(X);
      float4* V4 = reinterpret_cast<float4*>(V);
      const float4* G4 = reinterpret_cast<const float4*>(G);
      for (int q = tid; q < D * NC / 4; q += T) {
        float4 xq = X4[q], vq = V4[q];
        const float4 gq = G4[q];
        vq.x = vq.x - he * gq.x;
        vq.y = vq.y - he * gq.y;
        vq.z = vq.z - he * gq.z;
        vq.w = vq.w - he * gq.w;
        xq.x = xq.x + eps * vq.x;
        xq.y = xq.y + eps * vq.y;
        xq.z = xq.z + eps * vq.z;
        xq.w = xq.w + eps * vq.w;
        X4[q] = xq;
        V4[q] = vq;
      }
      __syncthreads();
      if constexpr (E == kProductOfT) {
        // y = Wᵀx; keep y (for the endpoint energy) and dU/dy
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
        // g = W·dU/dy, and the closing half kick
        contract<K, D, NC, T, STUB>(A2, Z, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int idx = (r0 + i) * NC + c0 + j;
              G[idx] = acc[i][j];
              V[idx] = V[idx] - he * acc[i][j];
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
        // g = λ·a/√(a²+ε) − σ⁻²·Φᵀr, and the closing half kick
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
              V[idx] = V[idx] - he * gv;
            }
        });
      }
      __syncthreads();
    }

    // endpoint energies of both trajectories from the last step's y or r
    if (tid < NC) {
      float uc;
      if constexpr (E == kProductOfT) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) {
          const float y = Y[j * NC + tid];
          s += log1pf(y * y * a.k3);
        }
        uc = a.k2 * s;
      } else {
        float s1 = 0.f, s2 = 0.f;
        for (int i = 0; i < D; ++i) {
          const float av = X[i * NC + tid];
          s1 += sqrtf(av * av + a.k3);
        }
        for (int p = 0; p < K; ++p) {
          const float r = Y[p * NC + tid];
          s2 += r * r;
        }
        uc = a.k0 * s1 + a.k2 * s2;
      }
      float hv = 0.f;
      for (int i = 0; i < D; ++i) hv += V[i * NC + tid] * V[i * NC + tid];
      uend[tid] = uc;
      hend[tid] = uc + 0.5f * hv;
    }
    __syncthreads();

    const bool emit_now = EMIT && (t + 1) % a.thin == 0;
    const size_t emit_row = t / a.thin;
    if (tid < C) {
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

      evals += valid > 0.5f ? a.m : 2 * a.m;
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
    }
    __syncthreads();

    // accumulators and emissions take the pre-transition x; then the move
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = tid + k * T, i = e / C, c = e % C;
      if (e < D * C) {
        const float dwell = dwell_s[c];
        kadd(wx[k], wxc[k], dwell * x[k]);
        kadd(wx2[k], wx2c[k], dwell * x[k] * x[k]);
        if (emit_now && chain0 + c < a.n)
          a.xs[(emit_row * D + i) * n + chain0 + c] = x[k];
        const int sel = sel_s[c];
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
          v[k] = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = tid + k * T, i = e / C, c = e % C;
    if (e < D * C && chain0 + c < a.n) {
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

template <int E, int D, int K, int C, int T, bool EMIT, bool STUB = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = Layout<E, D, K, C>::kFloats * sizeof(float);
  void (*kernel)(Args) = mm_kernel<E, D, K, C, T, EMIT, STUB>;
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + C - 1) / C, T, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mm
}  // namespace mjhmc

// Plain C entry for ctypes. xs/ws/es == NULL runs without emissions; stub
// != 0 runs the stub_dots ablation. Instances: product of t (d, k) =
// (36, 36) and sparse coding (d, p) = (128, 64), the presets' shapes, and
// the stubbed product-of-t run (the roofline dossier's ablation row).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mjhmc_mm_engine_launch(
    int energy, int ndims, int krows, int stub, const float* p0, const float* p1,
    float k0, float k1, float k2, float k3, const float* x, const float* v,
    const float* g, const float* u, const float* h_back, const float* valid,
    float* xo, float* vo, float* go, float* uo, float* hbo, float* valido,
    float* w, float* wx, float* wx2, int* evals, float* xs, float* ws, int* es,
    int n, int num_iters, int thin, int m, unsigned int seed, float eps,
    float beta, int fixed_uniform, void* stream) {
  using namespace mjhmc::mm;
  if (n <= 0 || thin <= 0 || m <= 0) return cudaErrorInvalidValue;
  Args a{p0, p1, k0, k1, k2, k3, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta};
  const bool emit = xs != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy == kProductOfT && ndims == 36 && krows == 36) {
    if (stub)
      return emit ? cudaErrorInvalidValue
                  : launch<kProductOfT, 36, 36, 16, 96, false, true>(a, s);
    return emit ? launch<kProductOfT, 36, 36, 16, 96, true>(a, s)
                : launch<kProductOfT, 36, 36, 16, 96, false>(a, s);
  }
  if (energy == kSparseCoding && ndims == 128 && krows == 64 && p1 != nullptr && !stub)
    return emit ? launch<kSparseCoding, 128, 64, 16, 256, true>(a, s)
                : launch<kSparseCoding, 128, 64, 16, 256, false>(a, s);
  return cudaErrorInvalidValue;
}
