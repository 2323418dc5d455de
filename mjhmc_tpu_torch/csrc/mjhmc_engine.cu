// Fused MJHMC engine for Hopper (sm_90a): a whole sampling run in one launch.
//
// Replaces the TPU kernels _mjhmc_kernel and _mjhmc_stream_kernel
// (mjhmc_tpu/ops/pallas_mjhmc.py:1451 and :1494), both built from the step
// body _make_step (:714, variant "mjhmc", leapfrog, no inverse mass) with the
// RoughWellSpec (:80) and GaussianSpec (:99) energies. One templated kernel
// serves both: EMIT=false is the run, EMIT=true also streams every thin-th
// iteration's pre-transition x, dwell weight and cumulative evals.
//
// Design: one thread per chain; the state (x, v, g, u, h_back, valid), both
// trajectories and the Kahan pairs live in registers for the whole run, so
// device memory is touched only to load the state, store the results and,
// in the stream, store the emissions. Loads and stores use the (d, n)
// layout, so neighbouring threads touch neighbouring addresses.
//
// What bounds it: FP32 and SFU work per leapfrog step (one sinf per
// dimension and step for the rough well), one step after another within a
// chain. About 10k chains give each of the 132 SMs one or two warps, far
// too few to hide the latency of those dependent chains; 100k chains fill
// the card better. At D=50 the per-thread state spills out of registers.
// The simple design does nothing about either yet.
//
// Semantics follow _make_step exactly: log-rates clipped at 25 with
// non-finite energies sent to -1e30 (|h| < 1e30 and h == h), Γ_F =
// max(0, exp(log Γ_L(Fζ)) − Γ_L), inverse-CDF choice of L, F or R from one
// uniform times the total rate, evals M (2M when the cache is invalid), the
// h_back cache update, and Kahan sums of the pre-transition x. No fast-math:
// x/scale2 reaches ~100 rad, where __sinf/__cosf would bend the ripples.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mjhmc {

constexpr int kThreads = 64;
constexpr float kLogRateMax = 25.0f;
constexpr float kNegInf = -1e30f;
constexpr float kTwoPi = 6.283185307179586f;

enum Energy { kRoughWell = 0, kGaussian = 1 };

struct Args {
  const float* params;  // (d,) per-dim parameters (Gaussian precisions)
  float k0, k1, k2, k3, k4;  // scalar energy constants (rough well)
  const float *x, *v, *g, *u, *h_back, *valid;
  float *xo, *vo, *go, *uo, *hbo, *valido, *w, *wx, *wx2;
  int* evals;
  float *xs, *ws;  // stream emissions (EMIT only)
  int* es;
  int n, num_iters, thin, m, fixed_uniform;
  uint32_t seed;
  float eps, beta;
};

// rough well: du = x/s1² − sin(x/s2)·a/s2, u = Σ x²/(2 s1²) + a·cos(x/s2),
// with k0=1/s1², k1=1/s2, k2=a/s2, k3=0.5/s1², k4=a (RoughWellSpec's forms)
template <int E>
__device__ __forceinline__ float du(float x, float p, const Args& a) {
  if (E == kRoughWell) return x * a.k0 - sinf(x * a.k1) * a.k2;
  return x * p;
}

template <int E, int D>
__device__ __forceinline__ float u_sum(const float (&x)[D], const float (&p)[D],
                                       const Args& a) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (E == kRoughWell)
      s += x[i] * x[i] * a.k3 + a.k4 * cosf(x[i] * a.k1);
    else
      s += x[i] * x[i] * p[i];
  }
  return E == kRoughWell ? s : 0.5f * s;
}

template <int D>
__device__ __forceinline__ float halfsq(const float (&v)[D]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) s += v[i] * v[i];
  return 0.5f * s;
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

template <int D, int E, bool EMIT>
__global__ void __launch_bounds__(kThreads) mjhmc_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const size_t n = a.n;

  float p[D], x[D], v[D], g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    p[i] = E == kGaussian ? a.params[i] : 0.f;
    x[i] = a.x[i * n + c];
    v[i] = a.v[i * n + c];
    g[i] = a.g[i * n + c];
  }
  float u = a.u[c], h_back = a.h_back[c], valid = a.valid[c];

  float w = 0.f, wc = 0.f;
  float wx[D], wxc[D], wx2[D], wx2c[D];
#pragma unroll
  for (int i = 0; i < D; ++i) wx[i] = wxc[i] = wx2[i] = wx2c[i] = 0.f;
  int evals = 0;

  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  for (int t = 0; t < a.num_iters; ++t) {
    const float h_cur = u + halfsq<D>(v);

    // forward from (x, v) and backward from (x, -v), M steps each
    float xf[D], vf[D], gf[D], xb[D], vb[D], gb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      xf[i] = xb[i] = x[i];
      vf[i] = v[i];
      vb[i] = -v[i];
      gf[i] = gb[i] = g[i];
    }
    for (int k = 0; k < a.m; ++k) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float vfh = vf[i] - he * gf[i];
        xf[i] = xf[i] + eps * vfh;
        gf[i] = du<E>(xf[i], p[i], a);
        vf[i] = vfh - he * gf[i];

        const float vbh = vb[i] - he * gb[i];
        xb[i] = xb[i] + eps * vbh;
        gb[i] = du<E>(xb[i], p[i], a);
        vb[i] = vbh - he * gb[i];
      }
    }
    const float uf = u_sum<E, D>(xf, p, a);
    const float h_l = uf + halfsq<D>(vf);
    const float h_b = valid > 0.5f ? h_back : u_sum<E, D>(xb, p, a) + halfsq<D>(vb);

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
        : philox_uniform(philox4x32_10(make_uint4(c, t, 0u, 0u), key).x);
    const float u_sel = u0 * total;
    const bool is_l = u_sel < gamma_l;
    const bool is_f = !is_l && u_sel < gamma_l + gamma_f;
    const bool is_r = !is_l && !is_f;

    // accumulators and emissions take the pre-transition x
    evals += valid > 0.5f ? a.m : 2 * a.m;
    kadd(w, wc, dwell);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      kadd(wx[i], wxc[i], dwell * x[i]);
      kadd(wx2[i], wx2c[i], dwell * x[i] * x[i]);
    }
    if (EMIT && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
#pragma unroll
      for (int i = 0; i < D; ++i) a.xs[(e * D + i) * n + c] = x[i];
      a.ws[e * n + c] = dwell;
      a.es[e * n + c] = evals;
    }

    if (is_l) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        x[i] = xf[i];
        v[i] = vf[i];
        g[i] = gf[i];
      }
      u = uf;
      h_back = h_cur;
    } else if (is_f) {
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = -v[i];
      h_back = h_l;
    } else {
      // refresh v ~ N(0, I) by Box-Muller's cosine branch: dim i takes
      // words 1+i and 1+D+i of this iteration's 1+2D (blocks of four).
      // The counter fixes every word, so words no transition uses need
      // not be computed: the stream is the same as drawing all of them.
      constexpr int kWords = 1 + 2 * D;
      constexpr int kBlocks = (kWords + 3) / 4;
      float un[2 * D];
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        const uint4 r = philox4x32_10(make_uint4(c, t, b, 0u), key);
        const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * b + j;
          if (k >= 1 && k < kWords)
            un[k - 1] = a.fixed_uniform ? 0x1p-25f : philox_uniform(rw[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i)
        v[i] = sqrtf(-2.0f * logf(un[i])) * cosf(kTwoPi * un[D + i]);
    }
    valid = is_r ? 0.f : 1.f;
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    a.xo[i * n + c] = x[i];
    a.vo[i * n + c] = v[i];
    a.go[i * n + c] = g[i];
    a.wx[i * n + c] = wx[i];
    a.wx2[i * n + c] = wx2[i];
  }
  a.uo[c] = u;
  a.hbo[c] = h_back;
  a.valido[c] = valid;
  a.w[c] = w;
  a.evals[c] = evals;
}

template <int D, int E>
cudaError_t launch(const Args& a, bool emit, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (emit)
    mjhmc_kernel<D, E, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    mjhmc_kernel<D, E, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_energy(int energy, const Args& a, bool emit, cudaStream_t s) {
  if (energy == kRoughWell) return launch<D, kRoughWell>(a, emit, s);
  if (energy == kGaussian) return launch<D, kGaussian>(a, emit, s);
  return cudaErrorInvalidValue;
}

}  // namespace mjhmc

// Plain C entry for ctypes. xs/ws/es == NULL runs without emissions.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mjhmc_engine_launch(
    int ndims, int energy, const float* params, float k0, float k1, float k2,
    float k3, float k4, const float* x, const float* v, const float* g,
    const float* u, const float* h_back, const float* valid, float* xo,
    float* vo, float* go, float* uo, float* hbo, float* valido, float* w,
    float* wx, float* wx2, int* evals, float* xs, float* ws, int* es, int n,
    int num_iters, int thin, int m, unsigned int seed, float eps, float beta,
    int fixed_uniform, void* stream) {
  using namespace mjhmc;
  if (n <= 0 || thin <= 0) return cudaErrorInvalidValue;
  Args a{params, k0, k1, k2, k3, k4, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta};
  const bool emit = xs != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ndims) {
    case 2: return launch_energy<2>(energy, a, emit, s);
    case 50: return launch_energy<50>(energy, a, emit, s);
    default: return cudaErrorInvalidValue;
  }
}
