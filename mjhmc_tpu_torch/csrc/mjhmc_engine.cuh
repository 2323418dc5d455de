// Fused MJHMC engine for Hopper (sm_90a): a whole sampling run in one launch.
// This header holds the four step bodies' kernels as templates (MJHMC, NUTS,
// control HMC, MALT: each with its note below); mjhmc_engine.cu
// compiles the D=2 instances and the C entry, and the D=50 and zoo
// instances, which take most of the build, are compiled in sources of their
// own (mjhmc_engine_d50*.cu, nuts_engine_d50_*.cu, hmc_engine_d50.cu,
// zoo_*.cu), each by its own nvcc, all at once (ops/_build.py); the slowest
// instances have a source each, so that the build's longest nvcc stays short.
//
// Replaces the TPU kernels _mjhmc_kernel and _mjhmc_stream_kernel
// (mjhmc_tpu/ops/pallas_mjhmc.py:1451 and :1494), both built from the step
// body _make_step (:714, variant "mjhmc") with the RoughWellSpec (:80),
// GaussianSpec (:99), FunnelSpec (:113), BananaSpec (:149), MogSpec (:174)
// and EightSchoolsSpec (:554, centered and non-centered as two energies)
// energies. One templated kernel serves both: EMIT=false is the run,
// EMIT=true also streams every thin-th iteration's pre-transition x, dwell
// weight and cumulative evals.
//
// Two branches of every body are runtime arguments: a diagonal inverse
// mass (Args::mass, rows M^-1 and sqrt(M) = rsqrt(M^-1) as the wrapper
// computed them; nullptr is the identity) enters the drift M^-1 v, the
// kinetic energy (v*v)*M^-1 and every momentum draw (times sqrt(M)); two_stage != 0 swaps each leapfrog step for the BCSS
// two-stage splitting B(b eps) A(eps/2) B((1-2b) eps) A(eps/2) B(b eps)
// (_two_stage_half, :745), two gradients per step, charged 2M per
// trajectory half. Without a mass every factor is 1.0, which multiplies
// exactly. The MJHMC body also has an instance without either branch
// compiled in (BR=false, the headline path), as the TPU kernel compiles
// them statically.
//
// Design: one thread per chain; the state (x, v, g, u, h_back, valid), both
// trajectories and the Kahan pairs live in registers for the whole run, so
// device memory is touched only to load the state, store the results and,
// in the stream, store the emissions. Loads and stores use the (d, n)
// layout, so neighbouring threads touch neighbouring addresses. The zoo
// energies couple their dims, so their leapfrog step is a vector step: the
// kick and the drift of every dim, one gradient of the whole x (grad below),
// then the closing kick of every dim. The separable rough well and Gaussian
// keep the per-dim step (kSeparable below); each dim sees the same
// operations in the same order in either form, so only the speed differs.
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
//
// The same header holds the fused NUTS engine (nuts_kernel below), which
// replaces the "nuts" variant of the same two TPU kernels: the step body
// _make_step_nuts (:1011) with the same energies, EMIT forms and D.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mjhmc {

constexpr int kThreads = 64;
constexpr float kLogRateMax = 25.0f;
constexpr float kNegInf = -1e30f;
constexpr float kTwoPi = 6.283185307179586f;

// energy ids: the specs' energy_id (ops/cuda_mjhmc.py)
enum Energy {
  kRoughWell = 0,
  kGaussian = 1,
  kFunnel = 2,
  kBanana = 3,
  kMog = 4,
  kEightSchoolsCentered = 5,
  kEightSchoolsNoncentered = 6,
};
// most components of a mixture (MogSpec; the wrapper checks)
constexpr int kMogMaxComponents = 8;

struct Args {
  // per-energy parameters: the Gaussian's (d,) precisions, eight schools'
  // (2, d) rows y and 1/sigma^2, the mixture's (K, d) means and then four
  // rows of K (log w - d log sigma, 0.5/sigma^2, 1/sigma^2, |mu|^2)
  const float* params;
  float k0, k1, k2, k3, k4;  // scalar energy constants (each spec's constants())
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

// BCSS minimal-error two-stage coefficient (ops/leapfrog.py TWO_STAGE_B) and
// 1 - 2b, rounded to float once as the JAX kernel's weak-typed constants are
constexpr float kTwoStageB = 0.1931833275037836f;
constexpr float kTwoStageMid = static_cast<float>(1.0 - 2.0 * 0.1931833275037836);

// diagonal M^-1 and sqrt(M) of dim i (1 without a mass)
__device__ __forceinline__ float inv_mass(const float* mass, int i) {
  return mass ? __ldg(mass + i) : 1.f;
}
template <int D>
__device__ __forceinline__ float sqrt_mass(const float* mass, int i) {
  return mass ? __ldg(mass + D + i) : 1.f;
}

// Rounding policies of the arithmetic below. Fused lets nvcc contract a
// multiply and an add into one FMA (the MJHMC kernel). Rn rounds each
// operation on its own with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never
// contracts (the NUTS kernel, whose tree decisions must see the plain
// PyTorch version's roundings).
struct Fused {
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
  static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
  static __device__ __forceinline__ float div(float a, float b) { return a / b; }
};
struct Rn {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

// x·M^-1 of dim i, or x itself without a mass (which the rounded products
// of Rn would not fold away)
template <class R>
__device__ __forceinline__ float mass_mul(float x, const float* mass, int i) {
  return mass ? R::mul(x, __ldg(mass + i)) : x;
}

// What a thread loads once for its energy: the Gaussian's precisions and
// eight schools' y in p, eight schools' 1/sigma^2 in q. The other energies
// read only the scalars; the mixture reads its per-component values from
// the params vector inside the energy (the same address in every thread).
template <int E, int D>
struct Params {
  static constexpr bool kSchools = E == kEightSchoolsCentered || E == kEightSchoolsNoncentered;
  float p[D], q[D];
  __device__ __forceinline__ explicit Params(const Args& a) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      p[i] = E == kGaussian || kSchools ? a.params[i] : 0.f;
      q[i] = kSchools ? a.params[D + i] : 0.f;
    }
  }
};

// rough well: du = x/s1² − sin(x/s2)·a/s2, u = Σ x²/(2 s1²) + a·cos(x/s2),
// with k0=1/s1², k1=1/s2, k2=a/s2, k3=0.5/s1², k4=a (RoughWellSpec's forms);
// Gaussian: du = x·p
template <int E, class R = Fused>
__device__ __forceinline__ float du(float x, float p, const Args& a) {
  if (E == kRoughWell) return R::sub(R::mul(x, a.k0), R::mul(sinf(R::mul(x, a.k1)), a.k2));
  return R::mul(x, p);
}

// jnp.maximum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// The mixture's component logits (MogSpec._logits): log w_k − d log σ_k −
// ½/σ_k²·(‖x‖² − 2 μ_k·x + ‖μ_k‖²), zero means skipped; returns K
template <int D, class R>
__device__ __forceinline__ int mog_logits(const float (&x)[D], float (&lg)[kMogMaxComponents],
                                          const Args& a) {
  const int K = static_cast<int>(a.k0);
  const float* mu = a.params;
  const float* cst = a.params + K * D;
  float x2 = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) x2 = R::add(x2, R::mul(x[i], x[i]));
#pragma unroll
  for (int k = 0; k < kMogMaxComponents; ++k) {
    if (k >= K) break;
    float cross = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float m = __ldg(mu + k * D + i);
      if (m != 0.f) cross = R::add(cross, R::mul(m, x[i]));
    }
    const float sq = R::add(R::sub(x2, R::mul(2.f, cross)), __ldg(cst + 3 * K + k));
    lg[k] = R::sub(__ldg(cst + k), R::mul(__ldg(cst + K + k), sq));
  }
  return K;
}

// The rough well and the Gaussian are separable: each dim's gradient needs
// only that dim's x, so their leapfrog steps run kick, drift, du and kick one
// dim after another, which lets the forward and backward trajectories'
// steps interleave (the vector step is ~4% slower on the rough well,
// PERF.md §6). The zoo energies couple their dims and take the vector step
// with grad below.
template <int E>
constexpr bool kSeparable = E == kRoughWell || E == kGaussian;

// ∇U of every dim at once, in the plain spec's expressions and order
// (ops/cuda_mjhmc.py: FunnelSpec, BananaSpec, MogSpec, EightSchoolsSpec);
// the masked sums there start from rows of zeros, here from 0.
template <int E, int D, class R = Fused>
__device__ __forceinline__ void grad(const float (&x)[D], float (&g)[D], const Params<E, D>& P,
                                     const Args& a) {
  static_assert(!kSeparable<E>, "separable energies take du one dim at a time");
  if constexpr (E == kFunnel) {
    // k0 = 1/σ_v², k1 = ½(d−1): gv = v·k0 + k1 − ½e^{−v}·Σ_{i≥1} x_i², g_i = e^{−v}x_i
    const float v = x[0], e = expf(-v);
    float z2 = 0.f;
#pragma unroll
    for (int i = 1; i < D; ++i) z2 = R::add(z2, R::mul(x[i], x[i]));
    g[0] = R::sub(R::add(R::mul(v, a.k0), a.k1), R::mul(R::mul(0.5f, e), z2));
#pragma unroll
    for (int i = 1; i < D; ++i) g[i] = R::mul(e, x[i]);
  } else if constexpr (E == kBanana) {
    // k0 = a², k1 = b, k2 = 1/a², k3 = 2b: r = x₂ − b(x₁² − a²),
    // g₀ = x₁/a² − 2b·x₁·r, g₁ = r, g_i = x_i
    const float x1 = x[0];
    const float r = R::sub(x[1], R::mul(a.k1, R::sub(R::mul(x1, x1), a.k0)));
    g[0] = R::sub(R::mul(x1, a.k2), R::mul(R::mul(a.k3, x1), r));
    g[1] = r;
#pragma unroll
    for (int i = 2; i < D; ++i) g[i] = x[i];
  } else if constexpr (E == kMog) {
    // g = x·Σ_k c_k − Σ_k c_k μ_k, c_k = r_k/σ_k² from the max-shifted exps
    float lg[kMogMaxComponents], c[kMogMaxComponents];
    const int K = mog_logits<D, R>(x, lg, a);
    const float* cst = a.params + K * D;
    float m = lg[0];
#pragma unroll
    for (int k = 1; k < kMogMaxComponents; ++k)
      if (k < K) m = nan_max(m, lg[k]);
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kMogMaxComponents; ++k) {
      if (k >= K) break;
      c[k] = expf(R::sub(lg[k], m));
      tot = k == 0 ? c[0] : R::add(tot, c[k]);
    }
    const float inv_tot = R::div(1.f, tot);
    float sum_c = 0.f;
#pragma unroll
    for (int k = 0; k < kMogMaxComponents; ++k) {
      if (k >= K) break;
      c[k] = R::mul(R::mul(c[k], inv_tot), __ldg(cst + 2 * K + k));
      sum_c = k == 0 ? c[0] : R::add(sum_c, c[k]);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float row = 0.f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kMogMaxComponents; ++k) {
        if (k >= K) break;
        const float mu = __ldg(a.params + k * D + i);
        if (mu != 0.f) {
          const float t = R::mul(c[k], mu);
          row = any ? R::add(row, t) : t;
          any = true;
        }
      }
      const float gi = R::mul(x[i], sum_c);
      g[i] = any ? R::sub(gi, row) : gi;
    }
  } else if constexpr (E == kEightSchoolsCentered) {
    // k0 = 1/m₀², k1 = 1/s₀², k2 = K; p = y, q = 1/σ²; dth_j = θ_j − μ
    const float mu = x[0], l = x[1], e2 = expf(R::mul(-2.f, l));
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 2; i < D; ++i) {
      const float dth = R::sub(x[i], mu);
      s1 = R::add(s1, dth);
      s2 = R::add(s2, R::mul(dth, dth));
      g[i] = R::add(R::mul(e2, dth), R::mul(R::sub(x[i], P.p[i]), P.q[i]));
    }
    g[0] = R::sub(R::mul(mu, a.k0), R::mul(e2, s1));
    g[1] = R::sub(R::add(R::mul(l, a.k1), a.k2), R::mul(e2, s2));
  } else {  // kEightSchoolsNoncentered: θ_j = μ + e^ℓ z_j, ri_j = (θ_j − y_j)/σ_j²
    const float mu = x[0], l = x[1], e = expf(l);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 2; i < D; ++i) {
      const float ri = R::mul(R::sub(R::add(mu, R::mul(e, x[i])), P.p[i]), P.q[i]);
      s1 = R::add(s1, ri);
      s2 = R::add(s2, R::mul(x[i], ri));
      g[i] = R::add(x[i], R::mul(e, ri));
    }
    g[0] = R::add(R::mul(mu, a.k0), s1);
    g[1] = R::add(R::mul(l, a.k1), R::mul(e, s2));
  }
}

// U(x), in the plain spec's expressions and order
template <int E, int D, class R = Fused>
__device__ __forceinline__ float u_sum(const float (&x)[D], const Params<E, D>& P,
                                       const Args& a) {
  if constexpr (E == kRoughWell || E == kGaussian) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float xx = R::mul(x[i], x[i]);
      s = R::add(s, E == kRoughWell
                        ? R::add(R::mul(xx, a.k3), R::mul(a.k4, cosf(R::mul(x[i], a.k1))))
                        : R::mul(xx, P.p[i]));
    }
    return E == kRoughWell ? s : R::mul(0.5f, s);
  } else if constexpr (E == kFunnel) {
    const float v = x[0];
    float z2 = 0.f;
#pragma unroll
    for (int i = 1; i < D; ++i) z2 = R::add(z2, R::mul(x[i], x[i]));
    return R::add(R::add(R::mul(R::mul(R::mul(0.5f, v), v), a.k0), R::mul(a.k1, v)),
                  R::mul(R::mul(0.5f, expf(-v)), z2));
  } else if constexpr (E == kBanana) {
    const float x1 = x[0];
    const float r = R::sub(x[1], R::mul(a.k1, R::sub(R::mul(x1, x1), a.k0)));
    float tail = 0.f;
#pragma unroll
    for (int i = 2; i < D; ++i) tail = R::add(tail, R::mul(x[i], x[i]));
    return R::add(R::add(R::mul(R::mul(R::mul(0.5f, x1), x1), a.k2), R::mul(R::mul(0.5f, r), r)),
                  R::mul(0.5f, tail));
  } else if constexpr (E == kMog) {
    // −(m + log Σ_k e^{lg_k − m})
    float lg[kMogMaxComponents];
    const int K = mog_logits<D, R>(x, lg, a);
    float m = lg[0];
#pragma unroll
    for (int k = 1; k < kMogMaxComponents; ++k)
      if (k < K) m = nan_max(m, lg[k]);
    float tot = expf(R::sub(lg[0], m));
#pragma unroll
    for (int k = 1; k < kMogMaxComponents; ++k)
      if (k < K) tot = R::add(tot, expf(R::sub(lg[k], m)));
    return -R::add(m, logf(tot));
  } else {  // eight schools
    const float mu = x[0], l = x[1];
    const float prior = R::add(R::mul(R::mul(R::mul(0.5f, mu), mu), a.k0),
                               R::mul(R::mul(R::mul(0.5f, l), l), a.k1));
    float s2 = 0.f, s3 = 0.f;
    if constexpr (E == kEightSchoolsCentered) {
#pragma unroll
      for (int i = 2; i < D; ++i) {
        const float dth = R::sub(x[i], mu), r = R::sub(x[i], P.p[i]);
        s2 = R::add(s2, R::mul(dth, dth));
        s3 = R::add(s3, R::mul(R::mul(r, r), P.q[i]));
      }
      return R::add(R::add(R::add(prior, R::mul(a.k2, l)),
                           R::mul(R::mul(0.5f, expf(R::mul(-2.f, l))), s2)),
                    R::mul(0.5f, s3));
    } else {
      const float e = expf(l);
#pragma unroll
      for (int i = 2; i < D; ++i) {
        const float r = R::sub(R::add(mu, R::mul(e, x[i])), P.p[i]);
        s2 = R::add(s2, R::mul(x[i], x[i]));
        s3 = R::add(s3, R::mul(R::mul(r, r), P.q[i]));
      }
      return R::add(R::add(prior, R::mul(0.5f, s2)), R::mul(0.5f, s3));
    }
  }
}

// ½ Σ (v·v)·M^-1, summed over dims in order
template <int D, class R = Fused>
__device__ __forceinline__ float halfsq(const float (&v)[D], const float* mass) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) s = R::add(s, mass_mul<R>(R::mul(v[i], v[i]), mass, i));
  return R::mul(0.5f, s);
}

// One kick-drift-force-kick stage on dim i of a separable energy: v −=
// c_open·g (if OPEN), x += c_drift·M^-1·v, g = du(x), v −= c_close·g.
template <int E, bool OPEN>
__device__ __forceinline__ void stage1(float& x, float& v, float& g, float p, float im,
                                       float c_open, float c_drift, float c_close,
                                       const Args& a) {
  const float vh = OPEN ? v - c_open * g : v;
  x = x + c_drift * (im * vh);
  g = du<E>(x, p, a);
  v = vh - c_close * g;
}

// The same stage on the whole state: the kick and the drift of every dim,
// g = ∇U(x), the closing kick of every dim (separable energies: dim by dim).
// The leapfrog step is stage<true>(eps/2, eps, eps/2); the two-stage step
// is stage<true>(b eps, eps/2, (1-2b) eps) then stage<false>(-, eps/2, b eps).
template <int E, int D, bool OPEN>
__device__ __forceinline__ void stage(float (&x)[D], float (&v)[D], float (&g)[D],
                                      const Params<E, D>& P, const float* mass, float c_open,
                                      float c_drift, float c_close, const Args& a) {
  if constexpr (kSeparable<E>) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      stage1<E, OPEN>(x[i], v[i], g[i], P.p[i], inv_mass(mass, i), c_open, c_drift, c_close, a);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (OPEN) v[i] = v[i] - c_open * g[i];
      x[i] = x[i] + c_drift * (inv_mass(mass, i) * v[i]);
    }
    grad<E, D>(x, g, P, a);
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = v[i] - c_close * g[i];
  }
}

// M integrator steps of one trajectory
template <int D, int E>
__device__ __forceinline__ void integrate(float (&x)[D], float (&v)[D], float (&g)[D],
                                          const Params<E, D>& P, const Args& a,
                                          const float* mass, bool two_stage) {
  const float eps = a.eps, he = 0.5f * a.eps;
  if (two_stage) {
    const float cb = kTwoStageB * eps, cm = kTwoStageMid * eps;
    for (int k = 0; k < a.m; ++k) {
      if constexpr (kSeparable<E>) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float im = inv_mass(mass, i);
          stage1<E, true>(x[i], v[i], g[i], P.p[i], im, cb, he, cm, a);
          stage1<E, false>(x[i], v[i], g[i], P.p[i], im, 0.f, he, cb, a);
        }
      } else {
        stage<E, D, true>(x, v, g, P, mass, cb, he, cm, a);
        stage<E, D, false>(x, v, g, P, mass, 0.f, he, cb, a);
      }
    }
  } else {
    for (int k = 0; k < a.m; ++k) stage<E, D, true>(x, v, g, P, mass, he, eps, he, a);
  }
}

// D Box-Muller normals (cosine branch) times sqrt(M): dim i from words i and
// D+i of the 2D words in slots slot0.. of counter (chain, t, slot, tag). z[i]
// holds sqrt(-2 ln u1) until word D+i arrives, so no buffer of uniforms is
// needed.
template <int D>
__device__ __forceinline__ void draw_normals(float (&z)[D], const Args& a, uint32_t c,
                                             uint32_t t, uint32_t slot0, uint32_t tag,
                                             uint2 key) {
  constexpr int kBlocks = (2 * D + 3) / 4;
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (!a.fixed_uniform) r = philox4x32_10(make_uint4(c, t, slot0 + b, tag), key);
    const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * b + j;
      const float u = a.fixed_uniform ? 0x1p-25f : philox_uniform(rw[j]);
      if (k < D) z[k] = sqrtf(-2.0f * logf(u));
      else if (k < 2 * D) z[k - D] = z[k - D] * cosf(kTwoPi * u);
    }
  }
  if (a.mass)
#pragma unroll
    for (int i = 0; i < D; ++i) z[i] = z[i] * sqrt_mass<D>(a.mass, i);
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

// BR=false is the fast path without a mass and with the leapfrog, compiled
// with no branch code at all (as the TPU kernel compiles inv_mass=None
// statically); BR=true takes both branches from the arguments.
template <int D, int E, bool EMIT, bool BR>
__global__ void __launch_bounds__(kThreads) mjhmc_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const size_t n = a.n;
  const float* mass = BR ? a.mass : nullptr;
  const bool two_stage = BR && a.two_stage;

  const Params<E, D> P(a);
  float x[D], v[D], g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
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

  const int m_cost = two_stage ? 2 * a.m : a.m;  // evals per trajectory half
  for (int t = 0; t < a.num_iters; ++t) {
    const float h_cur = u + halfsq<D>(v, mass);

    // forward from (x, v) and backward from (x, -v), M steps each; the
    // leapfrog takes a step of each in turn (separable energies: per dim)
    float xf[D], vf[D], gf[D], xb[D], vb[D], gb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      xf[i] = xb[i] = x[i];
      vf[i] = v[i];
      vb[i] = -v[i];
      gf[i] = gb[i] = g[i];
    }
    if (two_stage) {
      integrate<D, E>(xf, vf, gf, P, a, mass, true);
      integrate<D, E>(xb, vb, gb, P, a, mass, true);
    } else {
      for (int k = 0; k < a.m; ++k) {
        if constexpr (kSeparable<E>) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const float im = inv_mass(mass, i);
            stage1<E, true>(xf[i], vf[i], gf[i], P.p[i], im, he, eps, he, a);
            stage1<E, true>(xb[i], vb[i], gb[i], P.p[i], im, he, eps, he, a);
          }
        } else {
          stage<E, D, true>(xf, vf, gf, P, mass, he, eps, he, a);
          stage<E, D, true>(xb, vb, gb, P, mass, he, eps, he, a);
        }
      }
    }
    const float uf = u_sum<E, D>(xf, P, a);
    const float h_l = uf + halfsq<D>(vf, mass);
    const float h_b = valid > 0.5f ? h_back : u_sum<E, D>(xb, P, a) + halfsq<D>(vb, mass);

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
    evals += valid > 0.5f ? m_cost : 2 * m_cost;
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
      // refresh v ~ N(0, M) by Box-Muller's cosine branch: dim i takes
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
        v[i] = sqrtf(-2.0f * logf(un[i])) * cosf(kTwoPi * un[D + i]) * sqrt_mass<D>(mass, i);
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

// ---------------------------------------------------------------------------
// Fused NUTS engine: the step body _make_step_nuts (pallas_mjhmc.py:1011-1210)
//
// Per chain and iteration: a fresh momentum v0 ~ N(0, M) by Box-Muller and
// h0 = u + ½v0ᵀM⁻¹v0; then up to max_depth doubling rounds (the num_leapfrog
// slot, m), each in a direction picked by one uniform (< 0.5 goes right),
// integrating outward from the chosen endpoint (the minus end's momentum
// negated). Every leaf is one leapfrog step; a leaf diverges when |h| >=
// 1e30, h is NaN or ΔH > 1000; the proposal inside the subtree is sampled
// progressively (multinomial, NEG_INF a finite -1e30, logaddexp as
// jnp.logaddexp computes it); the binary-counter U-turn stack stores the
// leaf at i % 2^m == 0 and checks at (i+1) % 2^m == 0. At the end of a
// completed round the subtree is merged with the biased rule lu < log_w_sub
// − log_w_tree, the endpoints extended and the global U-turn tested. The
// outputs are (x_prop, v0, g_prop, u_prop) with h_back and valid passed
// through; the emission and the accumulators take the post-transition x
// with weight 1, and evals counts the integrated leaves exactly.
//
// Design: one thread per chain, every tree array in registers (the U-turn
// stack rows are indexed by unrolled constants); at D=50 they spill. On
// the TPU a chain waits until every chain of its lane block is done; here
// a thread leaves its own loops when its chain is done, which changes no
// chain's law, but the warp runs until its deepest tree is finished (warp
// divergence is the GPU's form of the lane-block stall).
//
// Random numbers: Philox4x32-10 keyed (seed, 0), with counters tagged 1
// (momentum), 2 (round: direction, merge) and 3 (leaf, by tree position),
// as philox.cuh lays out. The arithmetic takes the Rn policy and sums over
// dims one after another, as the plain PyTorch version does, so that every
// rounding is the plain version's and the tree decisions agree with it.
namespace nuts {

constexpr int kMaxDepth = 10;
constexpr float kDivThreshold = 1000.0f;

// ((a − b)·c)·M^-1 summed over dims
template <int D>
__device__ __forceinline__ float diff_dot(const float (&a)[D], const float (&b)[D],
                                          const float (&c)[D], const float* mass) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i)
    s = Rn::add(s, mass_mul<Rn>(Rn::mul(Rn::sub(a[i], b[i]), c[i]), mass, i));
  return s;
}

// jnp.logaddexp: max + log1p(exp(−|Δ|)), or a + b where Δ is NaN
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = Rn::sub(a, b);
  if (d != d) return Rn::add(a, b);
  return Rn::add(a > b ? a : b, log1pf(expf(-fabsf(d))));
}

__device__ __forceinline__ float uniform(const Args& a, uint32_t word) {
  return a.fixed_uniform ? 0x1p-25f : philox_uniform(word);
}

template <int D>
__device__ __forceinline__ void copy(float (&dst)[D], const float (&src)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) dst[i] = src[i];
}

// MASS=false compiles no inverse mass (the fast path); MASS=true reads it
template <int D, int E, bool EMIT, bool MASS>
__global__ void __launch_bounds__(kThreads) nuts_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const size_t n = a.n;
  const int max_depth = a.m;
  const float* mass = MASS ? a.mass : nullptr;

  const Params<E, D> P(a);
  float x[D], v0[D], g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = a.x[i * n + c];
    v0[i] = a.v[i * n + c];
    g[i] = a.g[i * n + c];
  }
  float u = a.u[c];

  float w = 0.f, wc = 0.f;
  float wx[D], wxc[D], wx2[D], wx2c[D];
#pragma unroll
  for (int i = 0; i < D; ++i) wx[i] = wxc[i] = wx2[i] = wx2c[i] = 0.f;
  int evals = 0;

  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  for (int t = 0; t < a.num_iters; ++t) {
    // fresh momentum: dim i from words i and D+i of the momentum slots
    {
      constexpr int kBlocks = (2 * D + 3) / 4;
      float un[2 * D];
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        const uint4 r = philox4x32_10(make_uint4(c, t, b, kTagNutsMomentum), key);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * b + j < 2 * D) un[4 * b + j] = uniform(a, word_of(r, j));
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        v0[i] = Rn::mul(sqrtf(Rn::mul(-2.0f, logf(un[i]))), cosf(Rn::mul(kTwoPi, un[D + i])));
        if (MASS) v0[i] = Rn::mul(v0[i], sqrt_mass<D>(mass, i));
      }
    }
    const float h0 = Rn::add(u, halfsq<D, Rn>(v0, mass));

    // tree endpoints (trajectory frame) and the proposal
    float xm[D], vm[D], gm[D], xp[D], vp[D], gp[D];
    copy<D>(xm, x), copy<D>(vm, v0), copy<D>(gm, g);
    copy<D>(xp, x), copy<D>(vp, v0), copy<D>(gp, g);
    float log_w_tree = 0.f;
    int nl = 0;
    bool done = false;

    for (int jj = 0; jj < max_depth && !done; ++jj) {
      const uint4 rr = philox4x32_10(make_uint4(c, t, jj, kTagNutsRound), key);
      const bool right = uniform(a, rr.x) < 0.5f;
      // integration frame: outward from the chosen endpoint
      float xc[D], vc[D], gc[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        xc[i] = right ? xp[i] : xm[i];
        vc[i] = right ? vp[i] : -vm[i];
        gc[i] = right ? gp[i] : gm[i];
      }
      float sx[kMaxDepth - 1][D], sv[kMaxDepth - 1][D];
      float xs[D], gs[D];
      copy<D>(xs, xc), copy<D>(gs, gc);
      float log_w_sub = kNegInf, us = 0.f;
      bool stop = false;
      const int leaves = 1 << jj;
      const uint32_t k0 = leaves - 1;  // tree position of the round's first leaf
      uint4 bits;
      for (int i = 0; i < leaves && !stop; ++i) {
        if constexpr (kSeparable<E>) {  // the leaf's leapfrog step, dim by dim
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float vh = Rn::sub(vc[d], Rn::mul(he, gc[d]));
            xc[d] = Rn::add(xc[d], Rn::mul(eps, mass_mul<Rn>(vh, mass, d)));
            gc[d] = du<E, Rn>(xc[d], P.p[d], a);
            vc[d] = Rn::sub(vh, Rn::mul(he, gc[d]));
          }
        } else {  // or as a vector step
          float vh[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            vh[d] = Rn::sub(vc[d], Rn::mul(he, gc[d]));
            xc[d] = Rn::add(xc[d], Rn::mul(eps, mass_mul<Rn>(vh[d], mass, d)));
          }
          grad<E, D, Rn>(xc, gc, P, a);
#pragma unroll
          for (int d = 0; d < D; ++d) vc[d] = Rn::sub(vh[d], Rn::mul(he, gc[d]));
        }
        const float ul = u_sum<E, D, Rn>(xc, P, a);
        ++nl;
        const float h = Rn::add(ul, halfsq<D, Rn>(vc, mass));
        const float dh = Rn::sub(h, h0);
        const bool div = fabsf(h) >= 1e30f || h != h || dh > kDivThreshold;

        // progressive multinomial sampling inside the subtree
        const float lw_leaf = div ? kNegInf : -dh;
        const float lw_new = logaddexp(log_w_sub, lw_leaf);
        const uint32_t k = k0 + i;
        if (i == 0 || (k & 3u) == 0)
          bits = philox4x32_10(make_uint4(c, t, k >> 2, kTagNutsLeaf), key);
        const float lu = logf(uniform(a, word_of(bits, k)));
        if (!div && lu < Rn::sub(lw_leaf, lw_new)) {
          copy<D>(xs, xc), copy<D>(gs, gc);
          us = ul;
        }
        log_w_sub = lw_new;

        // binary-counter U-turn stack; rows above the round's depth never
        // complete a span inside it, so they are skipped
        bool turning = false;
#pragma unroll
        for (int mm = 1; mm < kMaxDepth; ++mm) {
          if (mm > jj) break;
          const int mask = (1 << mm) - 1;
          if ((i & mask) == 0) copy<D>(sx[mm - 1], xc), copy<D>(sv[mm - 1], vc);
          if (((i + 1) & mask) == 0)
            turning = turning || diff_dot<D>(xc, sx[mm - 1], sv[mm - 1], mass) < 0.f ||
                      diff_dot<D>(xc, sx[mm - 1], vc, mass) < 0.f;
        }
        stop = div || turning;
      }

      if (stop) {
        done = true;
        break;
      }
      // biased progressive merge of the completed subtree
      if (logf(uniform(a, rr.y)) < Rn::sub(log_w_sub, log_w_tree)) {
        copy<D>(x, xs), copy<D>(g, gs);
        u = us;
      }
      log_w_tree = logaddexp(log_w_tree, log_w_sub);
      // extend the tree (back to the trajectory frame), then the U-turn
      // test between its endpoints
      if (right) {
        copy<D>(xp, xc), copy<D>(vp, vc), copy<D>(gp, gc);
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          xm[i] = xc[i];
          vm[i] = -vc[i];
          gm[i] = gc[i];
        }
      }
      done = diff_dot<D>(xp, xm, vm, mass) < 0.f || diff_dot<D>(xp, xm, vp, mass) < 0.f;
    }

    // the post-transition x, weight 1
    evals += nl;
    kadd(w, wc, 1.f);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      kadd(wx[i], wxc[i], x[i]);
      kadd(wx2[i], wx2c[i], Rn::mul(x[i], x[i]));
    }
    if (EMIT && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
#pragma unroll
      for (int i = 0; i < D; ++i) a.xs[(e * D + i) * n + c] = x[i];
      a.ws[e * n + c] = 1.f;
      a.es[e * n + c] = evals;
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    a.xo[i * n + c] = x[i];
    a.vo[i * n + c] = v0[i];
    a.go[i * n + c] = g[i];
    a.wx[i * n + c] = wx[i];
    a.wx2[i * n + c] = wx2[i];
  }
  a.uo[c] = u;
  a.hbo[c] = a.h_back[c];
  a.valido[c] = a.valid[c];
  a.w[c] = w;
  a.evals[c] = evals;
}

}  // namespace nuts

// ---------------------------------------------------------------------------
// Fused control HMC and MALT engines: the step bodies _make_step_control
// (pallas_mjhmc.py:863-935) and _make_step_malt (:938-1008), the
// engine-class baselines of the paper's comparison, with the same energies,
// D, inverse mass and stream form. Both emit the post-transition x with
// weight 1; h_back and valid pass through.
//
// Control: v <- sqrt(1-beta) v + sqrt(beta) xi (xi ~ N(0, M), tag 4), H0 =
// u + ½vM^-1v from the carried u, an M-step leapfrog or two-stage
// trajectory from the carried gradient, accept with p = min(1, exp(H0 -
// H_L)) (non-finite H_L rejects), momentum flip on reject; M evals (2M
// two-stage).
//
// MALT (beta carries the friction gamma): v0 ~ N(0, M) (tag 5), then M
// OBABO steps — O: v <- eta v + sig N(0, M) (tag 6), eta = exp(-gamma
// eps/2), sig = sqrt(max(0, 1 - eta²)); BAB: one leapfrog step whose energy
// error enters Delta; O — and one accept with p = min(1, exp(-Delta)); on
// reject v = -v0. Leapfrog only, M evals.
//
// Design: one thread per chain, as mjhmc_kernel; one trajectory instead of
// two, so half the FP32 and SFU work of an MJHMC iteration for control.
// What bounds it: control, like MJHMC, the dependent sinf chain per step;
// MALT draws (2M + 1)·D normals per iteration, each two Philox words, a
// logf, a sqrtf and a cosf — at D=2 and M=10 that is 42 normals beside 20
// gradient evaluations, so Philox and the SFU, not the energy, set its
// time. Nothing is done about it yet: the counter-keyed draws are what
// lets the plain version reproduce every word.
namespace hmc {

// the Metropolis uniform: word 2D of the family's counter
template <int D>
__device__ __forceinline__ float mh_uniform(const Args& a, uint32_t c, uint32_t t,
                                            uint32_t tag, uint2 key) {
  return a.fixed_uniform ? 0x1p-25f : philox_uniform(philox_word(c, t, 2 * D, key, tag));
}

// min(1, exp(log_ratio)) with a NaN kept NaN (as jnp.minimum keeps it), so
// that it rejects
__device__ __forceinline__ float accept_prob(float log_ratio, bool ok) {
  const float lp = log_ratio > 0.f ? 0.f : log_ratio;
  return ok ? expf(lp) : 0.f;
}

template <int D, int E>
__global__ void __launch_bounds__(kThreads) control_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const size_t n = a.n;

  const Params<E, D> P(a);
  float x[D], v[D], g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = a.x[i * n + c];
    v[i] = a.v[i * n + c];
    g[i] = a.g[i * n + c];
  }
  float u = a.u[c];

  float w = 0.f, wc = 0.f;
  float wx[D], wxc[D], wx2[D], wx2c[D];
#pragma unroll
  for (int i = 0; i < D; ++i) wx[i] = wxc[i] = wx2[i] = wx2c[i] = 0.f;
  int evals = 0;

  const uint2 key = make_uint2(a.seed, 0u);
  const float sb = sqrtf(a.beta), sb1 = sqrtf(fmaxf(1.f - a.beta, 0.f));
  const int m_cost = a.two_stage ? 2 * a.m : a.m;

  for (int t = 0; t < a.num_iters; ++t) {
    // partial corruption with xi ~ N(0, M)
    float xi[D];
    draw_normals<D>(xi, a, c, t, 0u, kTagControl, key);
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = sb1 * v[i] + sb * xi[i];
    const float h0 = u + halfsq<D>(v, a.mass);

    float xf[D], vf[D], gf[D];
#pragma unroll
    for (int i = 0; i < D; ++i) xf[i] = x[i], vf[i] = v[i], gf[i] = g[i];
    integrate<D, E>(xf, vf, gf, P, a, a.mass, a.two_stage);
    const float uf = u_sum<E, D>(xf, P, a);
    const float h_l = uf + halfsq<D>(vf, a.mass);

    const bool ok = fabsf(h_l) < 1e30f && h_l == h_l;  // divergence rejects
    const bool acc = mh_uniform<D>(a, c, t, kTagControl, key) < accept_prob(h0 - h_l, ok);
    if (acc) {
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = xf[i], v[i] = vf[i], g[i] = gf[i];
      u = uf;
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = -v[i];  // flip on reject
    }

    // the post-transition x, weight 1
    evals += m_cost;
    kadd(w, wc, 1.f);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      kadd(wx[i], wxc[i], x[i]);
      kadd(wx2[i], wx2c[i], x[i] * x[i]);
    }
    if (a.xs && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
#pragma unroll
      for (int i = 0; i < D; ++i) a.xs[(e * D + i) * n + c] = x[i];
      a.ws[e * n + c] = 1.f;
      a.es[e * n + c] = evals;
    }
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
  a.hbo[c] = a.h_back[c];
  a.valido[c] = a.valid[c];
  a.w[c] = w;
  a.evals[c] = evals;
}

template <int D, int E>
__global__ void __launch_bounds__(kThreads) malt_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const size_t n = a.n;

  // v holds the fresh momentum v0 during an iteration and the kept
  // momentum (vl on accept, -v0 on reject) after it
  const Params<E, D> P(a);
  float x[D], v[D], g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = a.x[i * n + c];
    v[i] = a.v[i * n + c];
    g[i] = a.g[i * n + c];
  }
  float u = a.u[c];

  float w = 0.f, wc = 0.f;
  float wx[D], wxc[D], wx2[D], wx2c[D];
#pragma unroll
  for (int i = 0; i < D; ++i) wx[i] = wxc[i] = wx2[i] = wx2c[i] = 0.f;
  int evals = 0;

  const uint2 key = make_uint2(a.seed, 0u);
  const float eps = a.eps, he = 0.5f * a.eps;
  // rounded one operation at a time, as the plain version forms them
  const float eta = expf(__fmul_rn(__fmul_rn(-a.beta, eps), 0.5f));
  const float sig = sqrtf(fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(eta, eta))));
  constexpr uint32_t kBlocks = (2 * D + 3) / 4;  // slots of one O-step's noise

  for (int t = 0; t < a.num_iters; ++t) {
    draw_normals<D>(v, a, c, t, 0u, kTagMaltRefresh, key);  // v0 ~ N(0, M)
    float xl[D], vl[D], gl[D], z[D];
#pragma unroll
    for (int i = 0; i < D; ++i) xl[i] = x[i], vl[i] = v[i], gl[i] = g[i];
    float ul = u, delta = 0.f;
    for (int k = 0; k < a.m; ++k) {
      draw_normals<D>(z, a, c, t, (2 * k) * kBlocks, kTagMaltNoise, key);  // O
#pragma unroll
      for (int i = 0; i < D; ++i) vl[i] = eta * vl[i] + sig * z[i];
      const float h_in = ul + halfsq<D>(vl, a.mass);
      stage<E, D, true>(xl, vl, gl, P, a.mass, he, eps, he, a);  // BAB
      ul = u_sum<E, D>(xl, P, a);
      delta = delta + (ul + halfsq<D>(vl, a.mass) - h_in);
      draw_normals<D>(z, a, c, t, (2 * k + 1) * kBlocks, kTagMaltNoise, key);  // O
#pragma unroll
      for (int i = 0; i < D; ++i) vl[i] = eta * vl[i] + sig * z[i];
    }

    const bool ok = fabsf(delta) < 1e30f && delta == delta;  // divergence rejects
    const bool acc = mh_uniform<D>(a, c, t, kTagMaltRefresh, key) < accept_prob(-delta, ok);
    if (acc) {
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = xl[i], v[i] = vl[i], g[i] = gl[i];
      u = ul;
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = -v[i];
    }

    evals += a.m;
    kadd(w, wc, 1.f);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      kadd(wx[i], wxc[i], x[i]);
      kadd(wx2[i], wx2c[i], x[i] * x[i]);
    }
    if (a.xs && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
#pragma unroll
      for (int i = 0; i < D; ++i) a.xs[(e * D + i) * n + c] = x[i];
      a.ws[e * n + c] = 1.f;
      a.es[e * n + c] = evals;
    }
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
  a.hbo[c] = a.h_back[c];
  a.valido[c] = a.valid[c];
  a.w[c] = w;
  a.evals[c] = evals;
}

}  // namespace hmc

enum Variant { kMjhmc = 0, kNuts = 1, kControl = 2, kMalt = 3 };

template <int V, int D, int E, bool BR>
void (*kernel_of(bool emit))(Args) {
  if constexpr (V == kMjhmc)
    return emit ? mjhmc_kernel<D, E, true, BR> : mjhmc_kernel<D, E, false, BR>;
  else if constexpr (V == kNuts)
    return emit ? nuts::nuts_kernel<D, E, true, BR> : nuts::nuts_kernel<D, E, false, BR>;
  // control and MALT test emission at run time (a.xs != nullptr): one
  // instance per (D, energy) serves the run and the stream
  else if constexpr (V == kControl) return hmc::control_kernel<D, E>;
  else return hmc::malt_kernel<D, E>;
}

// Launch the instance of step body V at D dims on energy E. BR (the
// branches compiled in: a mass or the two-stage integrator for MJHMC, a
// mass for NUTS) splits the MJHMC and NUTS instances; control and MALT have
// the BR=true instance only.
template <int V, int D, int E, bool BR>
cudaError_t launch_instance(const Args& a, bool emit, cudaStream_t s) {
  kernel_of<V, D, E, BR>(emit)<<<(a.n + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// The D=50 and zoo instances, each compiled in the source named beside it
// (an instance declared here and compiled nowhere fails the build's link)
using Launch = cudaError_t(const Args&, bool, cudaStream_t);
// mjhmc_engine_d50.cu
extern template Launch launch_instance<kMjhmc, 50, kRoughWell, false>;
extern template Launch launch_instance<kMjhmc, 50, kGaussian, false>;
// mjhmc_engine_d50_branches.cu
extern template Launch launch_instance<kMjhmc, 50, kRoughWell, true>;
extern template Launch launch_instance<kMjhmc, 50, kGaussian, true>;
// nuts_engine_d50_rough_well.cu
extern template Launch launch_instance<kNuts, 50, kRoughWell, false>;
// nuts_engine_d50_rough_well_mass.cu
extern template Launch launch_instance<kNuts, 50, kRoughWell, true>;
// nuts_engine_d50_gaussian.cu
extern template Launch launch_instance<kNuts, 50, kGaussian, false>;
extern template Launch launch_instance<kNuts, 50, kGaussian, true>;
// hmc_engine_d50.cu
extern template Launch launch_instance<kControl, 50, kRoughWell, true>;
extern template Launch launch_instance<kControl, 50, kGaussian, true>;
extern template Launch launch_instance<kMalt, 50, kRoughWell, true>;
extern template Launch launch_instance<kMalt, 50, kGaussian, true>;
// zoo_engine_funnel.cu (the funnel preset's D)
extern template Launch launch_instance<kMjhmc, 10, kFunnel, false>;
extern template Launch launch_instance<kMjhmc, 10, kFunnel, true>;
extern template Launch launch_instance<kControl, 10, kFunnel, true>;
extern template Launch launch_instance<kMalt, 10, kFunnel, true>;
// zoo_nuts_funnel.cu
extern template Launch launch_instance<kNuts, 10, kFunnel, false>;
extern template Launch launch_instance<kNuts, 10, kFunnel, true>;
// zoo_engine_banana_mog.cu (the banana and mog presets' D)
extern template Launch launch_instance<kMjhmc, 2, kBanana, false>;
extern template Launch launch_instance<kMjhmc, 2, kBanana, true>;
extern template Launch launch_instance<kNuts, 2, kBanana, false>;
extern template Launch launch_instance<kNuts, 2, kBanana, true>;
extern template Launch launch_instance<kControl, 2, kBanana, true>;
extern template Launch launch_instance<kMalt, 2, kBanana, true>;
extern template Launch launch_instance<kMjhmc, 1, kMog, false>;
extern template Launch launch_instance<kMjhmc, 1, kMog, true>;
extern template Launch launch_instance<kNuts, 1, kMog, false>;
extern template Launch launch_instance<kNuts, 1, kMog, true>;
extern template Launch launch_instance<kControl, 1, kMog, true>;
extern template Launch launch_instance<kMalt, 1, kMog, true>;
// zoo_engine_eight_schools.cu (the eight_schools preset's D)
extern template Launch launch_instance<kMjhmc, 10, kEightSchoolsCentered, false>;
extern template Launch launch_instance<kMjhmc, 10, kEightSchoolsCentered, true>;
extern template Launch launch_instance<kControl, 10, kEightSchoolsCentered, true>;
extern template Launch launch_instance<kMalt, 10, kEightSchoolsCentered, true>;
extern template Launch launch_instance<kMjhmc, 10, kEightSchoolsNoncentered, false>;
extern template Launch launch_instance<kMjhmc, 10, kEightSchoolsNoncentered, true>;
extern template Launch launch_instance<kControl, 10, kEightSchoolsNoncentered, true>;
extern template Launch launch_instance<kMalt, 10, kEightSchoolsNoncentered, true>;
// zoo_nuts_eight_schools.cu
extern template Launch launch_instance<kNuts, 10, kEightSchoolsCentered, false>;
extern template Launch launch_instance<kNuts, 10, kEightSchoolsCentered, true>;
// zoo_nuts_eight_schools_noncentered.cu
extern template Launch launch_instance<kNuts, 10, kEightSchoolsNoncentered, false>;
extern template Launch launch_instance<kNuts, 10, kEightSchoolsNoncentered, true>;

}  // namespace mjhmc
