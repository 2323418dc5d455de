// Fused MJHMC engine for Hopper (sm_90a): a whole sampling run in one launch.
// This header holds the four step bodies' kernels as templates (MJHMC, NUTS,
// control HMC, MALT: each with its note below); mjhmc_engine.cu
// compiles the D=2 instances and the C entry, and the D=50 and zoo
// instances, which take most of the build, are compiled in sources of their
// own (mjhmc_engine_d50*.cu, nuts_engine_d50_*.cu, hmc_engine_d50.cu,
// zoo_*.cu; the PROF instances in nuts_engine_prof.cu and
// ew_engine_prof*.cu), each by its own nvcc, all at once (ops/_build.py);
// the slowest instances have a source each, so that the build's longest
// nvcc stays short. Those are the presets' D; any other (body, energy, D)
// is compiled at its first use from ondemand/ew_instance.cu, a library of
// its own (ops/_build.py, load_instance).
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
// Design (the MJHMC body, mjhmc_kernel below, as redesigned for the
// H100): a chain runs on a group of lanes of one warp (ew_lanes): one
// thread a chain at D <= 2, its dims over 8 lanes on the rough well and the
// Gaussian at D 50, its forward and backward trajectories on 2 lanes on the
// coupled zoo energies at D 10. The state (x, v, g, u, h_back, valid), the
// trajectories and the Kahan pairs of a lane's dims live in its registers
// for the whole run, so device memory is touched only to load the state,
// store the results and, in the stream, store the emissions. Loads and
// stores use the (d, n) layout, so neighbouring threads touch neighbouring
// addresses. Blocks are sized to the chain count (ew_threads_for), so that
// the zoo's 1,024-2,048 chains reach every SM. The zoo energies couple their
// dims, so their leapfrog step is a vector step: the kick and the drift of
// every dim, one gradient of the whole x (grad_u below), then the closing kick
// of every dim. The separable rough well and Gaussian keep the per-dim step
// (kSeparable below); each dim sees the same operations in the same order in
// either form, so only the speed differs.
//
// What bounds it: latency, not the card's rates. A chain is a dependent
// chain of steps (one precise sinf a dim and step on the rough well); at D 2
// 10,000 chains give each of the 132 SMs two or three warps and 102,400 run
// at about half the measured precise-sinf ceiling (PERF.md §5). The
// parent's two other bounds are gone: a D 50 lane holds 7 dims (one thread
// a chain spilled 3-4 KB), and a refresh on a group draws each lane's share
// of the words at once (mjhmc_word_runs), where one thread drew D normals
// while its warp's other lanes waited (half the cycles at D 10 and 50).
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

#include "phase_clock.cuh"
#include "philox.cuh"

// Every loop over a lane's dims (or their Philox blocks) unrolls fully, so
// that the lane's arrays live in registers. An on-demand instance at a wide
// D defines this to leave loops over more dims rolled
// (ondemand/ew_instance.cu), their arrays in local memory, which keeps its
// nvcc short
#ifndef MJHMC_UNROLL_DIMS
#define MJHMC_UNROLL_DIMS(K) _Pragma("unroll")
#endif

namespace mjhmc {

constexpr int kThreads = 64;
// SM sub-partitions (warp schedulers) an SM has
constexpr int kSmSubPartitions = 4;
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
// step bodies (the variant argument of the C entry)
enum Variant { kMjhmc = 0, kNuts = 1, kControl = 2, kMalt = 3 };
// most components of a mixture (MogSpec): 8 in the library; an on-demand
// instance (ondemand/ew_instance.cu) is compiled with its mixture's count
// where that is more (ops/_build.py, load_instance)
#ifndef MJHMC_MOG_MAX_COMPONENTS
#define MJHMC_MOG_MAX_COMPONENTS 8
#endif
constexpr int kMogMaxComponents = MJHMC_MOG_MAX_COMPONENTS;

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
  // NUTS at D > nuts::kOnChipDims: the chains' tree rows, (nuts::rows(m), d, n)
  float* scratch;
  // NUTS PROF instances: per chain, the cycles of each phase and the counters
  unsigned long long* prof;
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

// The lanes of one chain: G consecutive lanes of a warp (G a power of two),
// lane `rank` of them owning dims rank·K .. rank·K + K − 1 of the chain's D
// (those < D; K = ceil(D / G)). A per-chain sum adds the owners' partials in
// rank order, so every lane holds the same bits; a coupling scalar comes
// from its owner. Blocks hold whole groups (threads a multiple of G), and a
// group's lanes run every shuffle together. Group<1> is a chain on one lane.
template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "a power of two lanes of a warp");
  unsigned mask = 0xffffffffu;
  int rank = 0;
  __device__ __forceinline__ Group() {
    if constexpr (G > 1) {
      const int lane = threadIdx.x & 31;
      rank = lane & (G - 1);
      if constexpr (G < 32) mask = ((1u << G) - 1u) << (lane - rank);
    }
  }
  __device__ __forceinline__ float sum(float p) const {
    if constexpr (G == 1) {
      return p;
    } else {
      float s = __shfl_sync(mask, p, 0, G);
#pragma unroll
      for (int r = 1; r < G; ++r) s = __fadd_rn(s, __shfl_sync(mask, p, r, G));
      return s;
    }
  }
  __device__ __forceinline__ float from(float v, int owner) const {
    if constexpr (G == 1) return v;
    else return __shfl_sync(mask, v, owner, G);
  }
};

// What a lane loads once for its owned dims i0 .. i0 + K − 1 of the chain's
// D (those < D; the others hold 0 and no work of theirs is kept): the
// Gaussian's precisions or eight schools' y (p), eight schools' 1/σ² (q),
// M^-1 (im) and sqrt(M) (sm), 1 without a mass. A chain on one lane holds
// every dim (K = D, rank 0). The other energies read only the scalars; the
// mixture reads its per-component values from the params vector inside the
// energy (the same address in every thread).
template <int E, int D, int K>
struct Owned {
  static constexpr bool kSchools = E == kEightSchoolsCentered || E == kEightSchoolsNoncentered;
  int i0;
  float p[K], q[K], im[K], sm[K];
  __device__ __forceinline__ Owned(const Args& a, int rank, const float* mass) : i0(rank * K) {
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) {
      const int i = i0 + j;
      const bool o = i < D;
      p[j] = o && (E == kGaussian || kSchools) ? a.params[i] : 0.f;
      q[j] = o && kSchools ? a.params[D + i] : 0.f;
      im[j] = o && mass ? __ldg(mass + i) : 1.f;
      sm[j] = o && mass ? __ldg(mass + D + i) : 1.f;
    }
  }
  __device__ __forceinline__ bool own(int j) const { return i0 + j < D; }
};

// rough well: du = x/s1² − sin(x/s2)·a/s2 and U's term x²/(2 s1²) +
// a·cos(x/s2), with k0=1/s1², k1=1/s2, k2=a/s2, k3=0.5/s1², k4=a
// (RoughWellSpec's forms), sin and cos of x·k1 from sn() and cs()
template <class R = Fused, class S>
__device__ __forceinline__ float rw_du(float x, S sn, const Args& a) {
  return R::sub(R::mul(x, a.k0), R::mul(sn(), a.k2));
}
template <class R = Fused, class C>
__device__ __forceinline__ float rw_u(float x, C cs, const Args& a) {
  return R::add(R::mul(R::mul(x, x), a.k3), R::mul(a.k4, cs()));
}

// ∇U of one dim of a separable energy (rough well; Gaussian: x·p)
template <int E, class R = Fused>
__device__ __forceinline__ float du(float x, float p, const Args& a) {
  if (E == kRoughWell) return rw_du<R>(x, [&] { return sinf(R::mul(x, a.k1)); }, a);
  return R::mul(x, p);
}

// U's term of one dim of a separable energy (rough well; Gaussian: x²p, its
// ½ after the sum)
template <int E, class R = Fused>
__device__ __forceinline__ float u_term(float x, float p, const Args& a) {
  if (E == kRoughWell) return rw_u<R>(x, [&] { return cosf(R::mul(x, a.k1)); }, a);
  return R::mul(R::mul(x, x), p);
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
MJHMC_UNROLL_DIMS(D)
  for (int i = 0; i < D; ++i) x2 = R::add(x2, R::mul(x[i], x[i]));
#pragma unroll
  for (int k = 0; k < kMogMaxComponents; ++k) {
    if (k >= K) break;
    float cross = 0.f;
MJHMC_UNROLL_DIMS(D)
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
// with grad_u below.
template <int E>
constexpr bool kSeparable = E == kRoughWell || E == kGaussian;

// ∇U of the owned dims and U of a coupled energy, in the plain spec's
// expressions and order (ops/cuda_mjhmc.py: FunnelSpec, BananaSpec,
// MogSpec, EightSchoolsSpec; the masked sums there start from rows of
// zeros, here from 0), on a group of lanes (the funnel and eight schools)
// or on one (every energy; K = D). The coupling scalars (the funnel's v,
// eight schools' μ and ℓ) come from their owner; the sums over dims are the
// owners' partials in rank order; U takes the gradient's transcendental
// (e^{-v}, e^{-2ℓ}, e^ℓ, the mixture's logits) and sums, so an energy beside
// a gradient costs a few products. A caller that wants one of the two drops
// the other, and the compiler the work that only it needed.
template <int E, int D, int K, int G, class R = Fused>
__device__ __forceinline__ float grad_u(const float (&x)[K], float (&g)[K],
                                        const Owned<E, D, K>& P, const Group<G>& grp,
                                        const Args& a) {
  static_assert(!kSeparable<E>, "separable energies take du one dim at a time");
  static_assert(G == 1 || E == kFunnel || E == kEightSchoolsCentered ||
                    E == kEightSchoolsNoncentered,
                "the coupled energies that run on a group of lanes");
  auto dim = [&](int i) { return grp.from(x[i % K], i / K); };
  if constexpr (E == kFunnel) {
    // k0 = 1/σ_v², k1 = ½(d−1): gv = v·k0 + k1 − ½e^{−v}·Σ_{i≥1} x_i², g_i = e^{−v}x_i
    const float v = dim(0), e = expf(-v);
    float zp = 0.f;
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j)
      if (P.own(j) && P.i0 + j >= 1) zp = R::add(zp, R::mul(x[j], x[j]));
    const float z2 = grp.sum(zp);
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j)
      g[j] = P.i0 + j == 0 ? R::sub(R::add(R::mul(v, a.k0), a.k1), R::mul(R::mul(0.5f, e), z2))
                           : R::mul(e, x[j]);
    return R::add(R::add(R::mul(R::mul(R::mul(0.5f, v), v), a.k0), R::mul(a.k1, v)),
                  R::mul(R::mul(0.5f, e), z2));
  } else if constexpr (E == kBanana) {
    // k0 = a², k1 = b, k2 = 1/a², k3 = 2b: r = x₂ − b(x₁² − a²),
    // g₀ = x₁/a² − 2b·x₁·r, g₁ = r, g_i = x_i
    const float x1 = x[0];
    const float r = R::sub(x[1], R::mul(a.k1, R::sub(R::mul(x1, x1), a.k0)));
    g[0] = R::sub(R::mul(x1, a.k2), R::mul(R::mul(a.k3, x1), r));
    g[1] = r;
    float tail = 0.f;
MJHMC_UNROLL_DIMS(D)
    for (int i = 2; i < D; ++i) {
      g[i] = x[i];
      tail = R::add(tail, R::mul(x[i], x[i]));
    }
    return R::add(R::add(R::mul(R::mul(R::mul(0.5f, x1), x1), a.k2), R::mul(R::mul(0.5f, r), r)),
                  R::mul(0.5f, tail));
  } else if constexpr (E == kMog) {
    // g = x·Σ_k c_k − Σ_k c_k μ_k, c_k = r_k/σ_k² from the max-shifted
    // exps; U = −(m + log Σ_k e^{lg_k − m})
    float lg[kMogMaxComponents], c[kMogMaxComponents];
    const int NK = mog_logits<D, R>(x, lg, a);
    const float* cst = a.params + NK * D;
    float m = lg[0];
#pragma unroll
    for (int k = 1; k < kMogMaxComponents; ++k)
      if (k < NK) m = nan_max(m, lg[k]);
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kMogMaxComponents; ++k) {
      if (k >= NK) break;
      c[k] = expf(R::sub(lg[k], m));
      tot = k == 0 ? c[0] : R::add(tot, c[k]);
    }
    const float inv_tot = R::div(1.f, tot);
    float sum_c = 0.f;
#pragma unroll
    for (int k = 0; k < kMogMaxComponents; ++k) {
      if (k >= NK) break;
      c[k] = R::mul(R::mul(c[k], inv_tot), __ldg(cst + 2 * NK + k));
      sum_c = k == 0 ? c[0] : R::add(sum_c, c[k]);
    }
MJHMC_UNROLL_DIMS(D)
    for (int i = 0; i < D; ++i) {
      float row = 0.f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kMogMaxComponents; ++k) {
        if (k >= NK) break;
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
    return -R::add(m, logf(tot));
  } else {
    const float mu = dim(0), l = dim(1);
    const float prior = R::add(R::mul(R::mul(R::mul(0.5f, mu), mu), a.k0),
                               R::mul(R::mul(R::mul(0.5f, l), l), a.k1));
    if constexpr (E == kEightSchoolsCentered) {
      // k0 = 1/m₀², k1 = 1/s₀², k2 = K; p = y, q = 1/σ²; dth_j = θ_j − μ
      const float e2 = expf(R::mul(-2.f, l));
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        g[j] = 0.f;
        if (P.own(j) && P.i0 + j >= 2) {
          const float dth = R::sub(x[j], mu), r = R::sub(x[j], P.p[j]);
          s1 = R::add(s1, dth);
          s2 = R::add(s2, R::mul(dth, dth));
          s3 = R::add(s3, R::mul(R::mul(r, r), P.q[j]));
          g[j] = R::add(R::mul(e2, dth), R::mul(r, P.q[j]));
        }
      }
      const float S1 = grp.sum(s1), S2 = grp.sum(s2);
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        if (P.i0 + j == 0) g[j] = R::sub(R::mul(mu, a.k0), R::mul(e2, S1));
        if (P.i0 + j == 1) g[j] = R::sub(R::add(R::mul(l, a.k1), a.k2), R::mul(e2, S2));
      }
      const float S3 = grp.sum(s3);
      return R::add(R::add(R::add(prior, R::mul(a.k2, l)), R::mul(R::mul(0.5f, e2), S2)),
                    R::mul(0.5f, S3));
    } else {  // non-centred: θ_j = μ + e^ℓ z_j, ri_j = (θ_j − y_j)/σ_j²
      const float e = expf(l);
      float s1 = 0.f, s2 = 0.f, s4 = 0.f, s5 = 0.f;
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        g[j] = 0.f;
        if (P.own(j) && P.i0 + j >= 2) {
          const float r = R::sub(R::add(mu, R::mul(e, x[j])), P.p[j]);
          const float ri = R::mul(r, P.q[j]);
          s1 = R::add(s1, ri);
          s2 = R::add(s2, R::mul(x[j], ri));
          s4 = R::add(s4, R::mul(x[j], x[j]));
          s5 = R::add(s5, R::mul(R::mul(r, r), P.q[j]));
          g[j] = R::add(x[j], R::mul(e, ri));
        }
      }
      const float S1 = grp.sum(s1), S2 = grp.sum(s2);
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        if (P.i0 + j == 0) g[j] = R::add(R::mul(mu, a.k0), S1);
        if (P.i0 + j == 1) g[j] = R::add(R::mul(l, a.k1), R::mul(e, S2));
      }
      const float S4 = grp.sum(s4), S5 = grp.sum(s5);
      return R::add(R::add(prior, R::mul(0.5f, S4)), R::mul(0.5f, S5));
    }
  }
}

// U of a separable energy from the lane's partial s of its owned terms
template <int E, int G, class R = Fused>
__device__ __forceinline__ float u_separable(float s, const Group<G>& grp) {
  s = grp.sum(s);
  return E == kRoughWell ? s : R::mul(0.5f, s);
}

// U of the chain at the group's x: a separable energy's from its owners'
// terms (on one lane, in dim order), a coupled energy's on one lane from
// grad_u (its gradient dropped)
template <int E, int D, int K, int G, class R = Fused>
__device__ __forceinline__ float u_chain(const float (&x)[K], const Owned<E, D, K>& P,
                                         const Group<G>& grp, const Args& a) {
  static_assert(kSeparable<E> || G == 1, "a coupled chain's energy on one lane");
  if constexpr (kSeparable<E>) {
    float s = 0.f;
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j)
      if (P.own(j)) s = R::add(s, u_term<E, R>(x[j], P.p[j], a));
    return u_separable<E, G, R>(s, grp);
  } else {
    float g[K];
    return grad_u<E, D, K, G, R>(x, g, P, grp, a);
  }
}

// ½ Σ (v·v)·M^-1 over the lane's owned dims (every dim on one lane), in dim
// order, M^-1 from the lane's row (mass: the row the lane's Owned was
// loaded from, nullptr without a mass)
template <int E, int D, int K, class R = Fused>
__device__ __forceinline__ float halfsq_own(const float (&v)[K], const Owned<E, D, K>& P,
                                            const float* mass) {
  float s = 0.f;
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    const float vv = R::mul(v[j], v[j]);
    if (P.own(j)) s = R::add(s, mass ? R::mul(vv, P.im[j]) : vv);
  }
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
                                      const Owned<E, D, D>& P, const float* mass, float c_open,
                                      float c_drift, float c_close, const Args& a) {
  if constexpr (kSeparable<E>) {
MJHMC_UNROLL_DIMS(D)
    for (int i = 0; i < D; ++i)
      stage1<E, OPEN>(x[i], v[i], g[i], P.p[i], inv_mass(mass, i), c_open, c_drift, c_close, a);
  } else {
MJHMC_UNROLL_DIMS(D)
    for (int i = 0; i < D; ++i) {
      if (OPEN) v[i] = v[i] - c_open * g[i];
      x[i] = x[i] + c_drift * (inv_mass(mass, i) * v[i]);
    }
    grad_u<E, D, D, 1>(x, g, P, Group<1>(), a);
MJHMC_UNROLL_DIMS(D)
    for (int i = 0; i < D; ++i) v[i] = v[i] - c_close * g[i];
  }
}

// M integrator steps of one trajectory
template <int D, int E>
__device__ __forceinline__ void integrate(float (&x)[D], float (&v)[D], float (&g)[D],
                                          const Owned<E, D, D>& P, const Args& a,
                                          const float* mass, bool two_stage) {
  const float eps = a.eps, he = 0.5f * a.eps;
  if (two_stage) {
    const float cb = kTwoStageB * eps, cm = kTwoStageMid * eps;
    for (int k = 0; k < a.m; ++k) {
      if constexpr (kSeparable<E>) {
MJHMC_UNROLL_DIMS(D)
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

// The PROF instances' phase breakdown of the MJHMC and MALT bodies (PhaseClock,
// one record a chain): clock64() cycles of each phase and counters
namespace ewprof {
// MJHMC: the forward and backward trajectories (a step of each in turn, as
// the main path runs them), the energies, rates and clock choice, the
// refresh, the Kahan sums and emission; then the chain-iterations that
// began with an invalid cache and those whose warp held any such chain
enum MjhmcPhase {
  kMjTrajectories = 0, kMjRates, kMjRefresh, kMjKahan, kMjOther, kMjInvalid, kMjWarpInvalid,
  kMjPhases
};
// MALT: the refresh draw, the O-step draws, the kick-drift and gradient, the
// energy (and Δ), the Metropolis test with the Kahan sums and emission
enum MaltPhase {
  kMaRefresh = 0, kMaDraws, kMaKickGrad, kMaEnergy, kMaAccept, kMaOther, kMaPhases
};
// Control: the corruption draw (ξ and the Metropolis uniform), the
// trajectory (kick, drift, gradient), its end energy, the Metropolis test
// with the Kahan sums and emission
enum ControlPhase { kCoDraw = 0, kCoTrajectory, kCoEnergy, kCoAccept, kCoOther, kCoPhases };
}  // namespace ewprof

// ---------------------------------------------------------------------------
// A chain over a group of lanes (the MJHMC, control and MALT bodies)
//
// Lanes a chain of the MJHMC (variant kMjhmc), control (kControl) and MALT
// (kMalt) bodies at d dims on energy E. Where one thread a chain would spill
// (D 50: x, v, g, a trajectory or two and the Kahan rows are 550-650
// floats) or leave its draws on one lane's serial path, a chain takes a
// group of lanes of one warp: MALT's and control's dims go to the lanes at
// D 50 (8, 7 dims a lane; 16 lanes' sums cost control more than 4 dims a
// lane saved) and MALT's at D 10 (4; 2 on the separable energies' D 2, so
// that each lane draws its own dim's noise); MJHMC's separable dims at D 50
// go to 8 lanes, and a coupled energy's two trajectories to 2 lanes (D 10),
// where dims over lanes would exchange the coupling scalars at every step.
// Control's coupled energies at D 10 run on 8 lanes that each hold every
// dim and the whole trajectory and split the corruption draw's pairs
// (control_kernel's whole mode: 0.68-0.80x one lane's time, where dims
// over 4 lanes took 1.1-2.5x; PERF.md §6). MJHMC and control keep one
// thread a chain at D <= 2 (the rough well's 10,000-102,400 chains fill the
// card; a lane's dims are independent dependent chains that interleave).
// At any other D the same rule by dims a lane: a separable energy's dims go
// to the fewest lanes that hold at most kLaneDims each (MALT's to two at
// least); the funnel's and eight schools' MALT dims likewise, four lanes at
// least; the banana and the mixture, whose gradient runs on one lane
// (grad_u), keep MALT on one lane; a coupled energy's MJHMC takes its two
// trajectories on 2 lanes and control's whole mode 8 lanes from D 10.
// ops/cuda_mjhmc.py (ew_lanes) mirrors this.
constexpr int kLaneDims = 7;  // the presets' D 50 over 8 lanes
// the fewest lanes, a power of two up to a warp, that hold at most `most`
// of d dims each
__host__ __device__ constexpr int lanes_for(int d, int most) {
  int g = 1;
  while (g < 32 && (d + g - 1) / g > most) g *= 2;
  return g;
}
__host__ __device__ constexpr int ew_lanes(int variant, int d, int energy) {
  const bool separable = energy == kRoughWell || energy == kGaussian;
  const bool grouped =
      energy == kFunnel || energy == kEightSchoolsCentered || energy == kEightSchoolsNoncentered;
  const int g = lanes_for(d, kLaneDims);
  if (separable) return variant == kMalt && d >= 2 && g < 2 ? 2 : g;
  if (variant == kMjhmc) return d >= 10 ? 2 : 1;
  if (variant == kControl) return d >= 10 ? 8 : 1;
  return grouped && d >= 10 ? (g < 4 ? 4 : g) : 1;
}
// Threads a block of the MJHMC, control and MALT bodies for n chains of `lanes`
// lanes on a card of sms SMs: the fewest, a power of two from the group up to
// kThreads, that put at most one block on each SM sub-partition, else
// kThreads (ops/cuda_mjhmc.py, ew_threads, mirrors this)
__host__ __device__ constexpr int ew_threads_for(int lanes, long long n, int sms) {
  int t = lanes;
  while (t < kThreads && (n * lanes + t - 1) / t > (long long)kSmSubPartitions * sms) t *= 2;
  return t;
}

// One kick-drift-force-kick stage on one dim of a separable energy (as
// stage1) that also returns U's term of the dim at its new x: the rough
// well's force takes sin(x k1) and its energy cos(x k1), one sincosf of the
// same argument (one range reduction). OPEN=false skips the opening kick
// (the two-stage step's second half), as stage1 does.
template <int E, bool OPEN = true>
__device__ __forceinline__ float stage1_u(float& x, float& v, float& g, float p, float im,
                                          float c_open, float c_drift, float c_close,
                                          const Args& a) {
  const float vh = OPEN ? v - c_open * g : v;
  x = x + c_drift * (im * vh);
  float term;
  if constexpr (E == kRoughWell) {
    float sn, cs;
    sincosf(x * a.k1, &sn, &cs);
    g = rw_du(x, [&] { return sn; }, a);
    term = rw_u(x, [&] { return cs; }, a);
  } else {
    g = du<E>(x, p, a);
    term = u_term<E>(x, p, a);
  }
  v = vh - c_close * g;
  return term;
}

// stage on a group's owned dims of a coupled energy: the kick and the drift
// of each, the group's gradient, the closing kick; returns U at the new x
template <int E, int D, int K, int G, bool OPEN>
__device__ __forceinline__ float stage_group(float (&x)[K], float (&v)[K], float (&g)[K],
                                             const Owned<E, D, K>& P, const Group<G>& grp,
                                             float c_open, float c_drift, float c_close,
                                             const Args& a) {
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    if (OPEN) v[j] = v[j] - c_open * g[j];
    x[j] = x[j] + c_drift * (P.im[j] * v[j]);
  }
  const float u = grad_u<E, D, K, G>(x, g, P, grp, a);
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) v[j] = v[j] - c_close * g[j];
  return u;
}

// M integrator steps of one trajectory on the lane's dims (a coupled
// energy's on one lane: integrate); returns U at its end
template <int D, int E, int K, int G>
__device__ __forceinline__ float integrate_group(float (&x)[K], float (&v)[K], float (&g)[K],
                                                 const Owned<E, D, K>& P, const Group<G>& grp,
                                                 const Args& a, const float* mass,
                                                 bool two_stage) {
  if constexpr (kSeparable<E>) {
    const float eps = a.eps, he = 0.5f * a.eps;
    const float cb = kTwoStageB * eps, cm = kTwoStageMid * eps;
    for (int k = 0; k < a.m; ++k) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        if (two_stage) {
          stage1<E, true>(x[j], v[j], g[j], P.p[j], P.im[j], cb, he, cm, a);
          stage1<E, false>(x[j], v[j], g[j], P.p[j], P.im[j], 0.f, he, cb, a);
        } else {
          stage1<E, true>(x[j], v[j], g[j], P.p[j], P.im[j], he, eps, he, a);
        }
      }
    }
  } else {
    integrate<D, E>(x, v, g, P, a, mass, two_stage);
  }
  return u_chain<E, D, K, G>(x, P, grp, a);
}

// The uniforms of words wa .. wa + K − 1 (ua) and wb .. wb + K − 1 (ub) of a
// chain's MJHMC draw (tag 0) at iteration t: every lane of a group draws the
// same number of Philox blocks (as many as a run of K words can span, both
// runs' blocks independent of each other, so they overlap) and picks its
// words by selects, so the group's lanes never wait on each other; 2⁻²⁵
// each in fixed-uniform mode
template <int K>
__device__ __forceinline__ void mjhmc_word_runs(const Args& a, uint32_t c, uint32_t t, int wa,
                                                int wb, uint2 key, float (&ua)[K],
                                                float (&ub)[K]) {
  constexpr int kSpan = (K + 6) / 4;
  const int sa = wa >> 2, sb = wb >> 2;
  uint4 ba[kSpan], bb[kSpan];
MJHMC_UNROLL_DIMS(kSpan)
  for (int b = 0; b < kSpan; ++b) {
    ba[b] = philox4x32_10(make_uint4(c, t, sa + b, kTagMjhmc), key);
    bb[b] = philox4x32_10(make_uint4(c, t, sb + b, kTagMjhmc), key);
  }
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    uint32_t xa = 0u, xb = 0u;
MJHMC_UNROLL_DIMS(kSpan)
    for (int b = 0; b < kSpan; ++b) {
      if (((wa + j) >> 2) == sa + b) xa = word_of(ba[b], wa + j);
      if (((wb + j) >> 2) == sb + b) xb = word_of(bb[b], wb + j);
    }
    ua[j] = a.fixed_uniform ? 0x1p-25f : philox_uniform(xa);
    ub[j] = a.fixed_uniform ? 0x1p-25f : philox_uniform(xb);
  }
}

// The MJHMC body. Each chain runs on ew_lanes(kMjhmc, D, E) lanes (Group).
// A separable energy's dims go to the lanes, each owning K of them: x, v, g,
// both trajectories and the Kahan rows of those dims live in the lane's
// registers, no lane waits on another during the trajectories, and the
// per-chain energies and kinetic terms are the owners' partials added in
// rank order. A coupled energy's chain takes two lanes, lane 0 the forward
// trajectory and lane 1 the backward one, each over all D dims with no
// exchange inside a trajectory; the lanes then swap their energies (and, on
// an L jump, lane 0's state). Every lane of a group takes the same
// decisions. The refresh on a group: each lane draws its share of the
// dims' words (mjhmc_word_runs) and the group exchanges them. With one lane a
// chain this is the first port's one-thread-a-chain body, operation for
// operation. BR=false is the fast path without a mass and with the
// leapfrog, compiled with no branch code at all (as the TPU kernel compiles
// inv_mass=None statically); BR=true takes both branches from the
// arguments. PROF stamps the phases into a.prof (rank 0's; the two
// trajectories, which a lane runs step by step in turn, as one phase;
// nothing on the main path runs it).
template <int D, int E, bool EMIT, bool BR, bool PROF = false>
__global__ void __launch_bounds__(kThreads) mjhmc_kernel(Args a) {
  constexpr int G = ew_lanes(kMjhmc, D, E);
  constexpr bool kTraj = !kSeparable<E> && G > 1;  // a trajectory a lane
  constexpr int K = kTraj ? D : (D + G - 1) / G;   // dims a lane holds
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (c >= a.n) return;
  const size_t n = a.n;
  const float* mass = BR ? a.mass : nullptr;
  const bool two_stage = BR && a.two_stage;
  const Group<G> grp;
  const Owned<E, D, K> P(a, kTraj ? 0 : grp.rank, mass);
  PhaseClock<PROF, ewprof::kMjPhases, ewprof::kMjOther> prof;
  prof.start();
  // a per-chain sum of the lanes' partials (a lane with every dim: its own)
  auto chain_sum = [&](float p) { return kTraj ? p : grp.sum(p); };
  // the lane stores dim j (each dim by one lane)
  auto writes = [&](int j) { return kTraj ? j % G == grp.rank : P.own(j); };

  float x[K], v[K], g[K];
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    const int i = P.i0 + j;
    x[j] = P.own(j) ? a.x[i * n + c] : 0.f;
    v[j] = P.own(j) ? a.v[i * n + c] : 0.f;
    g[j] = P.own(j) ? a.g[i * n + c] : 0.f;
  }
  float u = a.u[c], h_back = a.h_back[c], valid = a.valid[c];

  float w = 0.f, wc = 0.f;
  float wx[K], wxc[K], wx2[K], wx2c[K];
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) wx[j] = wxc[j] = wx2[j] = wx2c[j] = 0.f;
  int evals = 0;

  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  const int m_cost = two_stage ? 2 * a.m : a.m;  // evals per trajectory half
  for (int t = 0; t < a.num_iters; ++t) {
    if constexpr (PROF) {
      if (valid <= 0.5f) prof.count(ewprof::kMjInvalid);
      if (__any_sync(__activemask(), valid <= 0.5f)) prof.count(ewprof::kMjWarpInvalid);
    }
    const float h_cur = u + chain_sum(halfsq_own(v, P, mass));

    // forward from (x, v) and backward from (x, -v), M steps each (a lane
    // with both: the leapfrog takes a step of each in turn, separable
    // energies per dim); a lane of a coupled chain runs its own
    float xf[K], vf[K], gf[K];
    float uf, h_l, h_b = h_back;
    if constexpr (kTraj) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        xf[j] = x[j];
        vf[j] = grp.rank == 0 ? v[j] : -v[j];
        gf[j] = g[j];
      }
      prof.mark(ewprof::kMjOther);
      const float ut = integrate_group<D, E, K, 1>(xf, vf, gf, P, Group<1>(), a, mass,
                                                   two_stage);
      prof.mark(ewprof::kMjTrajectories);  // lane 1's backward trajectory runs beside
      const float ht = ut + halfsq_own(vf, P, mass);
      uf = grp.from(ut, 0);
      h_l = grp.from(ht, 0);
      const float hb = grp.from(ht, 1);
      if (valid <= 0.5f) h_b = hb;
    } else {
      float xb[K], vb[K], gb[K];
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        xf[j] = xb[j] = x[j];
        vf[j] = v[j];
        vb[j] = -v[j];
        gf[j] = gb[j] = g[j];
      }
      prof.mark(ewprof::kMjOther);
      float ub = 0.f;
      bool ub_known = false;
      if (two_stage) {
        uf = integrate_group<D, E, K, G>(xf, vf, gf, P, grp, a, mass, two_stage);
        ub = integrate_group<D, E, K, G>(xb, vb, gb, P, grp, a, mass, two_stage);
        ub_known = true;
      } else if constexpr (kSeparable<E>) {
        for (int k = 0; k < a.m; ++k) {
MJHMC_UNROLL_DIMS(K)
          for (int j = 0; j < K; ++j) {
            stage1<E, true>(xf[j], vf[j], gf[j], P.p[j], P.im[j], he, eps, he, a);
            stage1<E, true>(xb[j], vb[j], gb[j], P.p[j], P.im[j], he, eps, he, a);
          }
        }
        uf = u_chain<E, D, K, G>(xf, P, grp, a);
      } else {  // one lane a chain (K = D)
        for (int k = 0; k < a.m; ++k) {
          stage<E, D, true>(xf, vf, gf, P, mass, he, eps, he, a);
          stage<E, D, true>(xb, vb, gb, P, mass, he, eps, he, a);
        }
        uf = u_chain<E, D, K, G>(xf, P, grp, a);
      }
      prof.mark(ewprof::kMjTrajectories);
      h_l = uf + grp.sum(halfsq_own(vf, P, mass));
      if (valid <= 0.5f) {  // the same on every lane of the group
        if (!ub_known) ub = u_chain<E, D, K, G>(xb, P, grp, a);
        h_b = ub + grp.sum(halfsq_own(vb, P, mass));
      }
    }

    const float log_gl = log_rate(h_l, h_cur);
    const float log_glf = log_rate(h_b, h_cur);
    const float gamma_l = expf(log_gl < kNegInf ? kNegInf : log_gl);
    const float df = expf(log_glf) - gamma_l;
    const float gamma_f = df < 0.f ? 0.f : df;
    const float total = gamma_l + gamma_f + a.beta;
    const float dwell = 1.0f / total;

    // categorical clock choice by inverse CDF from one uniform (word 0 of
    // slot 0, whose other words the refresh takes)
    const uint4 r0 = philox4x32_10(make_uint4(c, t, 0u, 0u), key);
    const float u0 = a.fixed_uniform ? 0x1p-25f : philox_uniform(r0.x);
    const float u_sel = u0 * total;
    const bool is_l = u_sel < gamma_l;
    const bool is_f = !is_l && u_sel < gamma_l + gamma_f;
    const bool is_r = !is_l && !is_f;
    prof.mark(ewprof::kMjRates);

    // accumulators and emissions take the pre-transition x
    evals += valid > 0.5f ? m_cost : 2 * m_cost;
    kadd(w, wc, dwell);
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) {
      kadd(wx[j], wxc[j], dwell * x[j]);
      kadd(wx2[j], wx2c[j], dwell * x[j] * x[j]);
    }
    if (EMIT && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j)
        if (writes(j)) a.xs[(e * D + P.i0 + j) * n + c] = x[j];
      if (grp.rank == 0) {
        a.ws[e * n + c] = dwell;
        a.es[e * n + c] = evals;
      }
    }
    prof.mark(ewprof::kMjKahan);

    if (is_l) {  // a coupled chain's lane 1 takes lane 0's forward state
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        x[j] = kTraj ? grp.from(xf[j], 0) : xf[j];
        v[j] = kTraj ? grp.from(vf[j], 0) : vf[j];
        g[j] = kTraj ? grp.from(gf[j], 0) : gf[j];
      }
      u = uf;
      h_back = h_cur;
    } else if (is_f) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) v[j] = -v[j];
      h_back = h_l;
    } else {
      // refresh v ~ N(0, M) by Box-Muller's cosine branch: dim i takes
      // words 1+i and 1+D+i of this iteration's 1+2D (blocks of four). The
      // counter fixes every word, so words no transition uses need not be
      // computed: the stream is the same as drawing all of them.
      if constexpr (G == 1) {
        // the blocks that hold the words, slot 0 the clock choice's
        uint32_t slot = 0u;
        uint4 blk = r0;
        auto word = [&](uint32_t k) {
          if ((k >> 2) != slot) {
            slot = k >> 2;
            blk = philox4x32_10(make_uint4(c, t, slot, 0u), key);
          }
          return word_of(blk, k);
        };
        float rad[K];
MJHMC_UNROLL_DIMS(K)
        for (int j = 0; j < K; ++j)
          rad[j] = sqrtf(-2.0f * logf(a.fixed_uniform ? 0x1p-25f : philox_uniform(word(1 + j))));
MJHMC_UNROLL_DIMS(K)
        for (int j = 0; j < K; ++j) {
          const float un = a.fixed_uniform ? 0x1p-25f : philox_uniform(word(1 + D + j));
          v[j] = rad[j] * cosf(kTwoPi * un) * P.sm[j];
        }
      } else {
        // a lane draws dims rank·H .. rank·H + H − 1 (its own where the dims
        // are the lanes'); a coupled chain's lanes then exchange them
        constexpr int H = (D + G - 1) / G;
        const int i0 = grp.rank * H;
        float u1[H], u2[H], vr[H];
        mjhmc_word_runs<H>(a, c, t, 1 + i0, 1 + D + i0, key, u1, u2);
MJHMC_UNROLL_DIMS(H)
        for (int h = 0; h < H; ++h) {
          const float sm = mass && i0 + h < D ? __ldg(mass + D + i0 + h) : 1.f;
          vr[h] = sqrtf(-2.0f * logf(u1[h])) * cosf(kTwoPi * u2[h]) * sm;
        }
MJHMC_UNROLL_DIMS(K)
        for (int j = 0; j < K; ++j)
          v[j] = kTraj ? grp.from(vr[j % H], j / H) : P.own(j) ? vr[j] : 0.f;
      }
      prof.mark(ewprof::kMjRefresh);
    }
    valid = is_r ? 0.f : 1.f;
    prof.mark(ewprof::kMjOther);
  }

MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    if (!writes(j)) continue;
    const int i = P.i0 + j;
    a.xo[i * n + c] = x[j];
    a.vo[i * n + c] = v[j];
    a.go[i * n + c] = g[j];
    a.wx[i * n + c] = wx[j];
    a.wx2[i * n + c] = wx2[j];
  }
  if (grp.rank == 0) {
    a.uo[c] = u;
    a.hbo[c] = h_back;
    a.valido[c] = valid;
    a.w[c] = w;
    a.evals[c] = evals;
    prof.mark(ewprof::kMjOther);
    prof.store(a.prof + (size_t)c * ewprof::kMjPhases);
  }
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
// Design: one thread per chain, and one loop whose body is one leaf. Each
// lane carries its own position (iteration t, round jj, leaf i) and a state;
// at the bottom of the body, predicated tails close its round (merge,
// endpoints, the tree's U-turn test), open its next round, close its
// iteration (evals, Kahan sums, emission) and open the next. The warp runs
// leaves in a tight loop until none of its lanes is inside a round, then
// opens each lane's next round, or all their next iterations together (warp
// votes), as a loop of rounds inside a loop of iterations ran them. (Lanes
// that ran on into their next round at once would keep more of the warp's
// leaf slots live, but they pay for each other's tails and stack rows, which
// warp divergence serialises; PERF.md §6 has the measurement.) Blocks are
// sized to the chain count (threads_for), so that few chains spread over
// every SM, where the tree rows live on chip.
// Only the integration frame (x, v, g of the current leaf) and, up to
// kOnChipDims, the subtree's proposal live in registers; the chain's sample,
// the endpoints, v0, the Kahan pairs and the 2(max_depth − 1) U-turn stack
// rows are the tree rows (Row), in shared memory laid out [row][dim][thread]
// (a warp's lanes read consecutive words) where D ≤ kOnChipDims, else in a
// (rows, D, n) scratch buffer in device memory that the wrapper allocates
// (coalesced across chains, L2-resident at the presets' widths). Where the
// rows are on chip, a leaf's multinomial update runs beside the next leaf's
// leapfrog step. Blocks of at most one warp ask for one block an SM
// (__launch_bounds__), so ptxas may give a thread all 255 registers (at its
// own choice of 128 the funnel's instance with a mass spilled; PERF.md §6).
//
// What bounds it: latency, not the card's rates. A leaf is a chain of
// dependent steps (kick, drift, gradient, energy, the multinomial update,
// the U-turn projections), and a warp runs, round by round, as many leaf
// steps as its longest lane (PERF.md §6 lists the per-phase breakdown).
//
// Random numbers: Philox4x32-10 keyed (seed, 0), with counters tagged 1
// (momentum), 2 (round: direction, merge) and 3 (leaf, by tree position),
// as philox.cuh lays out. A lane meets its leaves in tree order, so tree
// positions run 0, 1, 2, ... through an iteration and a leaf block is drawn
// at every fourth. The arithmetic takes the Rn policy and sums over dims one
// after another, as the plain PyTorch version does, so that every rounding
// is the plain version's and the tree decisions agree with it bit for bit.
namespace nuts {

// the deepest tree: its 2^31 − 1 leaves, the lane's leaf count and every
// tree position (2^jj − 1 + i, jj ≤ 30) fit an int32, as JAX's leaf counters
// are (a launch asks for the shared memory of its own depth: at D 10 and 32
// threads, rows(31)·D·32·4 = 96,000 bytes a block)
constexpr int kMaxDepth = 31;
constexpr float kDivThreshold = 1000.0f;
// the tree rows live in shared memory up to this many dims
constexpr int kOnChipDims = 10;
// a block is one warp or a part of one
constexpr int kBlockThreads = 32;
// SM sub-partitions (warp schedulers) an SM has
constexpr int kSubPartitions = 4;
// Threads a block for n chains on a card of sms SMs: the fewest, a power of
// two up to one warp, that put at most one block on each SM sub-partition,
// else one warp (ops/cuda_mjhmc.py, nuts_threads, mirrors this)
__host__ __device__ constexpr int threads_for(int n, int sms) {
  int t = 1;
  while (t < kBlockThreads && (n + t - 1) / t > kSubPartitions * sms) t *= 2;
  return t;
}

// The tree rows of a chain, D floats each: the sample (x, g), the subtree's
// proposal (xs, gs), the tree's endpoints in the trajectory frame, the
// iteration's momentum v0, the Kahan pairs of Σx and Σx², then the U-turn
// stack (x, v of span row mm at kStack + 2(mm − 1))
enum Row {
  kX = 0, kG, kXS, kGS, kXM, kVM, kGM, kXP, kVP, kGP, kV0, kWX, kWXC, kWX2, kWX2C, kStack
};
__host__ __device__ constexpr int rows(int max_depth) { return kStack + 2 * (max_depth - 1); }

// shared-memory bytes of a block of t threads at max_depth: the tree rows
// where they live on chip
template <int D>
__host__ __device__ constexpr int smem_bytes(int t, int max_depth) {
  return D <= kOnChipDims ? rows(max_depth) * D * t * (int)sizeof(float) : 0;
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

// The PROF instances' phase breakdown (PhaseClock, every thread its own
// chain's): a leaf's kick-drift and gradient, its energy and ½vᵀM⁻¹v, the
// multinomial update with the leaf draw, the stack pushes and U-turn
// projections; a round's opening and closing (direction, frame, merge,
// endpoints, the tree's U-turn test); an iteration's closing and opening
// (Kahan sums, emission, momentum draw, h0); the waits while other lanes of
// the warp run a tail or leaves this lane has not (idle), and the rest; then
// the chain's leaves and, counted by one lane of the warp at each leaf step,
// the leaf slots the warp spent on it (its live lanes)
enum Phase {
  kPhKickDrift = 0, kPhEnergy, kPhMultinomial, kPhStack, kPhRound, kPhIteration, kPhIdle,
  kPhOther, kPhLeaves, kPhSlots, kPhases
};
template <bool ON>
using Prof = PhaseClock<ON, kPhases, kPhOther>;

// One leaf step of the warp: its first active lane adds the warp's live
// lanes to the slots
template <bool ON>
__device__ __forceinline__ void count_leaf(Prof<ON>& prof, int live) {
  if constexpr (ON) {
    prof.count(kPhLeaves);
    if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) prof.add(kPhSlots, live);
  }
}

extern __shared__ float nuts_tree_smem[];

// MASS=false compiles no inverse mass (the fast path); MASS=true reads it;
// PROF stamps the phases into a.prof (nothing on the main path runs it).
// Blocks of blockDim.x ≤ kBlockThreads threads, with smem_bytes<D> of
// dynamic shared memory.
template <int D, int E, bool EMIT, bool MASS, bool PROF = false>
__global__ void __launch_bounds__(kBlockThreads, 1) nuts_kernel(Args a) {
  constexpr bool kOnChip = D <= kOnChipDims;
  const int T = blockDim.x;
  const int c = blockIdx.x * T + threadIdx.x;
  if (c >= a.n) return;
  const size_t n = a.n;
  const int max_depth = a.m;
  const float* mass = MASS ? a.mass : nullptr;
  Prof<PROF> prof;
  prof.start();
  const int live = min(T, a.n - (int)blockIdx.x * T);  // the warp's live lanes

  // dim i of tree row r of this chain
  float* const tree = kOnChip ? nuts_tree_smem + threadIdx.x : a.scratch + c;
  auto row = [&](int r, int i) -> float& {
    if constexpr (kOnChip)
      return tree[(r * D + i) * T];
    else
      return tree[((size_t)r * D + i) * n];
  };
  // ((row a − row b)·w)·M^-1 summed over dims, w a row or the frame
  auto proj_rows = [&](int ra, int rb, int rw) {
    float s = 0.f;
MJHMC_UNROLL_DIMS(D)
    for (int d = 0; d < D; ++d)
      s = Rn::add(s, mass_mul<Rn>(Rn::mul(Rn::sub(row(ra, d), row(rb, d)), row(rw, d)), mass, d));
    return s;
  };

  const Owned<E, D, D> P(a, 0, mass);
  float xc[D], vc[D], gc[D];  // the integration frame: the current leaf
MJHMC_UNROLL_DIMS(D)
  for (int i = 0; i < D; ++i) {
    row(kX, i) = a.x[i * n + c];
    row(kG, i) = a.g[i * n + c];
    row(kV0, i) = a.v[i * n + c];
    row(kWX, i) = row(kWXC, i) = row(kWX2, i) = row(kWX2C, i) = 0.f;
  }
  float u = a.u[c];
  float w = 0.f, wc = 0.f;
  int evals = 0;

  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  // the lane's position: leaf i of round jj of iteration t, nl leaves so far
  int t = 0, jj = 0, i = 0, nl = 0;
  float h0 = 0.f, log_w_tree = 0.f, log_w_sub = kNegInf, us = 0.f, lu_merge = 0.f;
  bool right = false;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);  // the current leaf slot's words
  // Where the rows are on chip, the subtree's proposal (x, g) lives in
  // registers, and a leaf's multinomial update waits for the next leaf's
  // leapfrog step and energy, which do not need it, so that the two
  // dependent chains overlap (a round's end settles it first). The pending
  // leaf: ΔH, divergence, energy, the log of its draw, and its x and g
  float xs[kOnChip ? D : 1], gs[kOnChip ? D : 1];
  bool pend = false, p_div = false;
  float p_dh = 0.f, p_ul = 0.f, p_lu = 0.f;
  float px[kOnChip ? D : 1], pg[kOnChip ? D : 1];
  auto prop_x = [&](int d) -> float& {
    if constexpr (kOnChip) return xs[d]; else return row(kXS, d);
  };
  auto prop_g = [&](int d) -> float& {
    if constexpr (kOnChip) return gs[d]; else return row(kGS, d);
  };

  // progressive multinomial sampling inside the subtree: the leaf of ΔH dh
  // (diverged: div), energy ul and draw log lu, at x, g, joins the
  // subtree's weight and replaces its proposal with probability its share
  auto settle = [&](bool live_leaf, float dh, bool div, float ul, float lu, auto x, auto g) {
    const float lw_leaf = div ? kNegInf : -dh;
    const float lw_new = logaddexp(log_w_sub, lw_leaf);
    const bool take = live_leaf && !div && lu < Rn::sub(lw_leaf, lw_new);
    if constexpr (kOnChip) {
MJHMC_UNROLL_DIMS(D)
      for (int d = 0; d < D; ++d) {
        xs[d] = take ? x(d) : xs[d];
        gs[d] = take ? g(d) : gs[d];
      }
    } else if (take) {
MJHMC_UNROLL_DIMS(D)
      for (int d = 0; d < D; ++d) {
        row(kXS, d) = x(d);
        row(kGS, d) = g(d);
      }
    }
    us = take ? ul : us;
    log_w_sub = live_leaf ? lw_new : log_w_sub;
  };
  auto settle_pending = [&] {
    if constexpr (kOnChip) {
      settle(pend, p_dh, p_div, p_ul, p_lu, [&](int d) { return px[d]; },
             [&](int d) { return pg[d]; });
      pend = false;
    }
  };

  // round jj: its block's word 0 picks the direction (< 0.5 goes right),
  // word 1 the merge; the frame outward from the chosen endpoint and an
  // empty subtree
  auto open_round = [&] {
    const uint4 rr = philox4x32_10(make_uint4(c, t, jj, kTagNutsRound), key);
    right = uniform(a, rr.x) < 0.5f;
    lu_merge = logf(uniform(a, rr.y));
    const int rx = right ? kXP : kXM, rv = right ? kVP : kVM, rg = right ? kGP : kGM;
MJHMC_UNROLL_DIMS(D)
    for (int d = 0; d < D; ++d) {
      xc[d] = row(rx, d);
      vc[d] = right ? row(rv, d) : -row(rv, d);
      gc[d] = row(rg, d);
      prop_x(d) = xc[d];
      prop_g(d) = gc[d];
    }
    log_w_sub = kNegInf;
    us = 0.f;
    i = 0;
    pend = false;
  };
  // a fresh momentum (dim i from words i and D+i of the momentum slots),
  // h0, a tree of one point and its first round
  auto open_iteration = [&] {
    constexpr int kBlocks = (2 * D + 3) / 4;
MJHMC_UNROLL_DIMS(kBlocks)
    for (int b = 0; b < kBlocks; ++b) {
      const uint4 r = philox4x32_10(make_uint4(c, t, b, kTagNutsMomentum), key);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * b + j;
        const float un = uniform(a, word_of(r, j));
        if (k < D) row(kV0, k) = sqrtf(Rn::mul(-2.0f, logf(un)));
        else if (k < 2 * D) row(kV0, k - D) = Rn::mul(row(kV0, k - D), cosf(Rn::mul(kTwoPi, un)));
      }
    }
    float s = 0.f;
MJHMC_UNROLL_DIMS(D)
    for (int d = 0; d < D; ++d) {
      float v0 = row(kV0, d);
      if (MASS) row(kV0, d) = v0 = Rn::mul(v0, sqrt_mass<D>(mass, d));
      s = Rn::add(s, mass_mul<Rn>(Rn::mul(v0, v0), mass, d));
      row(kXM, d) = row(kXP, d) = row(kX, d);
      row(kVM, d) = row(kVP, d) = v0;
      row(kGM, d) = row(kGP, d) = row(kG, d);
    }
    h0 = Rn::add(u, Rn::mul(0.5f, s));
    log_w_tree = 0.f;
    nl = 0;
    jj = 0;
    open_round();
  };

  // The lane's state: running leaves, at the end of a round or of its tree
  // (each with its tail to run), or through all iterations. The next round
  // opens only once no lane of the warp is inside one, and the next
  // iteration once every lane's tree is done, so a warp's lanes run the same
  // leaf of the same round
  enum { kRun = 0, kRoundEnd, kTreeDone, kFinished };
  const unsigned lanes = live == 32 ? 0xffffffffu : (1u << live) - 1u;
  int state = kFinished;
  if (a.num_iters > 0) {
    open_iteration();
    state = kRun;
  }
  prof.mark(kPhOther);

  while (__any_sync(lanes, state != kFinished)) {
    // leaves, until no lane of the warp is inside a round
    do {
      if (state == kRun) {
        // ---- leaf i of round jj: one leapfrog step
        if constexpr (kSeparable<E>) {  // dim by dim
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) {
            const float vh = Rn::sub(vc[d], Rn::mul(he, gc[d]));
            xc[d] = Rn::add(xc[d], Rn::mul(eps, mass_mul<Rn>(vh, mass, d)));
            gc[d] = du<E, Rn>(xc[d], P.p[d], a);
            vc[d] = Rn::sub(vh, Rn::mul(he, gc[d]));
          }
        } else {  // or as a vector step
          float vh[D];
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) {
            vh[d] = Rn::sub(vc[d], Rn::mul(he, gc[d]));
            xc[d] = Rn::add(xc[d], Rn::mul(eps, mass_mul<Rn>(vh[d], mass, d)));
          }
          grad_u<E, D, D, 1, Rn>(xc, gc, P, Group<1>(), a);
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) vc[d] = Rn::sub(vh[d], Rn::mul(he, gc[d]));
        }
        prof.mark(kPhKickDrift);
        count_leaf<PROF>(prof, live);
        const float ul = u_chain<E, D, D, 1, Rn>(xc, P, Group<1>(), a);
        ++nl;
        const float h = Rn::add(ul, halfsq_own<E, D, D, Rn>(vc, P, mass));
        const float dh = Rn::sub(h, h0);
        const bool div = fabsf(h) >= 1e30f || h != h || dh > kDivThreshold;
        prof.mark(kPhEnergy);

        // the previous leaf's multinomial update (pipelined), this leaf's
        // draw (tree position k takes word k % 4 of leaf slot k / 4; the
        // positions run on through the rounds of an iteration, so a slot is
        // drawn at every fourth) and, unpipelined, its own update
        settle_pending();
        const uint32_t k = (1u << jj) - 1u + i;
        if ((k & 3u) == 0u) bits = philox4x32_10(make_uint4(c, t, k >> 2, kTagNutsLeaf), key);
        const float lu = logf(uniform(a, word_of(bits, k)));
        if constexpr (kOnChip) {
          pend = true;
          p_dh = dh, p_div = div, p_ul = ul, p_lu = lu;
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) px[d] = xc[d], pg[d] = gc[d];
        } else {
          settle(true, dh, div, ul, lu, [&](int d) { return xc[d]; }, [&](int d) { return gc[d]; });
        }
        prof.mark(kPhMultinomial);

        // binary-counter U-turn stack: leaf i starts the spans of rows 1..jj
        // that 2^mm divides it by (all of them at i = 0) and ends those that
        // 2^mm divides i + 1 by; no span starts and ends at one leaf
        const int npush = min(jj, i == 0 ? jj : __ffs(i) - 1);
        for (int mm = 1; mm <= npush; ++mm) {
          const int sx = kStack + 2 * (mm - 1);
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) {
            row(sx, d) = xc[d];
            row(sx + 1, d) = vc[d];
          }
        }
        bool turning = false;
        const int ncheck = min(jj, __ffs(i + 1) - 1);
        for (int mm = 1; mm <= ncheck; ++mm) {
          const int sx = kStack + 2 * (mm - 1);
          float p_old = 0.f, p_new = 0.f;
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) {
            const float dx = Rn::sub(xc[d], row(sx, d));
            p_old = Rn::add(p_old, mass_mul<Rn>(Rn::mul(dx, row(sx + 1, d)), mass, d));
            p_new = Rn::add(p_new, mass_mul<Rn>(Rn::mul(dx, vc[d]), mass, d));
          }
          turning = turning || p_old < 0.f || p_new < 0.f;
        }
        const bool stop = div || turning;
        ++i;
        prof.mark(kPhStack);

        // ---- the round ends: at a stop, or after its 2^jj leaves
        if (stop || i == (1 << jj)) {
          bool done = stop;
          if (!stop) {
            settle_pending();
            // biased progressive merge of the completed subtree
            if (lu_merge < Rn::sub(log_w_sub, log_w_tree)) {
MJHMC_UNROLL_DIMS(D)
              for (int d = 0; d < D; ++d) {
                row(kX, d) = prop_x(d);
                row(kG, d) = prop_g(d);
              }
              u = us;
            }
            log_w_tree = logaddexp(log_w_tree, log_w_sub);
            // extend the tree (back to the trajectory frame), then the U-turn
            // test between its endpoints
            const int rx = right ? kXP : kXM, rv = right ? kVP : kVM, rg = right ? kGP : kGM;
MJHMC_UNROLL_DIMS(D)
            for (int d = 0; d < D; ++d) {
              row(rx, d) = xc[d];
              row(rv, d) = right ? vc[d] : -vc[d];
              row(rg, d) = gc[d];
            }
            done = proj_rows(kXP, kXM, kVM) < 0.f || proj_rows(kXP, kXM, kVP) < 0.f;
          }
          ++jj;
          state = done || jj == max_depth ? kTreeDone : kRoundEnd;
          prof.mark(kPhRound);
        }
      }
      prof.mark(kPhIdle);  // lanes that ran no leaf or ended no round wait here
    } while (__any_sync(lanes, state == kRun));

    // ---- the next round opens
    if (state == kRoundEnd) {
      open_round();
      state = kRun;
      prof.mark(kPhRound);
    }
    prof.mark(kPhIdle);
    // ---- the iteration ends: the post-transition x, weight 1; the next opens
    if (__all_sync(lanes, state == kTreeDone || state == kFinished)) {
      if (state == kTreeDone) {
        evals += nl;
        kadd(w, wc, 1.f);
MJHMC_UNROLL_DIMS(D)
        for (int d = 0; d < D; ++d) {
          const float x = row(kX, d);
          kadd(row(kWX, d), row(kWXC, d), x);
          kadd(row(kWX2, d), row(kWX2C, d), Rn::mul(x, x));
        }
        if (EMIT && (t + 1) % a.thin == 0) {
          const size_t e = t / a.thin;
MJHMC_UNROLL_DIMS(D)
          for (int d = 0; d < D; ++d) a.xs[(e * D + d) * n + c] = row(kX, d);
          a.ws[e * n + c] = 1.f;
          a.es[e * n + c] = evals;
        }
        state = kFinished;
        if (++t < a.num_iters) {
          open_iteration();
          state = kRun;
        }
        prof.mark(kPhIteration);
      }
    }
    prof.mark(kPhIdle);
  }

MJHMC_UNROLL_DIMS(D)
  for (int d = 0; d < D; ++d) {
    a.xo[d * n + c] = row(kX, d);
    a.vo[d * n + c] = row(kV0, d);
    a.go[d * n + c] = row(kG, d);
    a.wx[d * n + c] = row(kWX, d);
    a.wx2[d * n + c] = row(kWX2, d);
  }
  a.uo[c] = u;
  a.hbo[c] = a.h_back[c];
  a.valido[c] = a.valid[c];
  a.w[c] = w;
  a.evals[c] = evals;
  prof.mark(kPhOther);
  prof.store(a.prof + (size_t)c * kPhases);
}

}  // namespace nuts

// ---------------------------------------------------------------------------
// Fused control HMC and MALT engines, the control and MALT bodies of the TPU
// kernels _mjhmc_kernel and _mjhmc_stream_kernel (pallas_mjhmc.py:1451,
// :1494): the step bodies _make_step_control (:863-935) and
// _make_step_malt (:938-1008), the
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
// MALT (beta carries the friction gamma): v0 ~ N(0, M), then M OBABO
// steps — O: v <- eta v + sig N(0, M) (both from tag 7), eta = exp(-gamma
// eps/2), sig = sqrt(max(0, 1 - eta²)); BAB: one leapfrog step whose energy
// error enters Delta; O — and one accept with p = min(1, exp(-Delta)); on
// reject v = -v0. Leapfrog only, M evals.
//
// Design. Control (control_kernel, as redesigned for the H100): the first
// design ran one thread a chain in blocks of 64 and drew the corruption on
// the chain's serial path, 2D + 1 words with a logf, sqrtf and cosf a
// normal (62-70% of its cycles at D 10 and 50), recomputed the trajectory's
// end energy (one more gradient on the zoo) and spilled 2.5-3.3 KB at D
// 50. Now the draw is both Box-Muller branches of a pair (tag 8), the
// Metropolis uniform in the pairs' last block, made for the next iteration
// before this one's trajectory; the end energy comes from the last step
// (the rough well's force and energy one sincosf, a coupled energy's U
// beside its last gradient); a chain runs on 8 lanes from D 10 (its dims
// over them at D 50; at D 10 every lane runs the trajectory and the lanes
// split the pairs), one below, in blocks sized to the chain count. What
// bounds it now: latency, the dependent sinf chain of the rough well's
// steps (77% of its cycles) and, at D 10 and 50, a lane's draw (a Philox
// block and a pair's logf, sqrtf and sincosf in turn: 31-54% in the PROF
// stamps).
//
// MALT (malt_kernel, as redesigned for the H100): the first design drew
// (2M + 1)·D normals an iteration on the chain's serial path, each from two
// Philox words with a logf, a sqrtf and a cosf (42 at D 2, 170 at D 10
// beside M gradients: 64-85% of its cycles). Now a chain runs on a group of lanes (ew_lanes: 2
// at D 2, 4 at D 10, 8 at D 50; the banana and the mixture one), each
// drawing only its own dims' noise, both Box-Muller branches of a pair
// (half the Philox words, logf and sqrtf a normal), a Philox block a dim
// for two steps drawn ahead of them; the rough well's force and energy
// share one sincosf (the same bits as sinf and cosf, chip_smoke.py phase
// 2), and the separable energies sum Δ over the group once an iteration.
// What bounds it now: the draws are still half its cycles on the rough
// well and most of them at D 10 (PERF.md §6), beside the leapfrog's
// dependent chain.
namespace hmc {

// min(1, exp(log_ratio)) with a NaN kept NaN (as jnp.minimum keeps it), so
// that it rejects
__device__ __forceinline__ float accept_prob(float log_ratio, bool ok) {
  const float lp = log_ratio > 0.f ? 0.f : log_ratio;
  return ok ? expf(lp) : 0.f;
}

// The corruption draw of iteration t on a lane of a control chain whose
// dims go to G > 1 lanes (philox.cuh, tag 8): the normals of its dims i0 ..
// i0 + K − 1 (those < D; 0 past D), unscaled, and the Metropolis uniform
// (mh, the same on every lane of the group). Dim i is branch i % 2 of
// Box-Muller pair i / 2 (cosine, sine), the pair in words 2p (u1) and 2p + 1
// (u2) of the iteration's counter; each pair takes one logf, sqrtf and
// sincosf for its two normals. A lane draws the Philox blocks that hold the
// pairs its dims reach, so a pair that straddles two lanes (7 dims a lane at
// D 50) is drawn by both, and the words never depend on the grouping. The
// Metropolis uniform is word 2·ceil(D/2): the pairs' last block holds it
// where they leave a free word (an odd number of pairs; its owner is the
// lane of dim D − 1, which draws that block), else it is word 0 of a block
// of its own, which every lane draws. In fixed-uniform mode every normal is
// the cosine branch of u1 = u2 = 2⁻²⁵ and mh 2⁻²⁵.
template <int D, int K, int G>
__device__ __forceinline__ void control_draw(const Args& a, uint32_t c, uint32_t t, int i0,
                                             const Group<G>& grp, uint2 key, float (&z)[K],
                                             float& mh) {
  static_assert(G > 1, "a chain on one lane draws with control_draw_whole");
  constexpr int kMhWord = 2 * ((D + 1) / 2);
  // the pairs a lane's dims reach (pair p0 on), and the blocks (slot s0 on)
  // that hold them
  constexpr int NQ = K / 2 + 1, kSpan = (NQ + 2) / 2;
  const int p0 = i0 >> 1, s0 = p0 >> 1;
  const bool po = p0 & 1;  // pair p0 in its block's upper half
  uint32_t w[4 * kSpan];
MJHMC_UNROLL_DIMS(kSpan)
  for (int b = 0; b < kSpan; ++b) {
    const uint4 r = philox4x32_10(make_uint4(c, t, s0 + b, kTagControlPairs), key);
    w[4 * b] = r.x, w[4 * b + 1] = r.y, w[4 * b + 2] = r.z, w[4 * b + 3] = r.w;
  }
  float zc[NQ], zs[NQ];  // pair p0 + q's cosine and sine branches
MJHMC_UNROLL_DIMS(NQ)
  for (int q = 0; q < NQ; ++q) {
    const uint32_t w1 = po ? w[2 * q + 2] : w[2 * q], w2 = po ? w[2 * q + 3] : w[2 * q + 1];
    const float u1 = a.fixed_uniform ? 0x1p-25f : philox_uniform(w1);
    const float u2 = a.fixed_uniform ? 0x1p-25f : philox_uniform(w2);
    const float rad = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    zc[q] = rad * cs;
    zs[q] = a.fixed_uniform ? zc[q] : rad * sn;
  }
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    // i0 even: pair j / 2, branch j % 2; odd (dim i0 a sine): pair
    // (j + 1) / 2, branch (j + 1) % 2
    const float zj = i0 & 1 ? (j & 1 ? zc[(j + 1) / 2] : zs[(j + 1) / 2])
                            : (j & 1 ? zs[j / 2] : zc[j / 2]);
    z[j] = i0 + j < D ? zj : 0.f;
  }
  uint32_t wm = 0u;
  if constexpr (kMhWord % 4 != 0) {
MJHMC_UNROLL_DIMS(kSpan)
    for (int b = 0; b < kSpan; ++b)
      if ((kMhWord >> 2) == s0 + b) wm = w[4 * b + (kMhWord & 3)];
  } else {
    wm = philox4x32_10(make_uint4(c, t, kMhWord >> 2, kTagControlPairs), key).x;
  }
  mh = grp.from(a.fixed_uniform ? 0x1p-25f : philox_uniform(wm), (D - 1) / K);
}

// The corruption draw of a chain whose G lanes each hold every dim
// (control_kernel's whole mode; G = 1: a chain on one lane): lane r draws
// pairs r, r + G, ... (a Philox block and both branches each), and each dim
// takes its normal from its pair's lane; the Metropolis uniform comes from
// the lane of the last pair, whose block holds it where the pairs are odd in
// number, else from the lane that would draw pair kPairs, which draws the
// uniform's block of its own. The words are control_draw's.
template <int D, int G>
__device__ __forceinline__ void control_draw_whole(const Args& a, uint32_t c, uint32_t t,
                                                   const Group<G>& grp, uint2 key,
                                                   float (&z)[D], float& mh) {
  constexpr int kPairs = (D + 1) / 2, NQ = (kPairs + G - 1) / G;
  // an even number of pairs fills the last block: the uniform (word
  // 2·kPairs) is word 0 of the next
  constexpr bool kOwnBlock = kPairs % 2 == 0;
  float zc[NQ], zs[NQ], mh_mine = 0.f;
MJHMC_UNROLL_DIMS(NQ)
  for (int q = 0; q < NQ; ++q) {
    const int p = grp.rank + q * G;
    const uint4 r = philox4x32_10(make_uint4(c, t, p >> 1, kTagControlPairs), key);
    const float u1 = a.fixed_uniform ? 0x1p-25f : philox_uniform(p & 1 ? r.z : r.x);
    const float u2 = a.fixed_uniform ? 0x1p-25f : philox_uniform(p & 1 ? r.w : r.y);
    const float rad = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    zc[q] = rad * cs;
    zs[q] = a.fixed_uniform ? zc[q] : rad * sn;
    // the last pair (even) is words 0-1 of its block, the uniform word 2
    if (!kOwnBlock && q == (kPairs - 1) / G)
      mh_mine = a.fixed_uniform ? 0x1p-25f : philox_uniform(r.z);
  }
  if constexpr (kOwnBlock) {
    if (grp.rank == kPairs % G)
      mh_mine = a.fixed_uniform ? 0x1p-25f
                                : philox_uniform(philox4x32_10(
                                      make_uint4(c, t, kPairs >> 1, kTagControlPairs), key).x);
  }
MJHMC_UNROLL_DIMS(D)
  for (int i = 0; i < D; ++i) {
    const int pair = i / 2;
    z[i] = grp.from(i & 1 ? zs[pair / G] : zc[pair / G], pair % G);
  }
  mh = grp.from(mh_mine, (kOwnBlock ? kPairs : kPairs - 1) % G);
}

// Control's trajectory on the lane's dims: M leapfrog or two-stage steps
// (as integrate_group), the last stage also giving the end energy. A
// separable energy returns the lane's share of U (its dims' terms, taken
// beside their last forces: one sincosf on the rough well; the caller sums
// the group), a coupled one U itself from its last gradient (grad_u returns
// it beside g); M = 0 evaluates U at x.
template <int D, int E, int K, int G>
__device__ __forceinline__ float control_trajectory(float (&x)[K], float (&v)[K], float (&g)[K],
                                                    const Owned<E, D, K>& P,
                                                    const Group<G>& grp, const Args& a,
                                                    bool two_stage) {
  const float eps = a.eps, he = 0.5f * a.eps;
  const float cb = kTwoStageB * eps, cm = kTwoStageMid * eps;
  const int m = a.m;
  if constexpr (kSeparable<E>) {
    float s = 0.f;
    if (m == 0) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j)
        if (P.own(j)) s = s + u_term<E>(x[j], P.p[j], a);
      return s;
    }
    if (two_stage) {
      for (int k = 0; k + 1 < m; ++k) {
MJHMC_UNROLL_DIMS(K)
        for (int j = 0; j < K; ++j) {
          stage1<E, true>(x[j], v[j], g[j], P.p[j], P.im[j], cb, he, cm, a);
          stage1<E, false>(x[j], v[j], g[j], P.p[j], P.im[j], 0.f, he, cb, a);
        }
      }
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        stage1<E, true>(x[j], v[j], g[j], P.p[j], P.im[j], cb, he, cm, a);
        const float term =
            stage1_u<E, false>(x[j], v[j], g[j], P.p[j], P.im[j], 0.f, he, cb, a);
        if (P.own(j)) s = s + term;
      }
    } else {
      for (int k = 0; k + 1 < m; ++k) {
MJHMC_UNROLL_DIMS(K)
        for (int j = 0; j < K; ++j)
          stage1<E, true>(x[j], v[j], g[j], P.p[j], P.im[j], he, eps, he, a);
      }
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        const float term = stage1_u<E>(x[j], v[j], g[j], P.p[j], P.im[j], he, eps, he, a);
        if (P.own(j)) s = s + term;
      }
    }
    return s;
  } else {
    if (m == 0) {
      float gs[K];
      return grad_u<E, D, K, G>(x, gs, P, grp, a);
    }
    if (two_stage) {
      for (int k = 0; k + 1 < m; ++k) {
        stage_group<E, D, K, G, true>(x, v, g, P, grp, cb, he, cm, a);
        stage_group<E, D, K, G, false>(x, v, g, P, grp, 0.f, he, cb, a);
      }
      stage_group<E, D, K, G, true>(x, v, g, P, grp, cb, he, cm, a);
      return stage_group<E, D, K, G, false>(x, v, g, P, grp, 0.f, he, cb, a);
    }
    for (int k = 0; k + 1 < m; ++k) stage_group<E, D, K, G, true>(x, v, g, P, grp, he, eps, he, a);
    return stage_group<E, D, K, G, true>(x, v, g, P, grp, he, eps, he, a);
  }
}

// The control body. Each chain runs on ew_lanes(kControl, D, E) lanes
// (Group). A separable energy's group gives each lane K of its dims: x, v,
// g, the trajectory and the Kahan rows of those dims live in the lane's
// registers, each lane draws its dims' pairs (control_draw), and ½vᵀM⁻¹v and
// U are the lanes' partials added in rank order (Group::sum), once before
// and once after the trajectory. Whole mode (one lane, or a coupled energy's
// group): each lane holds every dim and runs the whole trajectory (on a
// group the same operations on the same values, with no exchange), and the
// lanes split the draw's pairs (control_draw_whole). Iteration t + 1's draw
// is made in iteration t before its trajectory, which does not wait for it,
// so the first kick never waits on Philox. Every lane takes the same
// decision. PROF stamps the phases into a.prof (rank 0's; nothing on the
// main path runs it).
template <int D, int E, bool PROF = false>
__global__ void __launch_bounds__(kThreads) control_kernel(Args a) {
  constexpr int G = ew_lanes(kControl, D, E);
  constexpr bool kWhole = G == 1 || !kSeparable<E>;
  constexpr int K = kWhole ? D : (D + G - 1) / G, GT = kWhole ? 1 : G;
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (c >= a.n) return;
  const size_t n = a.n;
  const float* mass = a.mass;
  const bool two_stage = a.two_stage;
  const Group<G> grp;
  const Group<GT> tg;  // the lanes that share a trajectory's sums
  const Owned<E, D, K> P(a, kWhole ? 0 : grp.rank, mass);
  // the lane stores dim j (each dim by one lane)
  auto writes = [&](int j) { return kWhole ? j % G == grp.rank : P.own(j); };
  const uint2 key = make_uint2(a.seed, 0u);
  auto draw = [&](uint32_t t, float (&xi)[K], float& mh) {
    if constexpr (kWhole) control_draw_whole<D, G>(a, c, t, grp, key, xi, mh);
    else control_draw<D, K, G>(a, c, t, P.i0, grp, key, xi, mh);
  };
  PhaseClock<PROF, ewprof::kCoPhases, ewprof::kCoOther> prof;
  prof.start();

  float x[K], v[K], g[K];
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    const int i = P.i0 + j;
    x[j] = P.own(j) ? a.x[i * n + c] : 0.f;
    v[j] = P.own(j) ? a.v[i * n + c] : 0.f;
    g[j] = P.own(j) ? a.g[i * n + c] : 0.f;
  }
  float u = a.u[c];

  float w = 0.f, wc = 0.f;
  float wx[K], wxc[K], wx2[K], wx2c[K];
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) wx[j] = wxc[j] = wx2[j] = wx2c[j] = 0.f;
  int evals = 0;

  const float sb = sqrtf(a.beta), sb1 = sqrtf(fmaxf(1.f - a.beta, 0.f));
  const int m_cost = two_stage ? 2 * a.m : a.m;

  // this iteration's corruption normals (unscaled) and Metropolis uniform
  float xi[K], mh = 0.f;
  if (a.num_iters > 0) draw(0u, xi, mh);
  for (int t = 0; t < a.num_iters; ++t) {
    prof.mark(ewprof::kCoOther);
    // partial corruption with xi ~ N(0, M)
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) v[j] = sb1 * v[j] + sb * (xi[j] * P.sm[j]);
    const float h0 = u + tg.sum(halfsq_own(v, P, mass));
    const float mh_t = mh;
    if (t + 1 < a.num_iters) draw(t + 1, xi, mh);
    prof.mark(ewprof::kCoDraw);

    float xf[K], vf[K], gf[K];
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) xf[j] = x[j], vf[j] = v[j], gf[j] = g[j];
    float uf = control_trajectory<D, E, K, GT>(xf, vf, gf, P, tg, a, two_stage);
    prof.mark(ewprof::kCoTrajectory);
    if constexpr (kSeparable<E>) uf = u_separable<E>(uf, tg);
    const float h_l = uf + tg.sum(halfsq_own(vf, P, mass));
    prof.mark(ewprof::kCoEnergy);

    const bool ok = fabsf(h_l) < 1e30f && h_l == h_l;  // divergence rejects
    if (mh_t < accept_prob(h0 - h_l, ok)) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) x[j] = xf[j], v[j] = vf[j], g[j] = gf[j];
      u = uf;
    } else {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) v[j] = -v[j];  // flip on reject
    }

    // the post-transition x, weight 1
    evals += m_cost;
    kadd(w, wc, 1.f);
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) {
      kadd(wx[j], wxc[j], x[j]);
      kadd(wx2[j], wx2c[j], x[j] * x[j]);
    }
    if (a.xs && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j)
        if (writes(j)) a.xs[(e * D + P.i0 + j) * n + c] = x[j];
      if (grp.rank == 0) {
        a.ws[e * n + c] = 1.f;
        a.es[e * n + c] = evals;
      }
    }
    prof.mark(ewprof::kCoAccept);
  }

MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    if (!writes(j)) continue;
    const int i = P.i0 + j;
    a.xo[i * n + c] = x[j];
    a.vo[i * n + c] = v[j];
    a.go[i * n + c] = g[j];
    a.wx[i * n + c] = wx[j];
    a.wx2[i * n + c] = wx2[j];
  }
  if (grp.rank == 0) {
    a.uo[c] = u;
    a.hbo[c] = a.h_back[c];
    a.valido[c] = a.valid[c];
    a.w[c] = w;
    a.evals[c] = evals;
    prof.mark(ewprof::kCoOther);
    prof.store(a.prof + (size_t)c * ewprof::kCoPhases);
  }
}

// Four normals of the MALT body (philox.cuh, tag 7): both Box-Muller
// branches of the two pairs (words 0-1 and 2-3) of slot `slot`, z[0] = r0 cos
// θ0, z[1] = r0 sin θ0, z[2] = r1 cos θ1, z[3] = r1 sin θ1 (r = sqrt(-2 ln
// u1), θ = 2π u2, one logf, sqrtf and sincosf a pair); in fixed-uniform mode
// every one the cosine-branch constant of u1 = u2 = 2⁻²⁵
__device__ __forceinline__ void malt_normals4(const Args& a, uint32_t c, uint32_t t,
                                              uint32_t slot, uint2 key, float (&z)[4]) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!a.fixed_uniform) r = philox4x32_10(make_uint4(c, t, slot, kTagMaltPairs), key);
  const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float u1 = a.fixed_uniform ? 0x1p-25f : philox_uniform(rw[2 * h]);
    const float u2 = a.fixed_uniform ? 0x1p-25f : philox_uniform(rw[2 * h + 1]);
    const float rad = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    z[2 * h] = rad * cs;
    z[2 * h + 1] = a.fixed_uniform ? z[2 * h] : rad * sn;
  }
}

// The MALT body. Each chain runs on ew_lanes(kMalt, D, E) lanes (Group), each
// owning K of its dims, and each lane draws its own dims' noise: dim i's
// M + 1 Box-Muller pairs of an iteration are the slots i·B .. i·B + B − 1
// (B = ceil((M + 1)/2); pair k < M gives leapfrog step k's two O-steps, its
// cosine and sine branches, pair M the refresh), the Metropolis uniform
// word 0 of slot D·B (philox.cuh, tag 7). Two steps take one Philox block a
// dim, drawn at the top of the pair of steps, so the second step's pair
// overlaps the first step's dependent chain. The separable energies keep
// each dim's potential term beside its force (one sincosf on the rough
// well) and each lane its share of Δ, added over the group once an
// iteration: no lane waits on another inside a trajectory. The coupled
// ones take the group's gradient with U beside it (grad_u; on one lane,
// the banana's and the mixture's U from the gradient's residual and
// logits). PROF stamps the phases into a.prof (nothing on the main path
// runs it).
template <int D, int E, bool PROF = false>
__global__ void __launch_bounds__(kThreads) malt_kernel(Args a) {
  constexpr int G = ew_lanes(kMalt, D, E), K = (D + G - 1) / G;
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (c >= a.n) return;
  const size_t n = a.n;
  const float* mass = a.mass;
  const Group<G> grp;
  const Owned<E, D, K> P(a, grp.rank, mass);
  PhaseClock<PROF, ewprof::kMaPhases, ewprof::kMaOther> prof;
  prof.start();

  // v holds the fresh momentum v0 during an iteration and the kept
  // momentum (vl on accept, -v0 on reject) after it
  float x[K], v[K], g[K];
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    const int i = P.i0 + j;
    x[j] = P.own(j) ? a.x[i * n + c] : 0.f;
    v[j] = P.own(j) ? a.v[i * n + c] : 0.f;
    g[j] = P.own(j) ? a.g[i * n + c] : 0.f;
  }
  float u = a.u[c];
  // a separable energy: U's terms of the lane's dims at x
  float u_mine = 0.f;
  if constexpr (kSeparable<E>) {
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j)
      if (P.own(j)) u_mine = u_mine + u_term<E>(x[j], P.p[j], a);
  }

  float w = 0.f, wc = 0.f;
  float wx[K], wxc[K], wx2[K], wx2c[K];
MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) wx[j] = wxc[j] = wx2[j] = wx2c[j] = 0.f;
  int evals = 0;

  const uint2 key = make_uint2(a.seed, 0u);
  const float eps = a.eps, he = 0.5f * a.eps;
  // rounded one operation at a time, as the plain version forms them
  const float eta = expf(__fmul_rn(__fmul_rn(-a.beta, eps), 0.5f));
  const float sig = sqrtf(fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(eta, eta))));
  const int m = a.m;
  const uint32_t nb = ((uint32_t)m + 2u) / 2u;  // slots of a dim's M + 1 pairs

  for (int t = 0; t < a.num_iters; ++t) {
    prof.mark(ewprof::kMaOther);
    // v0 ~ N(0, M): pair M's cosine branch; the Metropolis uniform
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) {
      float z[4];
      if (P.own(j)) malt_normals4(a, c, t, (P.i0 + j) * nb + m / 2, key, z);
      v[j] = P.own(j) ? (m & 1 ? z[2] : z[0]) * P.sm[j] : 0.f;
    }
    const float mh = a.fixed_uniform
        ? 0x1p-25f
        : philox_uniform(philox4x32_10(make_uint4(c, t, D * nb, kTagMaltPairs), key).x);
    prof.mark(ewprof::kMaRefresh);

    float xl[K], vl[K], gl[K];
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) xl[j] = x[j], vl[j] = v[j], gl[j] = g[j];
    float ul = u, delta = 0.f;
    // a separable energy: Δ's share of the lane's dims, Σ over the steps of
    // (U's terms + ½vᵀM⁻¹v after the step) − (the same before it), added
    // over the group once, after the trajectory; and U's terms at xl
    float d_mine = 0.f, ul_mine = u_mine;
    auto half = [](float s) { return E == kRoughWell ? s : 0.5f * s; };
    // one OBABO step from the normals z1 (first O) and z2 (second O) of each
    // owned dim
    auto step = [&](const float (&z1)[K], const float (&z2)[K]) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) vl[j] = eta * vl[j] + sig * (z1[j] * P.sm[j]);  // O
      if constexpr (kSeparable<E>) {  // BAB, U's terms beside the forces
        const float k_in = halfsq_own(vl, P, mass);
        float s = 0.f;
MJHMC_UNROLL_DIMS(K)
        for (int j = 0; j < K; ++j) {
          const float term = stage1_u<E>(xl[j], vl[j], gl[j], P.p[j], P.im[j], he, eps, he, a);
          if (P.own(j)) s = s + term;
        }
        prof.mark(ewprof::kMaKickGrad);
        d_mine = d_mine + ((half(s) + halfsq_own(vl, P, mass)) - (half(ul_mine) + k_in));
        ul_mine = s;
      } else {
        const float h_in = ul + grp.sum(halfsq_own(vl, P, mass));
        ul = stage_group<E, D, K, G, true>(xl, vl, gl, P, grp, he, eps, he, a);
        prof.mark(ewprof::kMaKickGrad);
        delta = delta + (ul + grp.sum(halfsq_own(vl, P, mass)) - h_in);
      }
      prof.mark(ewprof::kMaEnergy);
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) vl[j] = eta * vl[j] + sig * (z2[j] * P.sm[j]);  // O
    };
    // a block of each owned dim's pairs k and k + 1
    auto draw = [&](int k, float (&za)[K], float (&zb)[K], float (&zc)[K], float (&zd)[K]) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) {
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        if (P.own(j)) malt_normals4(a, c, t, (P.i0 + j) * nb + k / 2, key, z);
        za[j] = z[0], zb[j] = z[1], zc[j] = z[2], zd[j] = z[3];
      }
      prof.mark(ewprof::kMaDraws);
    };
    int k = 0;
    for (; k + 1 < m; k += 2) {
      float z0[K], z1[K], z2[K], z3[K];
      draw(k, z0, z1, z2, z3);
      step(z0, z1);
      step(z2, z3);
    }
    if (k < m) {
      float z0[K], z1[K], z2[K], z3[K];
      draw(k, z0, z1, z2, z3);
      step(z0, z1);
    }
    if constexpr (kSeparable<E>) {
      delta = grp.sum(d_mine);
      if (m > 0) ul = u_separable<E>(ul_mine, grp);
    }
    prof.mark(ewprof::kMaOther);

    const bool ok = fabsf(delta) < 1e30f && delta == delta;  // divergence rejects
    const bool acc = mh < accept_prob(-delta, ok);
    if (acc) {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) x[j] = xl[j], v[j] = vl[j], g[j] = gl[j];
      u = ul;
      u_mine = ul_mine;
    } else {
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j) v[j] = -v[j];
    }

    evals += m;
    kadd(w, wc, 1.f);
MJHMC_UNROLL_DIMS(K)
    for (int j = 0; j < K; ++j) {
      kadd(wx[j], wxc[j], x[j]);
      kadd(wx2[j], wx2c[j], x[j] * x[j]);
    }
    if (a.xs && (t + 1) % a.thin == 0) {
      const size_t e = t / a.thin;
MJHMC_UNROLL_DIMS(K)
      for (int j = 0; j < K; ++j)
        if (P.own(j)) a.xs[(e * D + P.i0 + j) * n + c] = x[j];
      if (grp.rank == 0) {
        a.ws[e * n + c] = 1.f;
        a.es[e * n + c] = evals;
      }
    }
    prof.mark(ewprof::kMaAccept);
  }

MJHMC_UNROLL_DIMS(K)
  for (int j = 0; j < K; ++j) {
    if (!P.own(j)) continue;
    const int i = P.i0 + j;
    a.xo[i * n + c] = x[j];
    a.vo[i * n + c] = v[j];
    a.go[i * n + c] = g[j];
    a.wx[i * n + c] = wx[j];
    a.wx2[i * n + c] = wx2[j];
  }
  if (grp.rank == 0) {
    a.uo[c] = u;
    a.hbo[c] = a.h_back[c];
    a.valido[c] = a.valid[c];
    a.w[c] = w;
    a.evals[c] = evals;
    prof.mark(ewprof::kMaOther);
    prof.store(a.prof + (size_t)c * ewprof::kMaPhases);
  }
}

}  // namespace hmc

template <int V, int D, int E, bool BR>
void (*kernel_of(bool emit))(Args) {
  if constexpr (V == kMjhmc)
    return emit ? mjhmc_kernel<D, E, true, BR> : mjhmc_kernel<D, E, false, BR>;
  // control and MALT test emission at run time (a.xs != nullptr): one
  // instance per (D, energy) serves the run and the stream
  else if constexpr (V == kControl) return hmc::control_kernel<D, E>;
  else return hmc::malt_kernel<D, E>;
}

// the SMs of the current device
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}
// threads a block of the NUTS kernel at D dims for n chains on this card:
// sized to the chains where the tree rows live on chip, one warp where they
// live in the device scratch (at D 50, blocks of 8 ran 1.3-1.5x slower
// than warps; PERF.md §6)
template <int D>
int nuts_threads(int n) {
  return D > nuts::kOnChipDims ? nuts::kBlockThreads : nuts::threads_for(n, sm_count());
}

// The NUTS instance (D, E, EMIT, BR, PROF) in blocks of nuts_threads<D>, with
// the tree rows' shared memory (or the scratch, which D > nuts::kOnChipDims
// needs)
template <int D, int E, bool EMIT, bool BR, bool PROF = false>
cudaError_t launch_nuts(const Args& a, cudaStream_t s) {
  if (D > nuts::kOnChipDims && !a.scratch) return cudaErrorInvalidValue;
  const int threads = nuts_threads<D>(a.n);
  void (*kernel)(Args) = nuts::nuts_kernel<D, E, EMIT, BR, PROF>;
  const int bytes = nuts::smem_bytes<D>(threads, a.m);
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.n + threads - 1) / threads, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// Launch an instance of the MJHMC or MALT body (V) at D dims on energy E:
// ew_lanes lanes a chain, in blocks of ew_threads_for threads
template <int V, int D, int E>
cudaError_t launch_grouped(void (*kernel)(Args), const Args& a, cudaStream_t s) {
  constexpr int lanes = ew_lanes(V, D, E);
  const int threads = ew_threads_for(lanes, a.n, sm_count());
  const long long blocks = ((long long)a.n * lanes + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, s>>>(a);
  return cudaGetLastError();
}

// Launch the instance of step body V at D dims on energy E. BR (the
// branches compiled in: a mass or the two-stage integrator for MJHMC, a
// mass for NUTS) splits the MJHMC and NUTS instances; control and MALT have
// the BR=true instance only.
template <int V, int D, int E, bool BR>
cudaError_t launch_instance(const Args& a, bool emit, cudaStream_t s) {
  if constexpr (V == kNuts) {
    return emit ? launch_nuts<D, E, true, BR>(a, s) : launch_nuts<D, E, false, BR>(a, s);
  } else {
    return launch_grouped<V, D, E>(kernel_of<V, D, E, BR>(emit), a, s);
  }
}

// The NUTS run of D dims on energy E without a mass (BR=false) or with one,
// for n chains at max_depth: out[0] threads a block, out[1] shared-memory
// bytes a block, out[2] the blocks an SM holds at once (the card's
// occupancy query, which counts registers too); compiled beside
// launch_instance<kNuts, D, E, BR>
template <int D, int E, bool BR>
cudaError_t nuts_tile(int max_depth, int n, int* out) {
  out[0] = nuts_threads<D>(n);
  out[1] = nuts::smem_bytes<D>(out[0], max_depth);
  void (*kernel)(Args) = nuts::nuts_kernel<D, E, false, BR>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[1]);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, out[0], out[1]);
}

// The PROF instance of the NUTS run of D dims on energy E without a mass:
// the phase breakdown of every chain into a.prof; nothing on the main path
// runs it
template <int D, int E>
cudaError_t launch_nuts_prof(const Args& a, cudaStream_t s) {
  return launch_nuts<D, E, false, false, true>(a, s);
}

// The PROF instance of the MJHMC (V kMjhmc; BR: the branches compiled in) or
// MALT (V kMalt) run of D dims on energy E: the phase breakdown of every
// chain into a.prof (ewprof); nothing on the main path runs it
template <int V, int D, int E, bool BR>
cudaError_t launch_ew_prof(const Args& a, cudaStream_t s) {
  static_assert(V != kNuts, "NUTS has launch_nuts_prof");
  if constexpr (V == kMjhmc) {
    return launch_grouped<V, D, E>(mjhmc_kernel<D, E, false, BR, true>, a, s);
  } else if constexpr (V == kControl) {
    return launch_grouped<V, D, E>(hmc::control_kernel<D, E, true>, a, s);
  } else {
    return launch_grouped<V, D, E>(hmc::malt_kernel<D, E, true>, a, s);
  }
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
extern template cudaError_t nuts_tile<50, kRoughWell, false>(int, int, int*);
// nuts_engine_d50_rough_well_mass.cu
extern template Launch launch_instance<kNuts, 50, kRoughWell, true>;
extern template cudaError_t nuts_tile<50, kRoughWell, true>(int, int, int*);
// nuts_engine_d50_gaussian.cu
extern template Launch launch_instance<kNuts, 50, kGaussian, false>;
extern template cudaError_t nuts_tile<50, kGaussian, false>(int, int, int*);
// nuts_engine_d50_gaussian_mass.cu
extern template Launch launch_instance<kNuts, 50, kGaussian, true>;
extern template cudaError_t nuts_tile<50, kGaussian, true>(int, int, int*);
// nuts_engine_d50_*_emit.cu: the emitting kernel (the stream's) of each
// D=50 NUTS instance above, compiled by an nvcc of its own so that no source
// holds two D=50 NUTS kernels (one took ~140 s of cicc and ptxas alone)
extern template cudaError_t launch_nuts<50, kRoughWell, true, false>(const Args&, cudaStream_t);
extern template cudaError_t launch_nuts<50, kRoughWell, true, true>(const Args&, cudaStream_t);
extern template cudaError_t launch_nuts<50, kGaussian, true, false>(const Args&, cudaStream_t);
extern template cudaError_t launch_nuts<50, kGaussian, true, true>(const Args&, cudaStream_t);
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
extern template cudaError_t nuts_tile<10, kFunnel, false>(int, int, int*);
extern template Launch launch_instance<kNuts, 10, kFunnel, true>;
extern template cudaError_t nuts_tile<10, kFunnel, true>(int, int, int*);
// zoo_engine_banana_mog.cu (the banana and mog presets' D)
extern template Launch launch_instance<kMjhmc, 2, kBanana, false>;
extern template Launch launch_instance<kMjhmc, 2, kBanana, true>;
extern template Launch launch_instance<kNuts, 2, kBanana, false>;
extern template cudaError_t nuts_tile<2, kBanana, false>(int, int, int*);
extern template Launch launch_instance<kNuts, 2, kBanana, true>;
extern template cudaError_t nuts_tile<2, kBanana, true>(int, int, int*);
extern template Launch launch_instance<kControl, 2, kBanana, true>;
extern template Launch launch_instance<kMalt, 2, kBanana, true>;
extern template Launch launch_instance<kMjhmc, 1, kMog, false>;
extern template Launch launch_instance<kMjhmc, 1, kMog, true>;
extern template Launch launch_instance<kNuts, 1, kMog, false>;
extern template cudaError_t nuts_tile<1, kMog, false>(int, int, int*);
extern template Launch launch_instance<kNuts, 1, kMog, true>;
extern template cudaError_t nuts_tile<1, kMog, true>(int, int, int*);
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
extern template cudaError_t nuts_tile<10, kEightSchoolsCentered, false>(int, int, int*);
extern template Launch launch_instance<kNuts, 10, kEightSchoolsCentered, true>;
extern template cudaError_t nuts_tile<10, kEightSchoolsCentered, true>(int, int, int*);
// zoo_nuts_eight_schools_noncentered.cu
extern template Launch launch_instance<kNuts, 10, kEightSchoolsNoncentered, false>;
extern template cudaError_t nuts_tile<10, kEightSchoolsNoncentered, false>(int, int, int*);
extern template Launch launch_instance<kNuts, 10, kEightSchoolsNoncentered, true>;
extern template cudaError_t nuts_tile<10, kEightSchoolsNoncentered, true>(int, int, int*);
// nuts_engine_prof.cu: the PROF instances (gauss2d and the funnel)
extern template cudaError_t launch_nuts_prof<2, kGaussian>(const Args&, cudaStream_t);
extern template cudaError_t launch_nuts_prof<10, kFunnel>(const Args&, cudaStream_t);
// ew_engine_prof.cu: the MJHMC and MALT PROF instances (rough well D 2, the
// funnel)
using ProfLaunch = cudaError_t(const Args&, cudaStream_t);
extern template ProfLaunch launch_ew_prof<kMjhmc, 2, kRoughWell, false>;
extern template ProfLaunch launch_ew_prof<kMalt, 2, kRoughWell, true>;
extern template ProfLaunch launch_ew_prof<kMjhmc, 10, kFunnel, false>;
extern template ProfLaunch launch_ew_prof<kMalt, 10, kFunnel, true>;
extern template ProfLaunch launch_ew_prof<kControl, 2, kRoughWell, true>;
extern template ProfLaunch launch_ew_prof<kControl, 10, kFunnel, true>;
// ew_engine_prof_d50.cu: MJHMC and control with the branches on gauss50d
extern template ProfLaunch launch_ew_prof<kMjhmc, 50, kGaussian, true>;
extern template ProfLaunch launch_ew_prof<kControl, 50, kGaussian, true>;

}  // namespace mjhmc
