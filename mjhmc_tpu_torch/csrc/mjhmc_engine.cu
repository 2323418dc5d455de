// Fused MJHMC, NUTS, control HMC and MALT engines for the elementwise
// energies: the C entry and the D=2 rough-well and Gaussian instances. The
// kernels are templates in mjhmc_engine.cuh, which says what each replaces;
// the D=50 and zoo instances are compiled in sources of their own.
#include "mjhmc_engine.cuh"

namespace mjhmc {

// launch (variant, D, E); MJHMC and NUTS without a mass or the two-stage
// integrator take their fast-path instances (BR=false)
template <int D, int E>
cudaError_t launch_shape(int variant, const Args& a, bool emit, cudaStream_t s) {
  const bool fast = a.mass == nullptr && !a.two_stage;
  switch (variant) {
    case kMjhmc:
      return fast ? launch_instance<kMjhmc, D, E, false>(a, emit, s)
                  : launch_instance<kMjhmc, D, E, true>(a, emit, s);
    case kNuts:
      return fast ? launch_instance<kNuts, D, E, false>(a, emit, s)
                  : launch_instance<kNuts, D, E, true>(a, emit, s);
    case kControl: return launch_instance<kControl, D, E, true>(a, emit, s);
    case kMalt: return launch_instance<kMalt, D, E, true>(a, emit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mjhmc

// Plain C entry for ctypes. variant 0 runs MJHMC (m is M), 1 runs NUTS (m is
// max_depth, 1..nuts::kMaxDepth; beta is unused; the input v is returned as
// is when num_iters is 0), 2 control HMC (beta is the corruption fraction),
// 3 MALT (beta is the friction gamma). energy is an Energy id at a D the
// library is compiled for, the presets': rough well and Gaussian at 2 and
// 50, funnel 10, banana 2, mog 1 (k0 components, 1..kMogMaxComponents),
// eight schools 10 (both forms); every other D has its on-demand instance
// (ondemand/ew_instance.cu, mjhmc_od_launch). mass is (2, ndims) (M^-1, sqrt(M)) or NULL; two_stage != 0 takes
// the two-stage integrator (MJHMC and control only); scratch is NUTS's
// (nuts::rows(m), ndims, n) tree rows at ndims > nuts::kOnChipDims (else
// NULL).
// xs/ws/es == NULL runs without emissions. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int mjhmc_engine_launch(
    int variant, int ndims, int energy, const float* params, float k0, float k1,
    float k2, float k3, float k4, const float* mass, int two_stage, float* scratch,
    const float* x,
    const float* v, const float* g, const float* u, const float* h_back,
    const float* valid, float* xo, float* vo, float* go, float* uo, float* hbo,
    float* valido, float* w, float* wx, float* wx2, int* evals, float* xs, float* ws,
    int* es, int n, int num_iters, int thin, int m, unsigned int seed, float eps,
    float beta, int fixed_uniform, void* stream) {
  using namespace mjhmc;
  if (n <= 0 || thin <= 0 || variant < kMjhmc || variant > kMalt ||
      (variant == kNuts && (m < 1 || m > nuts::kMaxDepth)) ||
      (two_stage && (variant == kNuts || variant == kMalt)))
    return cudaErrorInvalidValue;
  Args a{params, k0, k1, k2, k3, k4, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage, scratch,
         nullptr};
  const bool emit = xs != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (energy) {
    case kRoughWell:
      if (ndims == 2) return launch_shape<2, kRoughWell>(variant, a, emit, s);
      if (ndims == 50) return launch_shape<50, kRoughWell>(variant, a, emit, s);
      break;
    case kGaussian:
      if (ndims == 2) return launch_shape<2, kGaussian>(variant, a, emit, s);
      if (ndims == 50) return launch_shape<50, kGaussian>(variant, a, emit, s);
      break;
    case kFunnel:
      if (ndims == 10) return launch_shape<10, kFunnel>(variant, a, emit, s);
      break;
    case kBanana:
      if (ndims == 2) return launch_shape<2, kBanana>(variant, a, emit, s);
      break;
    case kMog:
      if (ndims == 1 && k0 >= 1.f && k0 <= kMogMaxComponents)
        return launch_shape<1, kMog>(variant, a, emit, s);
      break;
    case kEightSchoolsCentered:
      if (ndims == 10) return launch_shape<10, kEightSchoolsCentered>(variant, a, emit, s);
      break;
    case kEightSchoolsNoncentered:
      if (ndims == 10) return launch_shape<10, kEightSchoolsNoncentered>(variant, a, emit, s);
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

// The NUTS run's PROF instance: mjhmc_engine_launch's arguments (variant
// NUTS, gauss2d (Gaussian, ndims 2) or the funnel (ndims 10), no mass, no
// emissions), then prof, (n, nuts::kPhases) cycles and counters of each
// chain (mjhmc_engine.cuh, nuts::Phase), in the main path's blocks. Nothing
// on the main path calls it.
extern "C" int mjhmc_nuts_profile(
    int variant, int ndims, int energy, const float* params, float k0, float k1,
    float k2, float k3, float k4, const float* mass, int two_stage, float* scratch,
    const float* x,
    const float* v, const float* g, const float* u, const float* h_back,
    const float* valid, float* xo, float* vo, float* go, float* uo, float* hbo,
    float* valido, float* w, float* wx, float* wx2, int* evals, float* xs, float* ws,
    int* es, int n, int num_iters, int thin, int m, unsigned int seed, float eps,
    float beta, int fixed_uniform, void* stream, unsigned long long* prof) {
  using namespace mjhmc;
  if (n <= 0 || thin <= 0 || variant != kNuts || m < 1 || m > nuts::kMaxDepth || mass ||
      two_stage || xs || !prof)
    return cudaErrorInvalidValue;
  Args a{params, k0, k1, k2, k3, k4, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage, scratch,
         prof};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy == kGaussian && ndims == 2) return launch_nuts_prof<2, kGaussian>(a, s);
  if (energy == kFunnel && ndims == 10) return launch_nuts_prof<10, kFunnel>(a, s);
  return cudaErrorInvalidValue;
}

// The MJHMC (variant 0), control (2) or MALT (3) run's PROF instance:
// mjhmc_engine_launch's arguments (the rough well at ndims 2 or the funnel,
// without a mass; MJHMC and control with the branches on the Gaussian at
// ndims 50, a mass given; no emissions, no two-stage integrator), then prof,
// (n, ewprof::kMjPhases, kCoPhases or kMaPhases) cycles and counters of each
// chain (mjhmc_engine.cuh, ewprof), in the main path's blocks. Nothing on
// the main path calls it.
extern "C" int mjhmc_ew_profile(
    int variant, int ndims, int energy, const float* params, float k0, float k1,
    float k2, float k3, float k4, const float* mass, int two_stage, float* scratch,
    const float* x,
    const float* v, const float* g, const float* u, const float* h_back,
    const float* valid, float* xo, float* vo, float* go, float* uo, float* hbo,
    float* valido, float* w, float* wx, float* wx2, int* evals, float* xs, float* ws,
    int* es, int n, int num_iters, int thin, int m, unsigned int seed, float eps,
    float beta, int fixed_uniform, void* stream, unsigned long long* prof) {
  using namespace mjhmc;
  if (n <= 0 || thin <= 0 || (variant != kMjhmc && variant != kControl && variant != kMalt) ||
      two_stage || xs || !prof)
    return cudaErrorInvalidValue;
  Args a{params, k0, k1, k2, k3, k4, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage, scratch,
         prof};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy == kRoughWell && ndims == 2 && !mass)
    return variant == kMjhmc     ? launch_ew_prof<kMjhmc, 2, kRoughWell, false>(a, s)
           : variant == kControl ? launch_ew_prof<kControl, 2, kRoughWell, true>(a, s)
                                 : launch_ew_prof<kMalt, 2, kRoughWell, true>(a, s);
  if (energy == kFunnel && ndims == 10 && !mass)
    return variant == kMjhmc     ? launch_ew_prof<kMjhmc, 10, kFunnel, false>(a, s)
           : variant == kControl ? launch_ew_prof<kControl, 10, kFunnel, true>(a, s)
                                 : launch_ew_prof<kMalt, 10, kFunnel, true>(a, s);
  if (energy == kGaussian && ndims == 50 && mass && variant != kMalt)
    return variant == kMjhmc ? launch_ew_prof<kMjhmc, 50, kGaussian, true>(a, s)
                             : launch_ew_prof<kControl, 50, kGaussian, true>(a, s);
  return cudaErrorInvalidValue;
}

namespace mjhmc {
// sinf, cosf and sincosf's two results of each x (the rough well's force and
// energy share one sincosf)
__global__ void sincos_probe(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s, c;
  sincosf(x[i], &s, &c);
  out[i] = sinf(x[i]);
  out[n + i] = cosf(x[i]);
  out[2 * n + i] = s;
  out[3 * n + i] = c;
}
}  // namespace mjhmc

// sinf(x), cosf(x) and sincosf(x) of n floats into out, (4, n): whether the
// shared range reduction gives the separate functions' bits. Returns
// cudaGetLastError() after the launch.
extern "C" int mjhmc_sincos_probe(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  mjhmc::sincos_probe<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return cudaGetLastError();
}

// The grouping of the MJHMC (variant 0), control (2) or MALT (3) body on
// energy at ndims for n chains: out[0] lanes a chain (ew_lanes), out[1]
// threads a block (ew_threads_for on this card). Returns
// cudaErrorInvalidValue for NUTS.
extern "C" int mjhmc_ew_tile(int variant, int ndims, int energy, int n, int* out) {
  using namespace mjhmc;
  if (variant < kMjhmc || variant > kMalt || variant == kNuts || n <= 0)
    return cudaErrorInvalidValue;
  out[0] = ew_lanes(variant, ndims, energy);
  out[1] = ew_threads_for(out[0], n, sm_count());
  return cudaSuccess;
}

// The tile of the NUTS run of (ndims, energy) without a mass (mass == 0) or
// with one, for n chains at max_depth: out[0] threads a block, out[1]
// shared-memory bytes a block, out[2] blocks an SM holds at once. Returns
// cudaErrorInvalidValue where no such instance is compiled.
extern "C" int mjhmc_nuts_tile(int ndims, int energy, int mass, int max_depth, int n, int* out) {
  using namespace mjhmc;
  if (max_depth < 1 || max_depth > nuts::kMaxDepth || n <= 0) return cudaErrorInvalidValue;
  const bool m = mass != 0;
  switch (energy) {
    case kRoughWell:
      if (ndims == 2) return m ? nuts_tile<2, kRoughWell, true>(max_depth, n, out)
                               : nuts_tile<2, kRoughWell, false>(max_depth, n, out);
      if (ndims == 50) return m ? nuts_tile<50, kRoughWell, true>(max_depth, n, out)
                                : nuts_tile<50, kRoughWell, false>(max_depth, n, out);
      break;
    case kGaussian:
      if (ndims == 2) return m ? nuts_tile<2, kGaussian, true>(max_depth, n, out)
                               : nuts_tile<2, kGaussian, false>(max_depth, n, out);
      if (ndims == 50) return m ? nuts_tile<50, kGaussian, true>(max_depth, n, out)
                                : nuts_tile<50, kGaussian, false>(max_depth, n, out);
      break;
    case kFunnel:
      if (ndims == 10) return m ? nuts_tile<10, kFunnel, true>(max_depth, n, out)
                                : nuts_tile<10, kFunnel, false>(max_depth, n, out);
      break;
    case kBanana:
      if (ndims == 2) return m ? nuts_tile<2, kBanana, true>(max_depth, n, out)
                               : nuts_tile<2, kBanana, false>(max_depth, n, out);
      break;
    case kMog:
      if (ndims == 1) return m ? nuts_tile<1, kMog, true>(max_depth, n, out)
                               : nuts_tile<1, kMog, false>(max_depth, n, out);
      break;
    case kEightSchoolsCentered:
      if (ndims == 10) return m ? nuts_tile<10, kEightSchoolsCentered, true>(max_depth, n, out)
                                : nuts_tile<10, kEightSchoolsCentered, false>(max_depth, n, out);
      break;
    case kEightSchoolsNoncentered:
      if (ndims == 10)
        return m ? nuts_tile<10, kEightSchoolsNoncentered, true>(max_depth, n, out)
                 : nuts_tile<10, kEightSchoolsNoncentered, false>(max_depth, n, out);
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
}
