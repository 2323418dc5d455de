// Fused MJHMC, control HMC, MALT and NUTS engines for the matmul energies: the
// C entries, the product-of-t MJHMC, control and MALT instances at full f32
// (launch and tile query, Instance) and the stubbed product-of-t run. The kernels are
// templates in mjhmc_mm_engine.cuh, which says what they replace and lists the
// sources of the other instances.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kProductOfT, kHighest, kMjhmc>();
template Instance body_instance<kProductOfT, kHighest, kControl>();
template Instance body_instance<kProductOfT, kHighest, kMalt>();

// step body `variant` of energy E at precision P
template <int E, int P>
Instance body_of(int variant) {
  switch (variant) {
    case kMjhmc: return body_instance<E, P, kMjhmc>();
    case kNuts: return body_instance<E, P, kNuts>();
    case kControl: return body_instance<E, P, kControl>();
    case kMalt: return body_instance<E, P, kMalt>();
    default: return {};
  }
}

// the instance of (energy E, precision, body), null where none is compiled:
// every body at kHighest and at the preset's JAX default, the MJHMC body
// (the sweep's run) at the other two
template <int E>
Instance launcher(int precision, int variant) {
  constexpr int kJaxDefault = E == kSparseCoding ? kBf16x3 : kDefault;
  if (precision == kHighest) return body_of<E, kHighest>(variant);
  if (precision == kJaxDefault) return body_of<E, kJaxDefault>(variant);
  if (variant != kMjhmc) return {};
  if constexpr (E == kProductOfT) {
    if (precision == kBf16x3) return sweep_instance<E, kBf16x3>();
    if (precision == kBf16x2) return sweep_instance<E, kBf16x2>();
  } else if constexpr (E == kSparseCoding) {
    if (precision == kBf16x2) return sweep_instance<E, kBf16x2>();
    if (precision == kDefault) return sweep_instance<E, kDefault>();
  }
  return {};
}

}  // namespace mm
}  // namespace mjhmc

// Plain C entry for ctypes. variant 0 runs MJHMC, 1 NUTS (m is max_depth,
// 1..nuts::kMaxDepth, past nuts::kTileDepth on the DEEP instance; beta
// unused), 2 control HMC (beta is the corruption fraction), 3 MALT
// (beta is the friction gamma); precision 0 full f32 (FP32 FMA), 1 bf16x3,
// 2 bf16x2, 3 one bf16 pass (tensor cores); mass is (2, ndims) (M^-1,
// sqrt(M)) or NULL; two_stage != 0 takes the two-stage integrator (MJHMC
// and control); scratch is NUTS's device buffer (cuda_mjhmc.nuts_scratch).
// xs/ws/es == NULL runs without emissions; stub != 0 runs the stub_dots
// ablation (no contraction, so no precision). Instances: product of t (d,
// k) = (36, 36), sparse coding (d, p) = (128, 64) and logistic regression
// (d, nobs) = (16, 256), the presets' shapes, at the precisions the header
// lists, and the stubbed product-of-t MJHMC run (the roofline dossier's
// ablation row). Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an instance that is not compiled.
extern "C" int mjhmc_mm_engine_launch(
    int energy, int ndims, int krows, int stub, int variant, int precision, const float* p0,
    const float* p1, float k0, float k1, float k2, float k3, const float* mass,
    int two_stage, float* scratch, const float* x, const float* v, const float* g,
    const float* u, const float* h_back, const float* valid, float* xo, float* vo,
    float* go, float* uo, float* hbo, float* valido, float* w, float* wx, float* wx2,
    int* evals, float* xs, float* ws, int* es, int n, int num_iters, int thin, int m,
    unsigned int seed, float eps, float beta, int fixed_uniform, void* stream) {
  using namespace mjhmc::mm;
  if (n <= 0 || thin <= 0 || m <= 0 || (two_stage && variant == kMalt) ||
      (variant == kNuts && (two_stage || m > nuts::kMaxDepth)))
    return cudaErrorInvalidValue;
  Args a{p0, p1, k0, k1, k2, k3, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage,
         scratch};
  const bool emit = xs != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stub)
    return energy != kProductOfT || ndims != 36 || krows != 36 || emit || variant != kMjhmc ||
                   mass || two_stage
               ? cudaErrorInvalidValue
               : launch<kProductOfT, 36, 36, kMjhmc, false, true, false, kHighest>(a, s);
  Instance in;
  if (energy == kProductOfT && ndims == 36 && krows == 36)
    in = launcher<kProductOfT>(precision, variant);
  else if (energy == kSparseCoding && ndims == 128 && krows == 64 && p1 != nullptr)
    in = launcher<kSparseCoding>(precision, variant);
  else if (energy == kLogreg && ndims == 16 && krows == 256)
    in = launcher<kLogreg>(precision, variant);
  return in.launch ? in.launch(a, emit, s) : cudaErrorInvalidValue;
}

// The NUTS run's PROF instance: mjhmc_mm_engine_launch's arguments (variant
// NUTS, the preset's JAX default precision, no mass, no emissions), then
// prof, (blocks, 2, nuts::kPhases) cycles and leaf steps (mjhmc_mm_engine.cuh,
// nuts::Prof). Nothing on the main path calls it.
extern "C" int mjhmc_mm_nuts_profile(
    int energy, int ndims, int krows, int stub, int variant, int precision, const float* p0,
    const float* p1, float k0, float k1, float k2, float k3, const float* mass,
    int two_stage, float* scratch, const float* x, const float* v, const float* g,
    const float* u, const float* h_back, const float* valid, float* xo, float* vo,
    float* go, float* uo, float* hbo, float* valido, float* w, float* wx, float* wx2,
    int* evals, float* xs, float* ws, int* es, int n, int num_iters, int thin, int m,
    unsigned int seed, float eps, float beta, int fixed_uniform, void* stream,
    unsigned long long* prof) {
  using namespace mjhmc::mm;
  if (n <= 0 || m <= 0 || m > nuts::kTileDepth || stub || variant != kNuts || mass ||
      two_stage || xs || !prof)
    return cudaErrorInvalidValue;
  Args a{p0, p1, k0, k1, k2, k3, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage,
         scratch, prof};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy == kProductOfT && ndims == 36 && krows == 36 && precision == kDefault)
    return launch_nuts_prof<kProductOfT, kDefault>(a, s);
  if (energy == kSparseCoding && ndims == 128 && krows == 64 && precision == kBf16x3)
    return launch_nuts_prof<kSparseCoding, kBf16x3>(a, s);
  if (energy == kLogreg && ndims == 16 && krows == 256 && precision == kDefault)
    return launch_nuts_prof<kLogreg, kDefault>(a, s);
  return cudaErrorInvalidValue;
}

// The tile of the NUTS instances of (energy, precision) at max_depth: out[0]
// chains a block, out[1] threads a block, out[2] shared-memory bytes a
// block, out[3] blocks an SM holds at once (the run without a mass; past
// nuts::kTileDepth the DEEP run), then the device buffer:
// out[4] floats of a block's slice, out[5] the parameter matrix's, out[6]
// the tree state's a chain, out[7] a block's span slots (mjhmc_mm_engine.cuh,
// nuts_tile_at).
// Returns cudaErrorInvalidValue where no such instance is compiled.
extern "C" int mjhmc_mm_nuts_tile(int energy, int precision, int max_depth, int* out) {
  using namespace mjhmc::mm;
  const bool hi = precision == kHighest;
  if (max_depth < 1 || max_depth > nuts::kMaxDepth) return cudaErrorInvalidValue;
  if (energy == kProductOfT && (hi || precision == kDefault))
    return hi ? nuts_tile<kProductOfT, kHighest>(max_depth, out)
              : nuts_tile<kProductOfT, kDefault>(max_depth, out);
  if (energy == kSparseCoding && (hi || precision == kBf16x3))
    return hi ? nuts_tile<kSparseCoding, kHighest>(max_depth, out)
              : nuts_tile<kSparseCoding, kBf16x3>(max_depth, out);
  if (energy == kLogreg && (hi || precision == kDefault))
    return hi ? nuts_tile<kLogreg, kHighest>(max_depth, out)
              : nuts_tile<kLogreg, kDefault>(max_depth, out);
  return cudaErrorInvalidValue;
}

// The tile of mm_kernel's run of (energy, precision, variant 0 MJHMC, 2
// control, 3 MALT), with the branches where br != 0 (control and MALT have
// only those): out[0] chains a block, out[1] threads a block, out[2]
// shared-memory bytes a block, out[3] blocks an SM holds at once, out[4..6]
// the device buffer (mjhmc_mm_engine.cuh, tile_of). Returns
// cudaErrorInvalidValue where no such instance is compiled.
extern "C" int mjhmc_mm_tile(int energy, int precision, int variant, int br, int* out) {
  using namespace mjhmc::mm;
  const Instance in = energy == kProductOfT     ? launcher<kProductOfT>(precision, variant)
                      : energy == kSparseCoding ? launcher<kSparseCoding>(precision, variant)
                      : energy == kLogreg       ? launcher<kLogreg>(precision, variant)
                                                : Instance{};
  return in.tile ? in.tile(br != 0, out) : cudaErrorInvalidValue;
}

// mm_kernel's PROF instances: mjhmc_mm_engine_launch's arguments (MJHMC or
// MALT at the preset's JAX default precision, MJHMC without the branches,
// no emissions), then prof, (blocks, 2, kMmPhases) cycles and gradients
// (mjhmc_mm_engine.cuh, MmPhase): MJHMC and MALT on sparse coding at
// bf16x3, MALT on logreg at one bf16 pass. Nothing on the main path calls
// it.
extern "C" int mjhmc_mm_profile(
    int energy, int ndims, int krows, int stub, int variant, int precision, const float* p0,
    const float* p1, float k0, float k1, float k2, float k3, const float* mass,
    int two_stage, float* scratch, const float* x, const float* v, const float* g,
    const float* u, const float* h_back, const float* valid, float* xo, float* vo,
    float* go, float* uo, float* hbo, float* valido, float* w, float* wx, float* wx2,
    int* evals, float* xs, float* ws, int* es, int n, int num_iters, int thin, int m,
    unsigned int seed, float eps, float beta, int fixed_uniform, void* stream,
    unsigned long long* prof) {
  using namespace mjhmc::mm;
  if (n <= 0 || m <= 0 || thin <= 0 || stub || two_stage || xs || !prof) return cudaErrorInvalidValue;
  Args a{p0, p1, k0, k1, k2, k3, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage,
         scratch, prof};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy == kSparseCoding && ndims == 128 && krows == 64 && p1 && precision == kBf16x3) {
    if (variant == kMjhmc) return launch_mm_prof<kSparseCoding, kBf16x3, kMjhmc>(a, s);
    if (variant == kMalt) return launch_mm_prof<kSparseCoding, kBf16x3, kMalt>(a, s);
  }
  if (energy == kLogreg && ndims == 16 && krows == 256 && precision == kDefault &&
      variant == kMalt)
    return launch_mm_prof<kLogreg, kDefault, kMalt>(a, s);
  return cudaErrorInvalidValue;
}
