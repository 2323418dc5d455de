// One on-demand instance of the elementwise engine (mjhmc_engine.cuh): step
// body MJHMC_OD_VARIANT (a Variant) on energy MJHMC_OD_ENERGY (an Energy) at
// MJHMC_OD_DIMS dims, a mixture's components capped at
// MJHMC_MOG_MAX_COMPONENTS, each macro given with -D. ops/_build.py
// (load_instance) compiles this source, with the library's flags, the first
// time a (body, energy, D) the library has no instance for is launched, as
// a Pallas kernel is traced at the shape it is called at: MJHMC's and NUTS's
// instances with and without the branches, run and stream; control's and
// MALT's one each. Its C entries take the library's arguments and refuse
// another body, energy or D: mjhmc_od_launch is mjhmc_engine_launch,
// mjhmc_od_ew_tile mjhmc_ew_tile and mjhmc_od_nuts_tile mjhmc_nuts_tile
// (mjhmc_engine.cu).
#if !defined(MJHMC_OD_VARIANT) || !defined(MJHMC_OD_ENERGY) || !defined(MJHMC_OD_DIMS)
#error "an on-demand instance needs -DMJHMC_OD_VARIANT, -DMJHMC_OD_ENERGY and -DMJHMC_OD_DIMS"
#endif

// Past MJHMC_OD_UNROLL_DIMS dims a loop is left rolled and its arrays live
// in local memory (mjhmc_engine.cuh, MJHMC_UNROLL_DIMS): NUTS at D 128 with
// every loop unrolled took 1,144 s of nvcc, 255 registers and 43 KB of
// spill stores; rolled, 7 s and 60-64 registers (chip_smoke.py phase 42's
// build report, on the 8-core host of an NVIDIA H100 80GB HBM3 at 700 W).
// Below it, or where a lane's share of the dims is below it (a separable
// energy's group), the loops unroll as the library's do.
#define MJHMC_OD_UNROLL_DIMS 16
#if MJHMC_OD_DIMS > MJHMC_OD_UNROLL_DIMS
#define MJHMC_OD_PRAGMA(x) _Pragma(#x)
#define MJHMC_OD_EXPANDED_PRAGMA(x) MJHMC_OD_PRAGMA(x)
#define MJHMC_UNROLL_DIMS(K) \
  MJHMC_OD_EXPANDED_PRAGMA(unroll((K) > MJHMC_OD_UNROLL_DIMS ? 1 : (K)))
#endif

#include "../mjhmc_engine.cuh"

namespace mjhmc {
namespace ondemand {

constexpr int kV = MJHMC_OD_VARIANT, kE = MJHMC_OD_ENERGY, kD = MJHMC_OD_DIMS;
static_assert(kV >= kMjhmc && kV <= kMalt, "a step body");
static_assert(kE >= kRoughWell && kE <= kEightSchoolsNoncentered, "an elementwise energy");
static_assert(kD >= 1, "a state of at least one dim");

// the instance itself: MJHMC and NUTS take the fast path (BR=false) without
// a mass or the two-stage integrator, as launch_shape does
cudaError_t launch(const Args& a, bool emit, cudaStream_t s) {
  const bool fast = a.mass == nullptr && !a.two_stage;
  if constexpr (kV == kMjhmc || kV == kNuts)
    return fast ? launch_instance<kV, kD, kE, false>(a, emit, s)
                : launch_instance<kV, kD, kE, true>(a, emit, s);
  else
    return launch_instance<kV, kD, kE, true>(a, emit, s);
}

}  // namespace ondemand
}  // namespace mjhmc

// mjhmc_engine_launch's contract for this instance's (variant, ndims,
// energy) only; k0 of a mixture (its components) at most
// kMogMaxComponents
extern "C" int mjhmc_od_launch(
    int variant, int ndims, int energy, const float* params, float k0, float k1,
    float k2, float k3, float k4, const float* mass, int two_stage, float* scratch,
    const float* x,
    const float* v, const float* g, const float* u, const float* h_back,
    const float* valid, float* xo, float* vo, float* go, float* uo, float* hbo,
    float* valido, float* w, float* wx, float* wx2, int* evals, float* xs, float* ws,
    int* es, int n, int num_iters, int thin, int m, unsigned int seed, float eps,
    float beta, int fixed_uniform, void* stream) {
  using namespace mjhmc;
  if (variant != ondemand::kV || energy != ondemand::kE || ndims != ondemand::kD || n <= 0 ||
      thin <= 0 || (variant == kNuts && (m < 1 || m > nuts::kMaxDepth)) ||
      (two_stage && (variant == kNuts || variant == kMalt)) ||
      (energy == kMog && !(k0 >= 1.f && k0 <= kMogMaxComponents)))
    return cudaErrorInvalidValue;
  Args a{params, k0, k1, k2, k3, k4, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage, scratch,
         nullptr};
  return ondemand::launch(a, xs != nullptr, static_cast<cudaStream_t>(stream));
}

// mjhmc_ew_tile of this instance (MJHMC, control or MALT)
extern "C" int mjhmc_od_ew_tile(int variant, int ndims, int energy, int n, int* out) {
  using namespace mjhmc;
  if (variant != ondemand::kV || energy != ondemand::kE || ndims != ondemand::kD ||
      variant == kNuts || n <= 0)
    return cudaErrorInvalidValue;
  out[0] = ew_lanes(variant, ndims, energy);
  out[1] = ew_threads_for(out[0], n, sm_count());
  return cudaSuccess;
}

// mjhmc_nuts_tile of this instance (NUTS)
extern "C" int mjhmc_od_nuts_tile(int ndims, int energy, int mass, int max_depth, int n,
                                  int* out) {
  using namespace mjhmc;
  if constexpr (ondemand::kV == kNuts) {
    if (energy != ondemand::kE || ndims != ondemand::kD || max_depth < 1 ||
        max_depth > nuts::kMaxDepth || n <= 0)
      return cudaErrorInvalidValue;
    return mass ? nuts_tile<ondemand::kD, ondemand::kE, true>(max_depth, n, out)
                : nuts_tile<ondemand::kD, ondemand::kE, false>(max_depth, n, out);
  } else {
    return cudaErrorInvalidValue;
  }
}
