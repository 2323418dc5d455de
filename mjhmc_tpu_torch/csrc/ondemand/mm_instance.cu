// One on-demand instance of the matmul engine (mjhmc_mm_engine.cuh): step
// body MJHMC_MM_OD_VARIANT (a Variant) on energy MJHMC_MM_OD_ENERGY (an
// Energy) at MJHMC_MM_OD_DIMS state dims and MJHMC_MM_OD_KROWS rows of the
// intermediate, dot precision MJHMC_MM_OD_PRECISION (a Precision), the
// parameter matrix in a device buffer where MJHMC_MM_OD_OFFCHIP is 1, each
// macro given with -D; a chunked tile (TileRule::kc > 0) also names its
// chunk rows MJHMC_MM_OD_CHUNK and its X/G mode MJHMC_MM_OD_XG. ops/_build.py (load_instance) compiles this source,
// with the library's flags, the first time a (body, energy, d, k,
// precision) the library has no instance for is launched, as a Pallas
// kernel is traced at the shape it is called at: MJHMC's and NUTS's
// instances with and without the branches, run and stream; control's and
// MALT's one each, and NUTS's DEEP run and stream (trees past
// nuts::kTileDepth). The tile rule (TileRule) picks the tile and whether the
// parameter matrix fits on chip; the macro states the mode the wrappers'
// mirror (cuda_mjhmc.mm_tile_rule, nuts_mm_tile_rule) expects (and the
// chunk and the X/G mode), and a build whose rule disagrees fails. Its C entries take the library's arguments
// and refuse another key: mjhmc_mm_od_launch is mjhmc_mm_engine_launch,
// mjhmc_mm_od_tile mjhmc_mm_tile and mjhmc_mm_od_nuts_tile
// mjhmc_mm_nuts_tile (mjhmc_mm_engine.cu). An OFF instance reads the
// parameter matrix from the head of `scratch`, which the wrapper allocates
// (Params::kFloats floats, then NUTS's tree state where it is off chip).
#if !defined(MJHMC_MM_OD_VARIANT) || !defined(MJHMC_MM_OD_ENERGY) ||  \
    !defined(MJHMC_MM_OD_DIMS) || !defined(MJHMC_MM_OD_KROWS) ||      \
    !defined(MJHMC_MM_OD_PRECISION) || !defined(MJHMC_MM_OD_OFFCHIP)
#error "an on-demand matmul instance needs its six -DMJHMC_MM_OD_* macros"
#endif

// Where X and G live in the device buffer (MJHMC_MM_OD_XG 1: d in the
// thousands, 1,024 threads a block at 64 registers, so an owner's arrays
// spill either way), loops over more than 4 of an owner's elements, or of
// a column's partials, are left rolled (mjhmc_mm_engine.cuh,
// MJHMC_MM_UNROLL_OWNED), which keeps the instance's nvcc short.
#if defined(MJHMC_MM_OD_XG) && MJHMC_MM_OD_XG
#define MJHMC_MM_OD_PRAGMA(x) _Pragma(#x)
#define MJHMC_MM_OD_EXPANDED_PRAGMA(x) MJHMC_MM_OD_PRAGMA(x)
#define MJHMC_MM_UNROLL_OWNED(K) MJHMC_MM_OD_EXPANDED_PRAGMA(unroll((K) > 4 ? 1 : (K)))
#endif

#include "../mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {
namespace ondemand {

constexpr int kV = MJHMC_MM_OD_VARIANT, kE = MJHMC_MM_OD_ENERGY, kD = MJHMC_MM_OD_DIMS,
              kK = MJHMC_MM_OD_KROWS, kP = MJHMC_MM_OD_PRECISION;
constexpr bool kOff = MJHMC_MM_OD_OFFCHIP != 0;
static_assert(kV >= kMjhmc && kV <= kMalt, "a step body");
static_assert(kE >= kProductOfT && kE <= kLogreg, "a matmul energy");
static_assert(kD >= 1 && kK >= 1, "a state and an intermediate of at least one row");
static_assert(kP >= kHighest && kP <= kDefault, "a dot precision");
constexpr TileRule kRule = kV == kNuts ? nuts_rule(kE, kP, kD, kK) : mm_rule(kE, kV, kP, kD, kK);
static_assert(kOff == kRule.off, "the tile rule's parameter-matrix mode differs from the key's");
#if defined(MJHMC_MM_OD_CHUNK) && defined(MJHMC_MM_OD_XG)
static_assert(kRule.kc == MJHMC_MM_OD_CHUNK && kRule.xg == (MJHMC_MM_OD_XG != 0),
              "the tile rule's chunk or X/G mode differs from the key's");
#else
static_assert(kRule.kc == 0, "the tile rule chunks this shape; the key names no chunk");
#endif

// the tile entries' bodies, templates so that only this body's kernels are
// instantiated: mm_kernel's tile (MJHMC, control, MALT) or NUTS's
template <int V>
int body_tile(int energy, int precision, int variant, int br, int* out) {
  if constexpr (V != kNuts) {
    if (energy != kE || precision != kP || variant != V) return cudaErrorInvalidValue;
    return mm_tile_at<kE, kD, kK, kP, V>(br != 0, out);
  } else {
    return cudaErrorInvalidValue;
  }
}
template <int V>
int nuts_body_tile(int energy, int precision, int max_depth, int* out) {
  if constexpr (V == kNuts) {
    if (energy != kE || precision != kP || max_depth < 1 || max_depth > nuts::kMaxDepth)
      return cudaErrorInvalidValue;
    return nuts_tile_at<kE, kD, kK, kP>(max_depth, out);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace ondemand
}  // namespace mm
}  // namespace mjhmc

// mjhmc_mm_engine_launch's contract for this instance's (energy, ndims,
// krows, variant, precision) only; no stub
extern "C" int mjhmc_mm_od_launch(
    int energy, int ndims, int krows, int stub, int variant, int precision, const float* p0,
    const float* p1, float k0, float k1, float k2, float k3, const float* mass,
    int two_stage, float* scratch, const float* x, const float* v, const float* g,
    const float* u, const float* h_back, const float* valid, float* xo, float* vo,
    float* go, float* uo, float* hbo, float* valido, float* w, float* wx, float* wx2,
    int* evals, float* xs, float* ws, int* es, int n, int num_iters, int thin, int m,
    unsigned int seed, float eps, float beta, int fixed_uniform, void* stream) {
  using namespace mjhmc::mm;
  using namespace mjhmc::mm::ondemand;
  if (energy != kE || ndims != kD || krows != kK || variant != kV || precision != kP || stub ||
      n <= 0 || thin <= 0 || m <= 0 || (two_stage && variant == kMalt) ||
      (variant == kNuts && (two_stage || m > nuts::kMaxDepth)) ||
      (energy == kSparseCoding && p1 == nullptr))
    return cudaErrorInvalidValue;
  Args a{p0, p1, k0, k1, k2, k3, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage,
         scratch};
  return launch_body_at<kE, kD, kK, kP, kV>(a, xs != nullptr, static_cast<cudaStream_t>(stream));
}

// mjhmc_mm_tile of this instance (MJHMC, control or MALT)
extern "C" int mjhmc_mm_od_tile(int energy, int precision, int variant, int br, int* out) {
  using namespace mjhmc::mm::ondemand;
  return body_tile<kV>(energy, precision, variant, br, out);
}

// mjhmc_mm_nuts_tile of this instance (NUTS)
extern "C" int mjhmc_mm_od_nuts_tile(int energy, int precision, int max_depth, int* out) {
  using namespace mjhmc::mm::ondemand;
  return nuts_body_tile<kV>(energy, precision, max_depth, out);
}
