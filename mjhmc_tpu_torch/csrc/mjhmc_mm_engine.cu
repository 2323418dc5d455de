// Fused MJHMC, control HMC, MALT and NUTS engines for the matmul energies:
// the C entry and the product-of-t instances (NUTS: mm_nuts_product_of_t.cu).
// The kernels are templates in mjhmc_mm_engine.cuh, which says what they
// replace.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

cudaError_t launch_product_of_t(int variant, bool stub, const Args& a, bool emit,
                                cudaStream_t s) {
  if (stub)
    return emit || variant != kMjhmc
               ? cudaErrorInvalidValue
               : launch<kProductOfT, 36, 36, 16, 96, kMjhmc, false, true, false>(a, s);
  switch (variant) {
    case kMjhmc: return launch_emit<kProductOfT, 36, 36, 16, 96, kMjhmc>(a, emit, s);
    case kControl: return launch_emit<kProductOfT, 36, 36, 16, 96, kControl>(a, emit, s);
    case kMalt: return launch_emit<kProductOfT, 36, 36, 16, 96, kMalt>(a, emit, s);
    case kNuts: return launch_nuts_product_of_t(a, emit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm
}  // namespace mjhmc

// Plain C entry for ctypes. variant 0 runs MJHMC, 1 NUTS (m is max_depth,
// beta unused), 2 control HMC (beta is the corruption fraction), 3 MALT
// (beta is the friction gamma); mass is (2, ndims) (M^-1, sqrt(M)) or NULL;
// two_stage != 0 takes the two-stage integrator (MJHMC and control);
// scratch is NUTS's (nuts::rows(m), ndims, n) tree state. xs/ws/es == NULL
// runs without emissions; stub != 0 runs the stub_dots ablation. Instances:
// product of t (d, k) = (36, 36), sparse coding (d, p) = (128, 64) and
// logistic regression (d, nobs) = (16, 256), the presets' shapes, and the
// stubbed product-of-t MJHMC run (the roofline dossier's ablation row).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mjhmc_mm_engine_launch(
    int energy, int ndims, int krows, int stub, int variant, const float* p0,
    const float* p1, float k0, float k1, float k2, float k3, const float* mass,
    int two_stage, float* scratch, const float* x, const float* v, const float* g,
    const float* u, const float* h_back, const float* valid, float* xo, float* vo,
    float* go, float* uo, float* hbo, float* valido, float* w, float* wx, float* wx2,
    int* evals, float* xs, float* ws, int* es, int n, int num_iters, int thin, int m,
    unsigned int seed, float eps, float beta, int fixed_uniform, void* stream) {
  using namespace mjhmc::mm;
  if (n <= 0 || thin <= 0 || m <= 0 || (two_stage && variant == kMalt) ||
      (variant == kNuts && (two_stage || m > nuts::kMaxDepth || !scratch)))
    return cudaErrorInvalidValue;
  Args a{p0, p1, k0, k1, k2, k3, x, v, g, u, h_back, valid,
         xo, vo, go, uo, hbo, valido, w, wx, wx2, evals, xs, ws, es,
         n, num_iters, thin, m, fixed_uniform, seed, eps, beta, mass, two_stage,
         scratch};
  const bool emit = xs != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (energy == kProductOfT && ndims == 36 && krows == 36)
    return launch_product_of_t(variant, stub != 0, a, emit, s);
  if (energy == kSparseCoding && ndims == 128 && krows == 64 && p1 != nullptr && !stub)
    return launch_sparse_coding(variant, a, emit, s);
  if (energy == kLogreg && ndims == 16 && krows == 256 && !stub)
    return launch_logreg(variant, a, emit, s);
  return cudaErrorInvalidValue;
}
