// The logistic-regression instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's (d, nobs) = (16, 256): MJHMC,
// control HMC and MALT, compiled by their own nvcc; NUTS is in
// mm_nuts_logreg.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

cudaError_t launch_logreg(int variant, const Args& a, bool emit, cudaStream_t s) {
  switch (variant) {
    case kMjhmc: return launch_emit<kLogreg, 16, 256, 16, 128, kMjhmc>(a, emit, s);
    case kControl: return launch_emit<kLogreg, 16, 256, 16, 128, kControl>(a, emit, s);
    case kMalt: return launch_emit<kLogreg, 16, 256, 16, 128, kMalt>(a, emit, s);
    case kNuts: return launch_nuts_logreg(a, emit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm
}  // namespace mjhmc
