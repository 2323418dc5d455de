// The sparse-coding instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's (d, p) = (128, 64): MJHMC, control
// HMC and MALT, compiled by their own nvcc; NUTS is in
// mm_nuts_sparse_coding.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

cudaError_t launch_sparse_coding(int variant, const Args& a, bool emit, cudaStream_t s) {
  switch (variant) {
    case kMjhmc: return launch_emit<kSparseCoding, 128, 64, 16, 256, kMjhmc>(a, emit, s);
    case kControl: return launch_emit<kSparseCoding, 128, 64, 16, 256, kControl>(a, emit, s);
    case kMalt: return launch_emit<kSparseCoding, 128, 64, 16, 256, kMalt>(a, emit, s);
    case kNuts: return launch_nuts_sparse_coding(a, emit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm
}  // namespace mjhmc
