// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the logreg preset, (d, k) = (16, 256): run and
// stream, with and without an inverse mass, compiled by their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

cudaError_t launch_nuts_logreg(const Args& a, bool emit, cudaStream_t s) {
  return launch_emit<kLogreg, 16, 256, 16, 128, kNuts>(a, emit, s);
}

}  // namespace mm
}  // namespace mjhmc
