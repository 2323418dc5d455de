// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the sparse_coding preset, (d, k) = (128, 64): run and
// stream, with and without an inverse mass, compiled by their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

cudaError_t launch_nuts_sparse_coding(const Args& a, bool emit, cudaStream_t s) {
  return launch_emit<kSparseCoding, 128, 64, 16, 256, kNuts>(a, emit, s);
}

}  // namespace mm
}  // namespace mjhmc
