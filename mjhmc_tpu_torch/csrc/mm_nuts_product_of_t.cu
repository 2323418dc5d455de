// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the product_of_t preset, (d, k) = (36, 36): run and
// stream, with and without an inverse mass, compiled by their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

cudaError_t launch_nuts_product_of_t(const Args& a, bool emit, cudaStream_t s) {
  return launch_emit<kProductOfT, 36, 36, 16, 96, kNuts>(a, emit, s);
}

}  // namespace mm
}  // namespace mjhmc
