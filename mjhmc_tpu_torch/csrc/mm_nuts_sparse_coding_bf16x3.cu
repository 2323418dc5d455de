// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the sparse_coding preset, (128, 64), at its JAX default
// dot precision, "bf16x3": run and stream, with and without an inverse
// mass, the run's PROF instance (the per-leaf phase breakdown) and their
// tile query, compiled by their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kSparseCoding, kBf16x3, kNuts>();
template cudaError_t nuts_tile<kSparseCoding, kBf16x3>(int, int*);
template cudaError_t launch_nuts_prof<kSparseCoding, kBf16x3>(const Args&, cudaStream_t);

}  // namespace mm
}  // namespace mjhmc
