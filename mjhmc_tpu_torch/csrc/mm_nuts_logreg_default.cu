// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the logreg preset, (16, 256), at its JAX default
// dot precision, "default": run and stream, with and without an inverse
// mass, the run's PROF instance (the per-leaf phase breakdown) and their
// tile query, compiled by their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kLogreg, kDefault, kNuts>();
template cudaError_t nuts_tile<kLogreg, kDefault>(int, int*);
template cudaError_t launch_nuts_prof<kLogreg, kDefault>(const Args&, cudaStream_t);

}  // namespace mm
}  // namespace mjhmc
