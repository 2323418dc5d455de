// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the logreg preset, (16, 256), at its JAX default
// dot precision, "default": run and stream, with and without an inverse
// mass, compiled by their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Launch launch_body<kLogreg, kDefault, kNuts>;

}  // namespace mm
}  // namespace mjhmc
