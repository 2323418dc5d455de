// The logreg instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's shape (16, 256) and its JAX default
// dot precision, "default" (tensor-core mma.sync passes): MJHMC, control HMC
// and MALT, run and stream, with and without the branches, compiled by their
// own nvcc; NUTS is in mm_nuts_logreg_default.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Launch launch_body<kLogreg, kDefault, kMjhmc>;
template Launch launch_body<kLogreg, kDefault, kControl>;
template Launch launch_body<kLogreg, kDefault, kMalt>;

}  // namespace mm
}  // namespace mjhmc
