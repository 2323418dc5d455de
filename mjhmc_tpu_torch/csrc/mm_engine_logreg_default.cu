// The logreg instances of the matmul kernel (mm_kernel in mjhmc_mm_engine.cuh)
// at the preset's shape (16, 256) and its JAX default dot precision, "default"
// (tensor-core mma.sync passes): MJHMC, control HMC and MALT, run and stream,
// with and without the branches, their tile queries and the MALT run's PROF
// instance, compiled by their own nvcc; NUTS is in mm_nuts_logreg_default.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kLogreg, kDefault, kMjhmc>();
template Instance body_instance<kLogreg, kDefault, kControl>();
template Instance body_instance<kLogreg, kDefault, kMalt>();
template ProfLaunch launch_mm_prof<kLogreg, kDefault, kMalt>;

}  // namespace mm
}  // namespace mjhmc
