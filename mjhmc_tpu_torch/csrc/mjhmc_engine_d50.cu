// The D=50 fast-path instances of the MJHMC body (mjhmc_kernel in
// mjhmc_engine.cuh, no branches compiled in), compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kMjhmc, 50, kRoughWell, false>;
template Launch launch_instance<kMjhmc, 50, kGaussian, false>;

}  // namespace mjhmc
