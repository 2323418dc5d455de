// The D=50 instances of the MJHMC body with its branches (mjhmc_kernel in
// mjhmc_engine.cuh: a mass, the two-stage integrator), compiled by their
// own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kMjhmc, 50, kRoughWell, true>;
template Launch launch_instance<kMjhmc, 50, kGaussian, true>;

}  // namespace mjhmc
