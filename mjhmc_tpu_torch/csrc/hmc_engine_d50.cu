// The D=50 instances of the control HMC and MALT bodies (hmc::control_kernel
// and hmc::malt_kernel in mjhmc_engine.cuh), compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kControl, 50, kRoughWell, true>;
template Launch launch_instance<kControl, 50, kGaussian, true>;
template Launch launch_instance<kMalt, 50, kRoughWell, true>;
template Launch launch_instance<kMalt, 50, kGaussian, true>;

}  // namespace mjhmc
