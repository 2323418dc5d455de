// The funnel instances (D=10, the funnel preset's) of the MJHMC, control HMC
// and MALT bodies (mjhmc_engine.cuh), compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kMjhmc, 10, kFunnel, false>;
template Launch launch_instance<kMjhmc, 10, kFunnel, true>;
template Launch launch_instance<kControl, 10, kFunnel, true>;
template Launch launch_instance<kMalt, 10, kFunnel, true>;

}  // namespace mjhmc
