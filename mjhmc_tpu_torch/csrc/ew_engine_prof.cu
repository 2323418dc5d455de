// The PROF instances of the MJHMC, MALT and control bodies (mjhmc_kernel,
// hmc::malt_kernel and hmc::control_kernel in mjhmc_engine.cuh): the rough
// well (D=2) and the funnel (D=10), clock64() stamps of every chain's
// phases. Nothing on the main path launches them (cuda_mjhmc.ew_profile
// does).
#include "mjhmc_engine.cuh"

namespace mjhmc {

template ProfLaunch launch_ew_prof<kMjhmc, 2, kRoughWell, false>;
template ProfLaunch launch_ew_prof<kMalt, 2, kRoughWell, true>;
template ProfLaunch launch_ew_prof<kMjhmc, 10, kFunnel, false>;
template ProfLaunch launch_ew_prof<kMalt, 10, kFunnel, true>;
template ProfLaunch launch_ew_prof<kControl, 2, kRoughWell, true>;
template ProfLaunch launch_ew_prof<kControl, 10, kFunnel, true>;

}  // namespace mjhmc
