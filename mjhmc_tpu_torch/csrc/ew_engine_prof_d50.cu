// The PROF instances of the MJHMC and control bodies with the branches on
// the D=50 Gaussian (gauss50d with a mass), compiled by their own nvcc;
// nothing on the main path launches them (cuda_mjhmc.ew_profile does).
#include "mjhmc_engine.cuh"

namespace mjhmc {

template ProfLaunch launch_ew_prof<kMjhmc, 50, kGaussian, true>;
template ProfLaunch launch_ew_prof<kControl, 50, kGaussian, true>;

}  // namespace mjhmc
