// The PROF instance of the MJHMC body with the branches on the D=50
// Gaussian (gauss50d with a mass), compiled by its own nvcc; nothing on the
// main path launches it (cuda_mjhmc.ew_profile does).
#include "mjhmc_engine.cuh"

namespace mjhmc {

template ProfLaunch launch_ew_prof<kMjhmc, 50, kGaussian, true>;

}  // namespace mjhmc
