// The eight-schools instances (D=10, both parameterizations) of the MJHMC,
// control HMC and MALT bodies (mjhmc_engine.cuh), compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kMjhmc, 10, kEightSchoolsCentered, false>;
template Launch launch_instance<kMjhmc, 10, kEightSchoolsCentered, true>;
template Launch launch_instance<kControl, 10, kEightSchoolsCentered, true>;
template Launch launch_instance<kMalt, 10, kEightSchoolsCentered, true>;
template Launch launch_instance<kMjhmc, 10, kEightSchoolsNoncentered, false>;
template Launch launch_instance<kMjhmc, 10, kEightSchoolsNoncentered, true>;
template Launch launch_instance<kControl, 10, kEightSchoolsNoncentered, true>;
template Launch launch_instance<kMalt, 10, kEightSchoolsNoncentered, true>;

}  // namespace mjhmc
