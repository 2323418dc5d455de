// The non-centered eight-schools instances (D=10) of the NUTS body
// (nuts::nuts_kernel in mjhmc_engine.cuh), with and without a mass, compiled
// by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kNuts, 10, kEightSchoolsNoncentered, false>;
template cudaError_t nuts_tile<10, kEightSchoolsNoncentered, false>(int, int, int*);
template Launch launch_instance<kNuts, 10, kEightSchoolsNoncentered, true>;
template cudaError_t nuts_tile<10, kEightSchoolsNoncentered, true>(int, int, int*);

}  // namespace mjhmc
