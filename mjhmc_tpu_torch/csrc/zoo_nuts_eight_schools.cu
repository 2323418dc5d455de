// The centered eight-schools instances (D=10) of the NUTS body
// (nuts::nuts_kernel in mjhmc_engine.cuh), with and without a mass, compiled
// by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kNuts, 10, kEightSchoolsCentered, false>;
template cudaError_t nuts_tile<10, kEightSchoolsCentered, false>(int, int, int*);
template Launch launch_instance<kNuts, 10, kEightSchoolsCentered, true>;
template cudaError_t nuts_tile<10, kEightSchoolsCentered, true>(int, int, int*);

}  // namespace mjhmc
