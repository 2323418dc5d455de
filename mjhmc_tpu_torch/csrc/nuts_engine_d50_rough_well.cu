// The D=50 rough-well instance of the NUTS body without a mass
// (nuts::nuts_kernel in mjhmc_engine.cuh), compiled by its own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kNuts, 50, kRoughWell, false>;
template cudaError_t nuts_tile<50, kRoughWell, false>(int, int, int*);

}  // namespace mjhmc
