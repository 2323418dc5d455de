// The D=50 Gaussian instance of the NUTS body with a mass
// (nuts::nuts_kernel in mjhmc_engine.cuh), compiled by its own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kNuts, 50, kGaussian, true>;
template cudaError_t nuts_tile<50, kGaussian, true>(int, int, int*);

}  // namespace mjhmc
