// The funnel instances (D=10) of the NUTS body (nuts::nuts_kernel in
// mjhmc_engine.cuh), with and without a mass, compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kNuts, 10, kFunnel, false>;
template cudaError_t nuts_tile<10, kFunnel, false>(int, int, int*);
template Launch launch_instance<kNuts, 10, kFunnel, true>;
template cudaError_t nuts_tile<10, kFunnel, true>(int, int, int*);

}  // namespace mjhmc
