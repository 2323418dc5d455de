// The PROF instances of the NUTS body (nuts::nuts_kernel in
// mjhmc_engine.cuh): the gauss2d (D=2 Gaussian) and funnel (D=10) runs
// without a mass, clock64() stamps of every chain's phases. Nothing on the
// main path launches them (cuda_mjhmc.nuts_profile does).
#include "mjhmc_engine.cuh"

namespace mjhmc {

template cudaError_t launch_nuts_prof<2, kGaussian>(const Args&, cudaStream_t);
template cudaError_t launch_nuts_prof<10, kFunnel>(const Args&, cudaStream_t);

}  // namespace mjhmc
