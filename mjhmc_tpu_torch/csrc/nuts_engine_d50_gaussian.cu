// The D=50 Gaussian instances of the NUTS body (nuts::nuts_kernel in
// mjhmc_engine.cuh), with and without a mass, compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kNuts, 50, kGaussian, false>;
template Launch launch_instance<kNuts, 50, kGaussian, true>;

}  // namespace mjhmc
