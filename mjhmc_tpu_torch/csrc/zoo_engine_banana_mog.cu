// The banana (D=2) and Gaussian-mixture (D=1) instances of every body
// (mjhmc_engine.cuh), the presets' D, compiled by their own nvcc.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template Launch launch_instance<kMjhmc, 2, kBanana, false>;
template Launch launch_instance<kMjhmc, 2, kBanana, true>;
template Launch launch_instance<kNuts, 2, kBanana, false>;
template cudaError_t nuts_tile<2, kBanana, false>(int, int, int*);
template Launch launch_instance<kNuts, 2, kBanana, true>;
template cudaError_t nuts_tile<2, kBanana, true>(int, int, int*);
template Launch launch_instance<kControl, 2, kBanana, true>;
template Launch launch_instance<kMalt, 2, kBanana, true>;
template Launch launch_instance<kMjhmc, 1, kMog, false>;
template Launch launch_instance<kMjhmc, 1, kMog, true>;
template Launch launch_instance<kNuts, 1, kMog, false>;
template cudaError_t nuts_tile<1, kMog, false>(int, int, int*);
template Launch launch_instance<kNuts, 1, kMog, true>;
template cudaError_t nuts_tile<1, kMog, true>(int, int, int*);
template Launch launch_instance<kControl, 1, kMog, true>;
template Launch launch_instance<kMalt, 1, kMog, true>;

}  // namespace mjhmc
