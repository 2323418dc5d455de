// The emitting kernel (the stream's) of the D=50 rough-well instance of the
// NUTS body with a mass (nuts::nuts_kernel in mjhmc_engine.cuh), compiled by its
// own nvcc beside nuts_engine_d50_rough_well_mass.cu, which holds the run's.
#include "mjhmc_engine.cuh"

namespace mjhmc {

template cudaError_t launch_nuts<50, kRoughWell, true, true>(const Args&, cudaStream_t);

}  // namespace mjhmc
