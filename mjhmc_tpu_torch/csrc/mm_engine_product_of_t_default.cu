// The product_of_t instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's shape (36, 36) and its JAX default
// dot precision, "default" (tensor-core mma.sync passes): MJHMC, control HMC
// and MALT, run and stream, with and without the branches, and their tile
// queries, compiled by their own nvcc; NUTS is in mm_nuts_product_of_t_default.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kProductOfT, kDefault, kMjhmc>();
template Instance body_instance<kProductOfT, kDefault, kControl>();
template Instance body_instance<kProductOfT, kDefault, kMalt>();

}  // namespace mm
}  // namespace mjhmc
