// The sparse_coding instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's shape (128, 64) and its JAX default
// dot precision, "bf16x3" (tensor-core mma.sync passes): MJHMC, control HMC
// and MALT, run and stream, with and without the branches, compiled by their
// own nvcc; NUTS is in mm_nuts_sparse_coding_bf16x3.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Launch launch_body<kSparseCoding, kBf16x3, kMjhmc>;
template Launch launch_body<kSparseCoding, kBf16x3, kControl>;
template Launch launch_body<kSparseCoding, kBf16x3, kMalt>;

}  // namespace mm
}  // namespace mjhmc
