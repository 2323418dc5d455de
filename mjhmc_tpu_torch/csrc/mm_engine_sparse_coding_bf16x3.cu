// The sparse_coding instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's shape (128, 64) and its JAX default dot
// precision, "bf16x3" (tensor-core mma.sync passes): MJHMC, control HMC and
// MALT, run and stream, with and without the branches, their tile queries and
// the PROF instances of the MJHMC and MALT runs, compiled by their own nvcc;
// NUTS is in mm_nuts_sparse_coding_bf16x3.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kSparseCoding, kBf16x3, kMjhmc>();
template Instance body_instance<kSparseCoding, kBf16x3, kControl>();
template Instance body_instance<kSparseCoding, kBf16x3, kMalt>();
template ProfLaunch launch_mm_prof<kSparseCoding, kBf16x3, kMjhmc>;
template ProfLaunch launch_mm_prof<kSparseCoding, kBf16x3, kMalt>;

}  // namespace mm
}  // namespace mjhmc
