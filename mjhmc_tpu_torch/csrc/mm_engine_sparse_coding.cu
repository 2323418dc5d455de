// The sparse-coding instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's (d, p) = (128, 64) and full f32
// (kHighest): MJHMC, control HMC and MALT, run and stream, and their tile
// queries, compiled by their own nvcc; NUTS is in mm_nuts_sparse_coding.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kSparseCoding, kHighest, kMjhmc>();
template Instance body_instance<kSparseCoding, kHighest, kControl>();
template Instance body_instance<kSparseCoding, kHighest, kMalt>();

}  // namespace mm
}  // namespace mjhmc
