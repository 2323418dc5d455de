// The logistic-regression instances of the matmul kernel (mm_kernel in
// mjhmc_mm_engine.cuh) at the preset's (d, nobs) = (16, 256) and full f32
// (kHighest): MJHMC, control HMC and MALT, run and stream, and their tile
// queries, compiled by their own nvcc; NUTS is in mm_nuts_logreg.cu.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kLogreg, kHighest, kMjhmc>();
template Instance body_instance<kLogreg, kHighest, kControl>();
template Instance body_instance<kLogreg, kHighest, kMalt>();

}  // namespace mm
}  // namespace mjhmc
