// The precision sweep's instances of the matmul kernel (launch_sweep in
// mjhmc_mm_engine.cuh): the MJHMC leapfrog run without a mass at the two
// precisions of product of t and sparse coding that are neither kHighest nor
// the preset's default, and their tile queries, compiled by their own nvcc
// (mjhmc_tpu_torch/bench_mm_precision.py runs all four).
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance sweep_instance<kProductOfT, kBf16x3>();
template Instance sweep_instance<kProductOfT, kBf16x2>();
template Instance sweep_instance<kSparseCoding, kBf16x2>();
template Instance sweep_instance<kSparseCoding, kDefault>();

}  // namespace mm
}  // namespace mjhmc
