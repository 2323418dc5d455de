// The precision sweep's instances of the matmul kernel (launch_sweep in
// mjhmc_mm_engine.cuh): the MJHMC leapfrog run without a mass at the two
// precisions of product of t and sparse coding that are neither kHighest
// nor the preset's default, compiled by their own nvcc
// (mjhmc_tpu_torch/bench_mm_precision.py runs all four).
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Launch launch_sweep<kProductOfT, kBf16x3>;
template Launch launch_sweep<kProductOfT, kBf16x2>;
template Launch launch_sweep<kSparseCoding, kBf16x2>;
template Launch launch_sweep<kSparseCoding, kDefault>;

}  // namespace mm
}  // namespace mjhmc
