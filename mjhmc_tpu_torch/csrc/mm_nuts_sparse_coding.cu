// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the sparse_coding preset, (d, k) = (128, 64), at full f32
// (kHighest): run and stream, with and without an inverse mass, compiled by
// their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kSparseCoding, kHighest, kNuts>();
template cudaError_t nuts_tile<kSparseCoding, kHighest>(int, int*);

}  // namespace mm
}  // namespace mjhmc
