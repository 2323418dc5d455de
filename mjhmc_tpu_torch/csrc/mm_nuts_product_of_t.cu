// The NUTS instances of the matmul kernel (nuts_mm_kernel in
// mjhmc_mm_engine.cuh) for the product_of_t preset, (d, k) = (36, 36), at full f32
// (kHighest): run and stream, with and without an inverse mass, compiled by
// their own nvcc.
#include "mjhmc_mm_engine.cuh"

namespace mjhmc {
namespace mm {

template Instance body_instance<kProductOfT, kHighest, kNuts>();
template cudaError_t nuts_tile<kProductOfT, kHighest>(int, int*);

}  // namespace mm
}  // namespace mjhmc
