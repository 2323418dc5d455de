// Philox4x32-10 counter-based generator (Salmon et al., SC'11; the
// Random123 constants), written out so that the engine's kernel and its
// plain PyTorch version (mjhmc_tpu_torch/ops/cuda_mjhmc.py::philox4x32)
// produce the same words bit for bit.
//
// The engine keys it with the run seed and counts (chain, iteration,
// block, 0); one block gives four 32-bit words.
#pragma once

#include <stdint.h>

namespace mjhmc {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      key.x += kPhiloxW0;
      key.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, ctr.x);
    const uint32_t lo0 = kPhiloxM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, ctr.z);
    const uint32_t lo1 = kPhiloxM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// U(0,1) from one word, built as the TPU kernel's _uniform builds it: the
// top 24 bits times 2^-24, plus 2^-25, so it is always > 0 (safe for log).
__device__ __forceinline__ float philox_uniform(uint32_t word) {
  return __uint2float_rn(word >> 8) * 0x1p-24f + 0x1p-25f;
}

}  // namespace mjhmc
