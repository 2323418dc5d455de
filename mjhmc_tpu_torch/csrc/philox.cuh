// Philox4x32-10 counter-based generator (Salmon et al., SC'11; the
// Random123 constants), written out so that the engine's kernel and its
// plain PyTorch version (mjhmc_tpu_torch/ops/cuda_mjhmc.py::philox4x32)
// produce the same words bit for bit.
//
// The engines key it with the run seed and count (chain, iteration, slot,
// tag); one counter gives four 32-bit words. The tag word keeps the
// samplers' draws apart, and each draw is keyed by its position in the
// iteration, never by how many draws a chain has made, so a vectorised
// plain version reproduces every word:
// - tag 0, MJHMC: slot b holds words 4b..4b+3 of the iteration's 1 + 2d;
// - tag 1, NUTS momentum: slot b holds words 4b..4b+3 of 2d (dim i's
//   Box-Muller normal takes words i and d+i);
// - tag 2, NUTS round: slot jj (the doubling round), word 0 picks the
//   direction, word 1 the merge;
// - tag 3, NUTS leaf: the leaf at tree position k = 2^jj - 1 + i (leaf i
//   of round jj) takes word k % 4 of slot k / 4;
// - tag 4, control HMC (the matmul kernel): slot b holds words 4b..4b+3 of
//   the iteration's 2d + 1: dim i's corruption normal xi takes words i and
//   d+i, the Metropolis uniform word 2d;
// - tag 5, MALT refresh (the matmul kernel): the same layout, dim i's fresh
//   momentum from words i and d+i, the Metropolis uniform word 2d;
// - tag 6, MALT O-step noise (the matmul kernel): O-step o (0..2M-1, two
//   per leapfrog step) takes slots o*B..o*B+B-1, B = ceil(2d/4), dim i's
//   normal from words i and d+i of its 2d;
// - tag 7, MALT (the elementwise kernel): dim i's M + 1 Box-Muller pairs
//   are slots i*B..i*B+B-1, B = ceil((M+1)/2), pair p in words 2(p%2) (u1)
//   and 2(p%2)+1 (u2) of slot i*B + p/2; pair k < M gives leapfrog step k's
//   two O-steps, the first its cosine branch, the second its sine branch,
//   sqrt(-2 ln u1)*sin(2 pi u2); pair M gives the refresh, its cosine
//   branch; the Metropolis uniform is word 0 of slot d*B. In fixed-uniform
//   mode every one of these normals is the cosine branch's.
// - tag 8, control HMC (the elementwise kernel): word k of the iteration is
//   word k % 4 of slot k / 4; Box-Muller pair p takes words 2p (u1) and
//   2p + 1 (u2), dim i's corruption normal is branch i % 2 of pair i / 2
//   (the cosine, then the sine), and the Metropolis uniform is word
//   2 ceil(d/2), in the pairs' last slot where they leave it a free word
//   (d 1, 2, 10 and 50: one slot at d <= 2, 3 at 10, 13 at 50). In
//   fixed-uniform mode every normal is the cosine branch's.
// Every other normal is Box-Muller's cosine branch, sqrt(-2 ln u1)*cos(2 pi u2).
#pragma once

#include <stdint.h>

namespace mjhmc {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

enum PhiloxTag : uint32_t {
  kTagMjhmc = 0,
  kTagNutsMomentum = 1,
  kTagNutsRound = 2,
  kTagNutsLeaf = 3,
  kTagControl = 4,
  kTagMaltRefresh = 5,
  kTagMaltNoise = 6,
  kTagMaltPairs = 7,
  kTagControlPairs = 8,
};

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

__device__ __forceinline__ uint32_t word_of(uint4 r, uint32_t j) {
  switch (j & 3u) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// Word k of a (chain, iteration) draw of family tag whose words start at
// slot slot0: output k % 4 of slot slot0 + k / 4 (MJHMC: slot0 0, tag 0).
__device__ __forceinline__ uint32_t philox_word(uint32_t chain, uint32_t t,
                                                uint32_t k, uint2 key,
                                                uint32_t tag = kTagMjhmc,
                                                uint32_t slot0 = 0) {
  return word_of(philox4x32_10(make_uint4(chain, t, slot0 + (k >> 2), tag), key), k);
}

// U(0,1) from one word, built as the TPU kernel's _uniform builds it: the
// top 24 bits times 2^-24, plus 2^-25, so it is always > 0 (safe for log).
__device__ __forceinline__ float philox_uniform(uint32_t word) {
  return __uint2float_rn(word >> 8) * 0x1p-24f + 0x1p-25f;
}

}  // namespace mjhmc
