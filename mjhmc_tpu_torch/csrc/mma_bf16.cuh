// bf16 tensor-core pieces shared by the ceiling probe (ceilings.cu) and the
// matmul kernel's contractions (mjhmc_mm_engine.cuh): round-to-nearest-even
// packing, the hi/lo split and one mma.sync.m16n8k16 bf16 -> f32.
//
// Fragment layout of m16n8k16 (g = lane / 4, q = lane % 4): A regs 0..3
// hold (row g, k 2q..2q+1), (g+8, 2q..), (g, 8+2q..), (g+8, 8+2q..); B regs
// 0..1 hold (k 2q..2q+1, col g), (k 8+2q.., col g); the accumulator holds
// (g, 2q..2q+1) and (g+8, 2q..2q+1). In each register the lower k sits in
// the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x = hi + lo to ~2⁻¹⁶ relative for two neighbours: hi = bf16(x) and lo =
// bf16(x − hi), both rounded to nearest even (x − hi is exact in f32), as
// the JAX split a.astype(bf16), (a − a_hi).astype(bf16)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// d += a·b on one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc
