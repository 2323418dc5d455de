// Ceiling probes for Hopper (sm_90a): the denominators of the roofline
// dossier (mjhmc_tpu_torch/bench_mfu.py).
//
// Replaces the two Pallas microkernels of the root bench_mfu.py:
// measure_vpu_ceiling's kernel (:159-177) becomes fma_chain, and
// measure_mxu_ceiling's kernel (:94-118) becomes tc_chain. Both keep the
// TPU probes' shape: four independent loop-carried chains per element, so
// nothing can be hoisted out of the loop and one dependent chain's latency
// does not set the rate; the output is the sum of the four chains.
//
// Both probes stay resident: every operand lives in registers (and W in
// shared memory) for the whole loop, and device memory is touched only to
// load the inputs and store the sum. A probe that streamed from device
// memory would measure bandwidth, not the unit it is named for.
//
// fma_chain: one thread per element of a (rows, lanes) f32 block; each
// iteration is x <- x·a + b (one FMA), or x <- sinf(x)·a + b. The plain
// chain is bound by the FP32 FMA pipes' issue rate: at 262,144 threads
// (about the card's 132 × 2,048 resident threads) each scheduler has ~16
// warps with four independent FMAs each, far more than the 4-cycle FMA
// latency needs. The sin chain prices precise sinf (no fast-math), the
// instruction mix of range reduction and polynomial that the rough-well
// kernel runs (csrc/mjhmc_engine.cu), not the SFU's __sinf.
//
// tc_chain: each iteration is b <- (W·b)·(1/depth) for four chains started
// at b + i, products in one bf16 pass with f32 accumulation (both operands
// rounded to bf16, nearest-even: the TPU's DEFAULT precision), written by
// hand with mma.sync.aligned.m16n8k16 bf16 -> f32. The chained operand b
// takes the A role (bᵀ <- bᵀ·Wᵀ): the m16n8 f32 accumulator fragments of two
// neighbouring n-tiles convert in registers into the next m16k16 A
// fragment (the FlashAttention-2 layout identity), so the chain never
// leaves registers. W (zero-padded to a multiple of 16, rows padded by 8
// bf16 so the fragment loads hit 32 distinct banks) sits in shared memory;
// each warp runs one chain over 16·R lanes and reuses each B fragment for
// its R m-tiles. What bounds it: mma.sync issue rate, the B-fragment loads
// from shared memory and the fragment conversion. This is the mma.sync
// ceiling, not the card's wgmma peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ceilings {

using tc::mma_bf16;
using tc::pack_bf16;

// ---------------------------------------------------------------- fma_chain
constexpr int kFmaThreads = 256;
constexpr int kUnroll = 16;

template <bool SIN>
__device__ __forceinline__ float link(float x, float a, float b) {
  return fmaf(SIN ? sinf(x) : x, a, b);
}

template <bool SIN>
__global__ void __launch_bounds__(kFmaThreads)
fma_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int n, long long iters) {
  const int e = blockIdx.x * kFmaThreads + threadIdx.x;
  if (e >= n) return;
  const float av = a[e], bv = b[e];
  // the JAX probe's starts b·f32(0.2·(i+1)), the factor rounded from double
  float x0 = bv * (float)(0.2 * 1), x1 = bv * (float)(0.2 * 2);
  float x2 = bv * (float)(0.2 * 3), x3 = bv * (float)(0.2 * 4);
  long long i = 0;
  for (; i + kUnroll <= iters; i += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      x0 = link<SIN>(x0, av, bv);
      x1 = link<SIN>(x1, av, bv);
      x2 = link<SIN>(x2, av, bv);
      x3 = link<SIN>(x3, av, bv);
    }
  }
  for (; i < iters; ++i) {
    x0 = link<SIN>(x0, av, bv);
    x1 = link<SIN>(x1, av, bv);
    x2 = link<SIN>(x2, av, bv);
    x3 = link<SIN>(x3, av, bv);
  }
  out[e] = ((x0 + x1) + x2) + x3;
}

// ----------------------------------------------------------------- tc_chain
constexpr int kChains = 4;  // one warp per chain
constexpr int kTcThreads = 32 * kChains;

// m-tiles of 16 lanes per warp: two share each B fragment where the
// accumulators leave room in registers
template <int DP>
__host__ __device__ constexpr int m_tiles() { return DP <= 80 ? 2 : 1; }

// The m16n8k16 fragment layout is in mma_bf16.cuh. Here A[m][k] = b[k][lane
// m], B[k][n] = W[n][k], and the output tile D[m][n] = (W·b)[n][lane m].
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
tc_chain_kernel(const float* __restrict__ w, const float* __restrict__ b,
                float* __restrict__ out, int depth, int lanes, int iters, float c) {
  constexpr int R = m_tiles<DP>();
  constexpr int KT = DP / 16, NT = DP / 8, LDW = DP + 8;
  constexpr int ML = 16 * R;  // lanes per block
  __shared__ __align__(16) __nv_bfloat16 ws[DP * LDW];
  __shared__ float red[ML * DP];

  for (int idx = threadIdx.x; idx < DP * DP; idx += kTcThreads) {
    const int r = idx / DP, k = idx % DP;
    ws[r * LDW + k] = __float2bfloat16_rn(r < depth && k < depth ? w[r * depth + k] : 0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int g = t / 4, q = t % 4;
  const int lane0 = blockIdx.x * ML;
  const float start = (float)warp;  // chain i starts at b + i

  // the chain's A fragments from b + i, zero past depth
  uint32_t af[R][KT][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = g + 8 * (h & 1), k = 16 * kt + 8 * (h >> 1) + 2 * q;
        const size_t col = lane0 + 16 * r + m;
        const float lo = k < depth ? b[(size_t)k * lanes + col] + start : 0.f;
        const float hi = k + 1 < depth ? b[(size_t)(k + 1) * lanes + col] + start : 0.f;
        af[r][kt][h] = pack_bf16(lo, hi);
      }

  float acc[R][NT][4];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[r][nt][h] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* wp = ws + (8 * nt + g) * LDW + 16 * kt + 2 * q;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wp + 8);
#pragma unroll
        for (int r = 0; r < R; ++r) mma_bf16(acc[r][nt], af[r][kt], b0, b1);
      }
    // scale in f32; rows past depth stay 0 (W's padded rows are zero)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[r][nt][h] *= c;
    if (it + 1 < iters) {
      // accumulators of n-tiles 2kt, 2kt+1 become A fragment kt
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          af[r][kt][0] = pack_bf16(acc[r][2 * kt][0], acc[r][2 * kt][1]);
          af[r][kt][1] = pack_bf16(acc[r][2 * kt][2], acc[r][2 * kt][3]);
          af[r][kt][2] = pack_bf16(acc[r][2 * kt + 1][0], acc[r][2 * kt + 1][1]);
          af[r][kt][3] = pack_bf16(acc[r][2 * kt + 1][2], acc[r][2 * kt + 1][3]);
        }
    }
  }

  // sum of the four chains in the JAX order ((c0 + c1) + c2) + c3, one
  // warp after the other through shared memory; warp 3 stores
  for (int turn = 0; turn < kChains; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int m = 16 * r + g + 8 * (h >> 1), n = 8 * nt + 2 * q + (h & 1);
            float s = acc[r][nt][h];
            if (turn > 0) s = red[m * DP + n] + s;
            if (turn + 1 < kChains)
              red[m * DP + n] = s;
            else if (n < depth)
              out[(size_t)n * lanes + lane0 + m] = s;
          }
    }
    __syncthreads();
  }
}

template <int DP>
cudaError_t tc_launch(const float* w, const float* b, float* out, int depth, int lanes,
                      int iters, float c, cudaStream_t s) {
  constexpr int ML = 16 * m_tiles<DP>();
  if (lanes % ML) return cudaErrorInvalidValue;
  tc_chain_kernel<DP><<<lanes / ML, kTcThreads, 0, s>>>(w, b, out, depth, lanes, iters, c);
  return cudaGetLastError();
}

template <int DP>
int tc_lanes() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tc_chain_kernel<DP>,
                                                    kTcThreads, 0) != cudaSuccess)
    return -1;
  return sms * per_sm * 16 * m_tiles<DP>();
}

}  // namespace ceilings

// Plain C entries for ctypes; each returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int fma_chain_launch(const float* a, const float* b, float* out, int n,
                                long long iters, int transcendental, void* stream) {
  using namespace ceilings;
  if (n <= 0 || iters < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kFmaThreads - 1) / kFmaThreads;
  if (transcendental)
    fma_chain_kernel<true><<<blocks, kFmaThreads, 0, s>>>(a, b, out, n, iters);
  else
    fma_chain_kernel<false><<<blocks, kFmaThreads, 0, s>>>(a, b, out, n, iters);
  return cudaGetLastError();
}

#define CEILINGS_PADDED_DEPTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// depth <= 128, padded to a multiple of 16; lanes a multiple of the block's
// 16·R lanes (32 always is); iters >= 1
extern "C" int tc_chain_launch(const float* w, const float* b, float* out, int depth,
                               int lanes, int iters, float c, void* stream) {
  using namespace ceilings;
  if (depth <= 0 || lanes <= 0 || iters < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((depth + 15) / 16 * 16) {
#define CASE(DP) case DP: return tc_launch<DP>(w, b, out, depth, lanes, iters, c, s);
    CEILINGS_PADDED_DEPTHS(CASE)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// Lanes that fill the card with resident tc_chain blocks at this depth:
// SMs × blocks per SM × lanes per block (-1 on error).
extern "C" int tc_chain_lanes(int depth) {
  using namespace ceilings;
  switch ((depth + 15) / 16 * 16) {
#define CASE(DP) case DP: return tc_lanes<DP>();
    CEILINGS_PADDED_DEPTHS(CASE)
#undef CASE
    default: return -1;
  }
}
