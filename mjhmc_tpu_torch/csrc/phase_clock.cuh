// The clock64() phase breakdown of the engines' PROF instances
// (mjhmc_mm_engine.cuh: stamps by two observers a block, thread 0 and the
// first thread of the last warp; mjhmc_engine.cuh: every thread, one chain
// each). Each phase's cycles are summed between stamps, the wait inside a
// block barrier apart (phase BAR; the elementwise kernel has no barrier),
// beside counters. With ON=false every member compiles to nothing.
#pragma once

#include <cuda_runtime.h>

namespace mjhmc {

template <bool ON, int NPH, int BAR>
struct PhaseClock {
  long long last = 0;
  long long acc[NPH] = {};
  __device__ __forceinline__ void start() {
    if constexpr (ON) last = clock64();
  }
  __device__ __forceinline__ void mark(int ph) {
    if constexpr (ON) {
      const long long now = clock64();
      acc[ph] += now - last;
      last = now;
    }
  }
  // A barrier (BAR.SYNC.DEFER_BLOCKING) lets a warp issue on past it and
  // wait at its next memory operation, so a bare stamp after it would put
  // the wait into the next phase; the fence takes the wait before the stamp
  __device__ __forceinline__ void settle() {
    if constexpr (ON) __threadfence_block();
  }
  __device__ __forceinline__ void sync(int ph) {
    mark(ph);
    __syncthreads();
    settle();
    mark(BAR);
  }
  __device__ __forceinline__ bool sync_or(int ph, bool p) {
    mark(ph);
    const bool any = __syncthreads_or(p);
    settle();
    mark(BAR);
    return any;
  }
  __device__ __forceinline__ void count(int ph) {
    if constexpr (ON) ++acc[ph];
  }
  __device__ __forceinline__ void add(int ph, long long k) {
    if constexpr (ON) acc[ph] += k;
  }
  // the two observers' records, prof[(block·2 + observer)·NPH + phase]
  template <class A>
  __device__ __forceinline__ void write(const A& a, int T) {
    if constexpr (ON) {
      const int o = threadIdx.x == 0 ? 0 : threadIdx.x == T - 32 ? 1 : -1;
      if (o >= 0)
        for (int ph = 0; ph < NPH; ++ph)
          a.prof[((size_t)blockIdx.x * 2 + o) * NPH + ph] = acc[ph];
    }
  }
  // one thread's record, row[phase]
  __device__ __forceinline__ void store(unsigned long long* row) {
    if constexpr (ON)
      for (int ph = 0; ph < NPH; ++ph) row[ph] = acc[ph];
  }
};

}  // namespace mjhmc
