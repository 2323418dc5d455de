// Fused MJHMC, control HMC, MALT and NUTS engines for the matmul energies
// on Hopper (sm_90a): a whole sampling run in one launch. This header holds
// the kernels as templates on the energy's shape (D, K) beside the energy,
// the body and the dot precision; mjhmc_mm_engine.cu compiles the C entry
// and the product-of-t instances at full f32, and the mm_engine_*.cu,
// mm_nuts_*.cu and mm_sweep.cu sources the presets' other instances (the
// list at the end of this header), each by its own nvcc (ops/_build.py).
// Any other (body, energy, D, K, precision) is compiled at its first use
// from ondemand/mm_instance.cu.
//
// Replaces the TPU kernels _mjhmc_mm_kernel and _mjhmc_mm_stream_kernel
// (mjhmc_tpu/ops/pallas_mjhmc.py:1265 and :1596) with the step bodies
// _make_step (:714, "mjhmc"), _make_step_control (:863), _make_step_malt
// (:938) and _make_step_nuts (:1011; nuts_mm_kernel below), the
// ProductOfTSpec (:379), SparseCodingSpec (:468) and LogregSpec (:519)
// energies, their dot precisions (MatmulEnergySpec._dot, :282-375), a
// diagonal inverse mass and the two-stage integrator. One
// templated kernel serves the first three bodies: EMIT=false is the run,
// EMIT=true also streams every thin-th iteration's x (MJHMC:
// pre-transition, with its dwell weight; the others: post-transition,
// weight 1) and cumulative evals with plain coalesced stores (no row
// padding).
//
// Design (mm_kernel): a block owns a tile of CH chains (MmTile, from the
// tile rule by shape: at the presets' widths 256-1,024 blocks, two or more
// resident on each of the 132 SMs). It loads the parameter matrix into
// shared memory once (load_params), or, where no tile can hold it there,
// reads it from a device buffer that params_kernel builds once a launch. The
// tile covers D and K padded (mm_geom): a padded dim draws no momentum and
// stays 0, and the energy's terms on padded dims and rows are masked. The
// trajectories of the tile are the NC columns of (d, NC) arrays in shared
// memory: MJHMC spends two on each chain (forward in column c, backward from
// (x, -v) in CH + c), control and MALT one (forward only). Every leapfrog
// step runs the energy's two contractions over all NC columns at once
// (product of t: y = Wᵀx, then W·dU/dy; sparse coding: r = patch − Φa, then
// Φᵀr; logistic regression: z = Xs·θ, then Xsᵀσ(z)) through contract() at
// the instance's precision P, whose epilogues write the intermediate and the
// gradient G; a two-stage step is two of them. The rest is the work of the
// chain's threads, T / CH of them (tid % CH is the chain, tid / CH the
// thread's rank r among them): the first R of them own the chain's dims in
// aligned groups of four (rank r the groups r, r + R, ...), keep the chain's
// x, v, g, the Kahan pairs and the trajectories' momenta of those dims in
// registers, run their kick-drift (writing x into X for the contractions)
// and closing kick, and draw their normals; every thread of the chain owns
// the rows r, r + T/CH, ... of the intermediate. A chain's sums (its energy:
// the rows' terms and sparse coding's and logreg's Σ over dims; ½vᵀM⁻¹v) are
// each thread's partial sum in its own order, then the partials added in
// rank order through shared memory (column_sum), so every thread of the
// chain holds the chain's scalars alike (u, h_cur, MALT's running U, h_in
// and Δ, the decision) and nothing is broadcast. A leapfrog step takes three
// barriers: after the owners' kick-drift and after each contraction; an
// iteration one more before its sums are read. MALT's per-step sums (U and
// ½vᵀM⁻¹v after the step, ½vᵀM⁻¹v after the next O-step) are put before the
// next step's kick-drift and read after its first barrier, so they cost no
// barrier of their own. Product of t's and logreg's first epilogue writes
// each row's energy term (log1p(y²/ν), softplus(z)) where the energy is
// wanted, so the transcendentals run on every thread. The contraction
// operands X, Z (and sparse coding's Y) have a row stride of NC + 4 floats,
// so the B fragments' loads hit 32 banks. The inverse mass sits in shared
// memory (rows M^-1 and sqrt(M), BR instances only).
//
// Precisions (P, JAX's names): kHighest sums each thread's 4×4 register
// tile in FP32 FMA (16 independent FMA chains per shared-memory load pair).
// kBf16x3, kBf16x2 and kDefault run hand-written mma.sync.m16n8k16 bf16 ->
// f32 passes (mma_bf16.cuh): warps own m16n8 output tiles. The parameter
// matrix is split into bf16 hi and lo once per block (load_params) and
// kept in shared memory in A-fragment order for both contractions,
// zero-padded to multiples of 16 (product of t's 36 to 48); the state
// operand (X, dU/dy, the residual, σ(z)) is split as its B fragments load,
// 0 past its last row. bf16x3 is hi·hi + (hi·lo + lo·hi) in three
// accumulators added as JAX adds them (_dot_bf16x3, :312); bf16x2 is
// hi·(hi + lo) of the state with the parameter rounded once (_dot_bf16x2,
// :337); default one pass with both operands rounded (the TPU's
// Precision.DEFAULT). The f32 copies of the parameter matrix exist only in
// the kHighest instances.
//
// What bounds it: latency, not the card's rates. At kHighest the FP32 FMA
// work of the contractions (~3.3e5 multiply-adds per chain and iteration
// for sparse coding at M=10); at the bf16 precisions the fragment loads,
// splits and mma latencies of the contractions, a chain of dependent steps
// between three barriers a step, and the owners' elementwise work. Two or
// more resident blocks an SM overlap one block's barriers with another's
// work (PERF.md §6 lists the per-phase breakdown of the PROF instances).
//
// Past one block (TileRule::kc > 0, where even the 8-column tile's Y and Z
// pass the 227 KB with the parameter matrix off chip: logreg at LIBSVM
// a9a's 124 × 32,561, sparse coding at 1,024 × 4,096) the K rows run in
// chunks: Y and Z hold one chunk, the threads add its rows' energy terms to
// their partials after its first contraction, and its share of the second
// is added into G; where even 8 columns of X and G pass the block beside a
// chunk (TileRule::xg), they and the mass live in the block's slice of
// a.scratch. At the bf16 precisions with X and G on chip (TileRule::ns >
// 0; gradient_ring) the fragments reach the tensor cores through a ring of
// ns stages in shared memory (Ring): the device buffer holds them in the
// order a gradient reads them (Stream, stream_params_kernel), each stage
// one bulk copy (cp.async.bulk) completing on an mbarrier, started by one
// thread while the warps run mma.sync on the stages that have arrived. The
// tile is wide (kRingColumns = 32 columns, so each A fragment feeds four
// mma n-tiles; NUTS's 8 chains on kRingThreads threads). The launch
// (cudaLaunchKernelEx, ClusterPlan) is chosen from the chain count: with
// few tiles (no more than the card holds clusters of two; e.g. a9a's
// control and MALT at 2,048 chains, NUTS on one tile of 8), each tile runs
// on a cluster of C CTAs alike, each taking every C-th chunk, and they add
// G's and the energy terms' partials over distributed shared memory in rank
// order after a cluster barrier (no atomics: runs repeat bit for bit), rank
// 0 alone writing device memory; else a CTA a tile. The f32 (kHighest)
// chunked tiles and the XG tiles read their chunks from device memory
// (gradient_chunks, contract_part).
//
// What bounds the ring's tiles (PERF.md §5-§6 have the byte model and the
// PROF breakdowns): a gradient streams the whole fragment set,
// 2·pad16(K)·pad16(D)·2 bytes at one bf16 copy (a9a 16.7 MB), through every
// tile's shared memory, read from L2 once a tile, or 1/C of it into each
// CTA of a split tile; the rereads grow with the tiles, a quarter as many
// as the parent's at a9a's widths. Not the bytes but the instructions set
// the pace on the H100: the first contraction's epilogue on K rows × NC
// columns (the sigmoid, the energy term where wanted, each element into
// ZB's bf16 fragments), 25-40% of a9a's cycles; the producing thread's wait
// for every warp to release a stage before it refills the slot (a barrier
// a stage); and, at 8 columns (NUTS), the mma.sync work of one n-tile an A
// fragment. They replace the same TPU kernels as the rest of this header
// (_mjhmc_mm_kernel, _mjhmc_mm_stream_kernel) on the shapes past one block.
//
// NUTS (nuts_mm_kernel, below) has its own tile and layout and shares
// load_params, contract, gradient_tile, gradient_chunks and column_sum.
//
// Random numbers: Philox4x32-10 keyed (seed, 0), laid out in philox.cuh:
// MJHMC counter (chain, iteration, block, 0), 1 + 2d words per iteration
// (word 0 picks the clock, drawn by every thread of the chain alike; words
// 1+i and 1+d+i make dim i's Box-Muller normal); NUTS tags 1-3 (momentum,
// round, leaf) as the elementwise kernel draws them; control tag 4, MALT
// tags 5 and 6, each normal from words i and d+i and the Metropolis uniform
// from word 2d. An owner of dims i..i+3 takes their words from whole
// blocks: words i..i+3 and d+i..d+i+3 are one block each (d % 4 == 0);
// MJHMC's 1+i..4+i, one word further, two each (words4). Every draw is
// keyed by (chain, iteration, slot, tag), never by the tiling, and the
// plain PyTorch version (ops/cuda_mjhmc.py) computes the same words. No
// fast-math: the Kahan sums and the plain-version comparisons need IEEE
// arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "mma_bf16.cuh"
#include "phase_clock.cuh"
#include "philox.cuh"

// Every loop over an owner's dims (or its groups of four) and over a
// column's partials unrolls fully, so that an owner's arrays live in
// registers. An on-demand instance whose X and G live in the device buffer
// (d in the thousands, 1,024 threads a block at 64 registers, the arrays
// spilled either way) defines this to leave such loops past 4 rolled
// (ondemand/mm_instance.cu), which keeps its nvcc short
#ifndef MJHMC_MM_UNROLL_OWNED
#define MJHMC_MM_UNROLL_OWNED(K) _Pragma("unroll")
#endif

namespace mjhmc {
namespace mm {

using tc::mma_bf16;
using tc::split_bf16;

constexpr float kLogRateMax = 25.0f;
constexpr float kNegInf = -1e30f;
constexpr float kTwoPi = 6.283185307179586f;

enum Energy { kProductOfT = 0, kSparseCoding = 1, kLogreg = 2 };
enum Choice { kL = 0, kF = 1, kR = 2 };
// the step bodies, numbered as the elementwise kernel's
enum Variant { kMjhmc = 0, kNuts = 1, kControl = 2, kMalt = 3 };
// the dot precisions, numbered as cuda_mjhmc.PRECISIONS
enum Precision { kHighest = 0, kBf16x3 = 1, kBf16x2 = 2, kDefault = 3 };

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr int min_of(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int gcd_of(int a, int b) { return b ? gcd_of(b, a % b) : a; }

// Shared memory on the H100: what a block may opt into (227 KB), an SM's
// (228 KB), and what an SM reserves for each resident block
constexpr int kSmemBlock = 232448, kSmemSM = 233472, kSmemReserved = 1024;

// BCSS two-stage coefficient b and 1 - 2b, rounded to float once
constexpr float kTwoStageB = 0.1931833275037836f;
constexpr float kTwoStageMid = static_cast<float>(1.0 - 2.0 * 0.1931833275037836);

struct Args {
  // product of t: W (d, k); sparse coding: Φ (p, b); logreg: Xs = −s·X (o, d)
  const float* p0;
  const float* p1;  // sparse coding: the patch (p,)
  // product of t: ν+1, ν, ½(ν+1), 1/ν; sparse coding: λ, σ⁻², ½σ⁻², ε;
  // logreg: 1/σ₀², ½/σ₀²
  float k0, k1, k2, k3;
  const float *x, *v, *g, *u, *h_back, *valid;
  float *xo, *vo, *go, *uo, *hbo, *valido, *w, *wx, *wx2;
  int* evals;
  float *xs, *ws;  // stream emissions (EMIT only)
  int* es;
  int n, num_iters, thin, m, fixed_uniform;
  uint32_t seed;
  float eps, beta;
  const float* mass;  // (2, d): M^-1 and sqrt(M), or nullptr (identity)
  int two_stage;
  float* scratch;  // NUTS: the chains' tree state, (nuts::rows(m), d, n), where it is not
  // kept in shared memory (NutsTile::ONCHIP)
  // PROF instances: per block and observer, the cycles of each phase
  unsigned long long* prof;
};

// The presets' shapes, one per energy, which the library is compiled for: D
// state dims, K rows of the intermediate (product of t: nbasis; sparse
// coding: npixels; logreg: nobs). Every kernel takes its (D, K) as template
// arguments; any other shape is an on-demand instance (ondemand/mm_instance.cu)
template <int E> struct Shape;
template <> struct Shape<kProductOfT> { static constexpr int D = 36, K = 36; };
template <> struct Shape<kSparseCoding> { static constexpr int D = 128, K = 64; };
template <> struct Shape<kLogreg> { static constexpr int D = 16, K = 256; };

// The parameter matrix at (D, K), in floats: at kHighest two f32 copies
// (contraction 1's A1 [D][K4]: W | Φᵀ | Xsᵀ, contraction 2's A2 [K][D4]: Wᵀ |
// Φ | Xs, their rows padded with zeros to multiples of four for the float4
// tiles), kF32_1 and kF32_2; at the bf16 precisions none, and the A fragments
// instead, in 32-bit words: contraction 1's hi, contraction 2's hi, then
// (bf16x3) the two lo copies, kWords each (kFrag in all), zero past D and K.
// They sit in shared memory, or (OFF, where they do not fit there) in a
// device buffer of kFloats built once a launch (params_kernel).
template <int D, int K, int P>
struct Params {
  static constexpr int D4 = round_up(D, 4), K4 = round_up(K, 4);
  static constexpr int kF32_1 = P == kHighest ? D * K4 : 0;
  static constexpr int kF32_2 = P == kHighest ? K * D4 : 0;
  static constexpr int kWords = pad16(K) * pad16(D) / 2;  // one copy of one contraction
  static constexpr int kCopies = P == kHighest ? 0 : P == kBf16x3 ? 2 : 1;
  static constexpr int kFrag = 2 * kCopies * kWords;
  static constexpr int kFloats = kF32_1 + kF32_2 + kFrag;
};

// out[r][col] = Σ_k A[k][r]·B[k][col] for r < R, col < NC, handed to
// epi(r, col, value) element by element: A is [KD][R], B is [KD][NC] with
// row stride LDB (≥ NC), both row-major f32 in shared memory.
//
// kHighest: each task sums a 4×4 tile in registers in FP32 FMA. With STUB
// the sum is replaced by 1e-3·B[0][col] on every row (MatmulEnergySpec._dot's
// stub_dots ablation): the tiles, epilogues and barriers stay, the
// multiply-adds go.
//
// The bf16 precisions: warp w takes m16n8 output tiles w, w + T/32, ...
// (two at a time where they share their n-tile);
// AH (and AL, bf16x3) hold A as bf16 A fragments, the (m-tile, k-tile)
// fragment at uint4 (mt·KT + kt)·32 + lane (load_params); B's fragments
// are split from f32 as they load, 0 past row KD (with LDB ≡ 4 mod 8 a
// load's 32 lanes, rows 2q apart and columns g apart, hit 32 banks). Output
// rows past R (the padding) are dropped.
template <int KD, int R, int NC, int LDB, int T, bool STUB, int P, class Epi>
__device__ __forceinline__ void contract(const float* __restrict__ A,
                                         const uint32_t* __restrict__ AH,
                                         const uint32_t* __restrict__ AL,
                                         const float* __restrict__ B, Epi epi) {
  if constexpr (P == kHighest || STUB) {
    constexpr int CG = NC / 4, TASKS = (R / 4) * CG;
    for (int task = threadIdx.x; task < TASKS; task += T) {
      const int r0 = (task / CG) * 4, c0 = (task % CG) * 4;
      float acc[4][4] = {};
      if constexpr (STUB) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = B[c0 + j] * 1e-3f;
      } else {
#pragma unroll 4
        for (int k = 0; k < KD; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(A + k * R + r0);
          const float4 b = *reinterpret_cast<const float4*>(B + k * LDB + c0);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r0 + i, c0 + j, acc[i][j]);
    }
  } else {
    constexpr int MT = pad16(R) / 16, KT = pad16(KD) / 16, NT = NC / 8, W = T / 32;
    static_assert(NC % 8 == 0, "n-tiles of 8 columns");
    // where all of a warp's tiles share one n-tile (W % NT == 0) and come in
    // pairs, the warp runs its m-tiles two at a time and loads and splits
    // each B fragment once for both
    constexpr int MP = W % NT == 0 && MT % (2 * (W / NT)) == 0 ? 2 : 1;
    constexpr int kUnroll = MP == 1 ? 2 : 1;
    const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const uint4* AH4 = reinterpret_cast<const uint4*>(AH);
    const uint4* AL4 = reinterpret_cast<const uint4*>(AL);
    for (int tile = threadIdx.x / 32; tile < MT * NT; tile += MP * W) {
      const int nt = tile % NT, col = nt * 8 + g;
      int mts[MP];
#pragma unroll
      for (int p = 0; p < MP; ++p) mts[p] = tile / NT + p * (W / NT);
      float hh[MP][4] = {}, hl[MP][4] = {}, lh[MP][4] = {};
      auto b_at = [&](int k) { return k < KD ? B[k * LDB + col] : 0.f; };
#pragma unroll kUnroll
      for (int kt = 0; kt < KT; ++kt) {
        const int k = 16 * kt + 2 * q;
        uint32_t bh0, bl0, bh1, bl1;
        split_bf16(b_at(k), b_at(k + 1), bh0, bl0);
        split_bf16(b_at(k + 8), b_at(k + 9), bh1, bl1);
#pragma unroll
        for (int p = 0; p < MP; ++p) {
          const uint4 av = AH4[(mts[p] * KT + kt) * 32 + lane];
          const uint32_t ah[4] = {av.x, av.y, av.z, av.w};
          mma_bf16(hh[p], ah, bh0, bh1);
          if constexpr (P != kDefault) mma_bf16(hl[p], ah, bl0, bl1);
          if constexpr (P == kBf16x3) {
            const uint4 lv = AL4[(mts[p] * KT + kt) * 32 + lane];
            const uint32_t al[4] = {lv.x, lv.y, lv.z, lv.w};
            mma_bf16(lh[p], al, bh0, bh1);
          }
        }
      }
      // rows g and g+8 of each m-tile, columns 2q and 2q+1 of the n-tile
#pragma unroll
      for (int p = 0; p < MP; ++p)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = 16 * mts[p] + g + 8 * (h >> 1), c = nt * 8 + 2 * q + (h & 1);
          float v = hh[p][h];
          if constexpr (P == kBf16x3) v = hh[p][h] + (hl[p][h] + lh[p][h]);
          if constexpr (P == kBf16x2) v = hh[p][h] + hl[p][h];
          if (r < R) epi(r, c, v);
        }
    }
  }
}

__device__ __forceinline__ float log_rate(float h_to, float h_cur) {
  const float raw = -0.5f * (h_to - h_cur);
  const bool ok = fabsf(h_to) < 1e30f && h_to == h_to;
  // written so a NaN raw stays NaN, as jnp.minimum keeps it
  return ok ? (raw > kLogRateMax ? kLogRateMax : raw) : kNegInf;
}

__device__ __forceinline__ void kadd(float& s, float& c, float inc) {
  const float y = inc - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Box-Muller's cosine branch, sqrt(-2 ln u1)·cos(2π u2), times sqrt(M)
__device__ __forceinline__ float box_muller(float u1, float u2, float sqrt_m) {
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2) * sqrt_m;
}

// Box-Muller normal of dim i for a chain: words i and D+i of the family
// tag's draw starting at slot slot0, times sqrt(M)
template <int D>
__device__ __forceinline__ float normal_of(const Args& a, uint32_t chain, uint32_t t,
                                           int i, uint32_t tag, uint32_t slot0,
                                           float sqrt_m, uint2 key) {
  const float u1 = a.fixed_uniform ? 0x1p-25f
                                   : philox_uniform(philox_word(chain, t, i, key, tag, slot0));
  const float u2 = a.fixed_uniform
      ? 0x1p-25f
      : philox_uniform(philox_word(chain, t, D + i, key, tag, slot0));
  return box_muller(u1, u2, sqrt_m);
}

// The uniforms of words w..w+3 of a chain's draw of family tag starting at
// slot slot0, where w % 4 == OFF: from one Philox block (OFF 0) or two
// (every 2⁻²⁵ in fixed-uniform mode)
template <int OFF>
__device__ __forceinline__ void uniforms4(const Args& a, uint32_t chain, uint32_t t, int w,
                                          uint32_t tag, uint32_t slot0, uint2 key,
                                          float (&u)[4]) {
  if (a.fixed_uniform) {
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = 0x1p-25f;
    return;
  }
  const uint32_t slot = slot0 + (uint32_t)(w - OFF) / 4;
  const uint4 b0 = philox4x32_10(make_uint4(chain, t, slot, tag), key);
  uint4 b1 = b0;
  if constexpr (OFF != 0) b1 = philox4x32_10(make_uint4(chain, t, slot + 1, tag), key);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = philox_uniform(j + OFF < 4 ? word_of(b0, j + OFF) : word_of(b1, j + OFF - 4));
}

// The normals of dims i..i+3 (i % 4 == 0) of a chain, dim i + j's from
// words w0 + i + j and w0 + D + i + j of the family tag's draw at slot
// slot0 (w0: 0, or MJHMC's 1), times sqrt(M) of each (sqm; nullptr: 1).
// PAD: the owners' dims run past D (a padded tile), whose normals are 0, so
// a padded dim draws no momentum
template <int D, int W0, bool PAD = false>
__device__ __forceinline__ void normals4(const Args& a, uint32_t chain, uint32_t t, int i,
                                         uint32_t tag, uint32_t slot0, const float* sqm,
                                         uint2 key, float (&z)[4]) {
  float u1[4], u2[4];
  uniforms4<W0 % 4>(a, chain, t, W0 + i, tag, slot0, key, u1);
  uniforms4<(W0 + D) % 4>(a, chain, t, W0 + D + i, tag, slot0, key, u2);
#pragma unroll
  for (int j = 0; j < 4; ++j) z[j] = box_muller(u1[j], u2[j], sqm ? sqm[i + j] : 1.f);
  if constexpr (PAD)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = i + j < D ? z[j] : 0.f;
}

// A[k][m] of contraction c (1: A1, K rows m of D deep; 2: A2, D rows of K
// deep) read from p0, 0 in the padding
template <int E, int D, int K>
__device__ __forceinline__ float param_at(const Args& a, int c, int m, int k) {
  if (m >= (c == 1 ? K : D) || k >= (c == 1 ? D : K)) return 0.f;
  if constexpr (E == kProductOfT)  // p0 = W (D, K): A1[k][m] = W[k][m], A2[k][m] = W[m][k]
    return c == 1 ? a.p0[k * K + m] : a.p0[m * K + k];
  else  // p0 = Φ or Xs (K, D): A1[k][m] = Φ[m][k], A2[k][m] = Φ[k][m]
    return c == 1 ? a.p0[m * D + k] : a.p0[k * D + m];
}

// The parameter matrix (Params) in both orientations at any (D, K): P
// kHighest f32 at A1 [D][K4] and A2 [K][D4], their padding 0; otherwise the
// bf16 A fragments of both contractions at frag, words start, start +
// stride, ... (a block's threads, or params_kernel's grid)
template <int E, int D, int K, int P>
__device__ __forceinline__ void fill_params(const Args& a, float* A1, float* A2, uint32_t* frag,
                                            int start, int stride) {
  using PL = Params<D, K, P>;
  if constexpr (P == kHighest) {
    for (int idx = start; idx < PL::kF32_1 + PL::kF32_2; idx += stride) {
      if (idx < PL::kF32_1)
        A1[idx] = param_at<E, D, K>(a, 1, idx % PL::K4, idx / PL::K4);
      else
        A2[idx - PL::kF32_1] = param_at<E, D, K>(a, 2, (idx - PL::kF32_1) % PL::D4,
                                                 (idx - PL::kF32_1) / PL::D4);
    }
  } else {
    // word w of contraction c: register h of lane (g, q) of fragment
    // (mt, kt), holding A[k][m], A[k+1][m] (contract's A-fragment order)
    constexpr int W = PL::kWords;
    for (int w = start; w < 2 * W; w += stride) {
      const int c = w < W ? 1 : 2, wi = w % W;
      const int kt_count = pad16(c == 1 ? D : K) / 16;
      const int h = wi % 4, lane = (wi / 4) % 32, blk = wi / 128;
      const int mt = blk / kt_count, kt = blk % kt_count, g = lane / 4, q = lane % 4;
      const int m = 16 * mt + g + 8 * (h & 1), k = 16 * kt + 8 * (h >> 1) + 2 * q;
      uint32_t hi, lo;
      split_bf16(param_at<E, D, K>(a, c, m, k), param_at<E, D, K>(a, c, m, k + 1), hi, lo);
      frag[w] = hi;
      if constexpr (P == kBf16x3) frag[2 * W + w] = lo;
    }
  }
}

// The parameter matrix into a device buffer (the OFF instances': a.scratch,
// Params::kFloats), once a launch, before the kernel that reads it
template <int E, int D, int K, int P>
__global__ void __launch_bounds__(256) params_kernel(Args a) {
  using PL = Params<D, K, P>;
  fill_params<E, D, K, P>(a, a.scratch, a.scratch + PL::kF32_1,
                          reinterpret_cast<uint32_t*>(a.scratch),
                          blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}
template <int E, int D, int K, int P>
cudaError_t launch_params(const Args& a, cudaStream_t stream) {
  if (!a.scratch) return cudaErrorInvalidValue;
  const int blocks = min_of(cdiv(Params<D, K, P>::kFloats, 256), 1024);
  params_kernel<E, D, K, P><<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// The parameter matrix in both orientations (P kHighest: f32 at A1, A2;
// otherwise bf16 A fragments of both contractions at frag; OFF: neither,
// they are in the device buffer), the patch (where patch is not nullptr;
// K4 rows, 0 past K) and the mass (BR; M^-1 at IM[0, DP), sqrt(M) at
// IM[DP, 2DP), 1 on the padded dims past D) into the block's shared memory,
// then a barrier.
template <int E, int D, int K, int DP, int T, bool BR, int P, bool OFF = false>
__device__ __forceinline__ void load_params(const Args& a, float* A1, float* A2, float* patch,
                                            float* IM, uint32_t* frag) {
  const int tid = threadIdx.x;
  constexpr int K4 = round_up(K, 4);
  // a padded tile or the parameter matrix in device memory; else the
  // presets' code as it has always been (the library's SASS is held to the
  // parent's)
  if constexpr (OFF || DP != D || K4 != K) {
    if constexpr (!OFF) fill_params<E, D, K, P>(a, A1, A2, frag, tid, T);
    if (E == kSparseCoding && patch)
      for (int idx = tid; idx < K4; idx += T) patch[idx] = idx < K ? a.p1[idx] : 0.f;
    if (BR)
      for (int idx = tid; idx < 2 * DP; idx += T) {
        const int i = idx % DP;
        IM[idx] = a.mass && i < D ? a.mass[(idx / DP) * D + i] : 1.f;
      }
  } else {
    if constexpr (P == kHighest) {
      for (int idx = tid; idx < D * K; idx += T) {
        const float val = a.p0[idx];
        if constexpr (E == kProductOfT) {  // p0 = W (D, K)
          A1[idx] = val;
          A2[(idx % K) * D + idx / K] = val;
        } else {  // p0 = Φ or Xs (K, D)
          A2[idx] = val;
          A1[(idx % D) * K + idx / D] = val;
        }
      }
    } else {
      fill_params<E, D, K, P>(a, A1, A2, frag, tid, T);
    }
    if (E == kSparseCoding && patch)
      for (int idx = tid; idx < K; idx += T) patch[idx] = a.p1[idx];
    if (BR)
      for (int idx = tid; idx < 2 * D; idx += T) IM[idx] = a.mass ? a.mass[idx] : 1.f;
  }
  __syncthreads();
}

// The gradient epilogues' arithmetic: RN rounds every operation on its own,
// as the plain version does (NUTS); otherwise nvcc may fuse a product into
// the sum that follows it (mm_kernel's bodies)
template <bool RN>
__device__ __forceinline__ float mul_(float x, float y) {
  if constexpr (RN) return __fmul_rn(x, y); else return x * y;
}
template <bool RN>
__device__ __forceinline__ float add_(float x, float y) {
  if constexpr (RN) return __fadd_rn(x, y); else return x + y;
}
template <bool RN>
__device__ __forceinline__ float sub_(float x, float y) {
  if constexpr (RN) return __fsub_rn(x, y); else return x - y;
}
template <bool RN>
__device__ __forceinline__ float div_(float x, float y) {
  if constexpr (RN) return __fdiv_rn(x, y); else return x / y;
}

// g = ∇U(X) on all columns by the energy's two contractions at precision P
// (frag: the bf16 fragments). Contraction 1's epilogue writes r into Y
// (sparse coding), or dU/dy or σ(z) into Z and into Y y or z (TERMS false:
// NUTS) or, where want_u, the row's energy term log1p(y²/ν) or softplus(z)
// (TERMS true: mm_kernel); then between() (a barrier); then contraction 2's
// epilogue writes the gradient into G. X, Z and sparse coding's Y (the
// contraction operands) have row stride LD, G and the other Y NC. At any
// (D, K) the contractions run D and K deep and write K4 and D4 rows (the
// float4 tiles' padding; A's padded columns are 0, so are those rows of y,
// r and the gradient; the caller masks logreg's softplus(0) and σ(0) on
// them where it reads them).
template <int E, int D, int K, int NC, int LD, int T, bool STUB, int P, bool RN, bool TERMS,
          class Between>
__device__ __forceinline__ void gradient_tile(const float* A1, const float* A2,
                                              const uint32_t* frag, const float* patch,
                                              const float* X, float* Y, float* Z, float* G,
                                              const Args& a, bool want_u, Between between) {
  // hi and lo fragments of contraction 1 (A1) and 2 (A2)
  using PL = Params<D, K, P>;
  constexpr int W = PL::kWords, K4 = PL::K4, D4 = PL::D4;
  const uint32_t *h1 = frag, *h2 = frag + W, *l1 = frag + 2 * W, *l2 = frag + 3 * W;
  if constexpr (E == kProductOfT) {
    // y = Wᵀx and dU/dy = (ν+1)·y/(ν + y²); g = W·dU/dy
    contract<D, K4, NC, LD, T, STUB, P>(A1, h1, l1, X, [&](int r, int c, float y) {
      if constexpr (!TERMS)
        Y[r * NC + c] = y;
      else if (want_u)
        Y[r * NC + c] = log1pf(y * y * a.k3);
      Z[r * LD + c] = div_<RN>(mul_<RN>(a.k0, y), add_<RN>(a.k1, mul_<RN>(y, y)));
    });
    between();
    contract<K, D4, NC, LD, T, STUB, P>(A2, h2, l2, Z,
                                       [&](int r, int c, float gv) { G[r * NC + c] = gv; });
  } else if constexpr (E == kSparseCoding) {
    // r = patch − Φa; g = λ·a/√(a²+ε) − σ⁻²·Φᵀr
    contract<D, K4, NC, LD, T, STUB, P>(A1, h1, l1, X, [&](int r, int c, float v) {
      if constexpr (K4 == K)
        Y[r * LD + c] = sub_<RN>(patch[r], v);
      else  // the padded rows' residual 0
        Y[r * LD + c] = sub_<RN>(r < K ? patch[r] : 0.f, v);
    });
    between();
    contract<K, D4, NC, LD, T, STUB, P>(A2, h2, l2, Y, [&](int r, int c, float v) {
      const float av = X[r * LD + c];
      const float s = sqrtf(add_<RN>(mul_<RN>(av, av), a.k3));
      G[r * NC + c] = sub_<RN>(mul_<RN>(a.k0, div_<RN>(av, s)), mul_<RN>(a.k1, v));
    });
  } else {
    // z = Xs·θ and σ(z); g = Xsᵀσ(z) + θ/σ₀²
    contract<D, K4, NC, LD, T, STUB, P>(A1, h1, l1, X, [&](int r, int c, float z) {
      if constexpr (!TERMS)
        Y[r * NC + c] = z;
      else if (want_u)  // softplus(z) = max(z, 0) + log1p(e^{−|z|})
        Y[r * NC + c] = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
      Z[r * LD + c] = div_<RN>(1.0f, add_<RN>(1.0f, expf(-z)));
    });
    between();
    contract<K, D4, NC, LD, T, STUB, P>(A2, h2, l2, Z, [&](int r, int c, float v) {
      G[r * NC + c] = add_<RN>(v, mul_<RN>(X[r * LD + c], a.k0));
    });
  }
}

// contract() over a part of the product, for the chunked tiles (KC > 0):
// out[r][col] = Σ_{k < kn} A[k0 + k][r]·B[k][col] for rows r in [m0, m0 +
// mn), col < NC, handed to epi(r, col, value). A is [·][RA] f32 (kHighest;
// m0 and mn multiples of 4) or the bf16 A fragments of a contraction whose
// depth has KTA k-tiles (k0 a multiple of 16, m0 of 16), read-only in the
// launch; B is [kn][LDB] (row k of the part at k·LDB), 0 past row kn. B may
// be rows that this launch writes in device memory (X off chip), so it is
// read with plain coherent loads, never through a read-only path. A thread
// gets the same (r, col) elements for the same (m0, mn) on every call, so
// an element summed over several parts is added by one thread, in part
// order.
template <int RA, int KTA, int NC, int LDB, int T, int P, class Epi>
__device__ __forceinline__ void contract_part(const float* __restrict__ A,
                                              const uint32_t* __restrict__ AH,
                                              const uint32_t* __restrict__ AL, const float* B,
                                              int m0, int mn, int k0, int kn, Epi epi) {
  if constexpr (P == kHighest) {
    constexpr int CG = NC / 4;
    const int tasks = (mn / 4) * CG;
    for (int task = threadIdx.x; task < tasks; task += T) {
      const int r0 = m0 + (task / CG) * 4, c0 = (task % CG) * 4;
      float acc[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(A + (size_t)(k0 + k) * RA + r0);
        const float4 bv = *reinterpret_cast<const float4*>(B + (size_t)k * LDB + c0);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r0 + i, c0 + j, acc[i][j]);
    }
  } else {
    constexpr int NT = NC / 8, W = T / 32;
    static_assert(NC % 8 == 0, "n-tiles of 8 columns");
    const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const int mt0 = m0 / 16, kt0 = k0 / 16;
    const int mts = cdiv(m0 + mn, 16) - mt0, kts = cdiv(k0 + kn, 16) - kt0;
    const uint4* AH4 = reinterpret_cast<const uint4*>(AH);
    const uint4* AL4 = reinterpret_cast<const uint4*>(AL);
    for (int tile = threadIdx.x / 32; tile < mts * NT; tile += W) {
      const int nt = tile % NT, mt = mt0 + tile / NT, col = nt * 8 + g;
      float hh[4] = {}, hl[4] = {}, lh[4] = {};
      auto b_at = [&](int k) { return k < kn ? B[(size_t)k * LDB + col] : 0.f; };
      for (int kt = 0; kt < kts; ++kt) {
        const int k = 16 * kt + 2 * q;
        uint32_t bh0, bl0, bh1, bl1;
        split_bf16(b_at(k), b_at(k + 1), bh0, bl0);
        split_bf16(b_at(k + 8), b_at(k + 9), bh1, bl1);
        const size_t at = ((size_t)mt * KTA + kt0 + kt) * 32 + lane;
        const uint4 av = AH4[at];
        const uint32_t ah[4] = {av.x, av.y, av.z, av.w};
        // each k-tile's 16 products into zeroed accumulators, then added in
        // round-to-nearest: mma.sync's own f32 accumulation truncates, and
        // carried through the hundreds or thousands of k-tiles of these
        // depths it biases the sums (sparse coding 1,024 × 4,096's energy by
        // ~1e-5 relative, the same sign on every chain)
        float th[4] = {}, tl[4] = {}, tm[4] = {};
        mma_bf16(th, ah, bh0, bh1);
        if constexpr (P != kDefault) mma_bf16(tl, ah, bl0, bl1);
        if constexpr (P == kBf16x3) {
          const uint4 lv = AL4[at];
          const uint32_t al[4] = {lv.x, lv.y, lv.z, lv.w};
          mma_bf16(tm, al, bh0, bh1);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          hh[h] += th[h];
          if constexpr (P != kDefault) hl[h] += tl[h];
          if constexpr (P == kBf16x3) lh[h] += tm[h];
        }
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = 16 * mt + g + 8 * (h >> 1), c = nt * 8 + 2 * q + (h & 1);
        float v = hh[h];
        if constexpr (P == kBf16x3) v = hh[h] + (hl[h] + lh[h]);
        if constexpr (P == kBf16x2) v = hh[h] + hl[h];
        if (r < m0 + mn) epi(r, c, v);
      }
    }
  }
}

// gradient_tile for the chunked tiles (KC > 0; the parameter matrix in the
// device buffer): the K rows of the intermediate in chunks of KC, each
// chunk's contraction 1 (rows k0..k0+KC of y, r or z, D deep) writing its
// rows of Y and Z (row k0 + j at row j; strides LDY, LDZ), then between()
// (a barrier), rows(k0) (the threads' reads of the chunk's energy terms),
// and its share of contraction 2 (KC deep) added into G (stride NC) by the
// thread that owns each element in every chunk, in chunk order (no
// atomics: runs repeat bit for bit); the last chunk's epilogue finishes the
// gradient as gradient_tile's does. after() (a barrier) comes between two
// chunks, so the next chunk overwrites Y and Z only once every thread is
// done with them; the caller's barrier follows the last. X has row stride
// LDX; X and G may lie in device memory (the XG tiles), so neither is read
// through a read-only path. patch: sparse coding's K rows (device memory).
template <int E, int D, int K, int KC, int NC, int LDX, int LDY, int LDZ, int T, int P, bool RN,
          bool TERMS, class Rows, class Between, class After>
__device__ __forceinline__ void gradient_chunks(const float* A1, const float* A2,
                                                const uint32_t* frag, const float* patch,
                                                const float* X, float* Y, float* Z, float* G,
                                                const Args& a, bool want_u, Rows rows,
                                                Between between, After after) {
  using PL = Params<D, K, P>;
  constexpr int W = PL::kWords, K4 = PL::K4, D4 = PL::D4;
  constexpr int KT1 = pad16(D) / 16, KT2 = pad16(K) / 16;
  constexpr int LDB = E == kSparseCoding ? LDY : LDZ;  // contraction 2's operand
  static_assert(KC % 16 == 0, "a chunk of whole k-tiles");
  const uint32_t *h1 = frag, *h2 = frag + W, *l1 = frag + 2 * W, *l2 = frag + 3 * W;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min_of(KC, K - k0), mn = min_of(KC, K4 - k0);
    const bool first = k0 == 0, last = k0 + KC >= K;
    contract_part<K4, KT1, NC, LDX, T, P>(A1, h1, l1, X, k0, mn, 0, D,
                                          [&](int rg, int c, float v) {
      const int rl = rg - k0;
      if constexpr (E == kProductOfT) {  // y, log1p(y²/ν) where wanted, dU/dy
        if constexpr (!TERMS)
          Y[rl * LDY + c] = v;
        else if (want_u)
          Y[rl * LDY + c] = log1pf(v * v * a.k3);
        Z[rl * LDZ + c] = div_<RN>(mul_<RN>(a.k0, v), add_<RN>(a.k1, mul_<RN>(v, v)));
      } else if constexpr (E == kSparseCoding) {  // the residual, 0 on padded rows
        Y[rl * LDY + c] = sub_<RN>(rg < K ? patch[rg] : 0.f, v);
      } else {  // z, softplus(z) where wanted, σ(z)
        if constexpr (!TERMS)
          Y[rl * LDY + c] = v;
        else if (want_u)
          Y[rl * LDY + c] = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
        Z[rl * LDZ + c] = div_<RN>(1.0f, add_<RN>(1.0f, expf(-v)));
      }
    });
    between();
    rows(k0);
    contract_part<D4, KT2, NC, LDB, T, P>(A2, h2, l2, E == kSparseCoding ? Y : Z, 0, D4, k0, kn,
                                          [&](int rg, int c, float v) {
      float s = first ? v : add_<RN>(G[rg * NC + c], v);
      if (last) {
        if constexpr (E == kSparseCoding) {  // λ·a/√(a²+ε) − σ⁻²·Φᵀr
          const float av = X[rg * LDX + c];
          const float sq = sqrtf(add_<RN>(mul_<RN>(av, av), a.k3));
          s = sub_<RN>(mul_<RN>(a.k0, div_<RN>(av, sq)), mul_<RN>(a.k1, s));
        } else if constexpr (E == kLogreg) {  // Xsᵀσ(z) + θ/σ₀²
          s = add_<RN>(s, mul_<RN>(X[rg * LDX + c], a.k0));
        }
      }
      G[rg * NC + c] = s;
    });
    if (!last) after();
  }
}

// ---------------------------------------------------------------------------
// The chunked tiles at the bf16 precisions (TileRule::kc > 0, ns > 0): a
// cluster of C CTAs and a ring of chunks of the parameter matrix in shared
// memory. Thread block clusters, mbarriers and bulk copies, in PTX.
namespace cl {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// the cluster barrier: every thread of every CTA arrives (release) and
// waits (acquire); arrive and wait alternate in each thread
__device__ __forceinline__ void arrive() { asm volatile("barrier.cluster.arrive;" ::: "memory"); }
__device__ __forceinline__ void wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }
__device__ __forceinline__ void sync() {
  arrive();
  wait();
}
// a float of CTA r's shared memory at the offset of p in this one (read
// between cluster barriers, which order them; the compiler may batch those
// loads)
__device__ __forceinline__ float ld_f32(const float* p, uint32_t r) {
  uint32_t ra;
  float v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(smem_addr(p)), "r"(r));
  asm("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(ra));
  return v;
}
__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}
// this phase's arrival of the barrier's one local arriver, and the bytes the
// copies that complete it bring
__device__ __forceinline__ void bar_arm(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}
// an arrival on the barrier; it releases this thread's reads of the
// stage's slot
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(b))
      : "memory");
}
// wait until the phase of the given parity has completed; a wait past ~10 s
// (2^34 cycles) traps, so that a fault in the ring ends the launch with an
// error instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_addr(b);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) asm volatile("trap;");
  } while (!done);
}
// bytes from global src into this CTA's shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace cl

// The ring's stages: a stage holds, for one round of the warps (warp w the
// round's m-tile w) and up to SK consecutive k-tiles, the bf16 A fragments
// of a contraction (hi, then lo at bf16x3), 512 bytes each. SK fills
// kStageBytes at the tile's warps (at least one k-tile); a tile keeps 2 to
// kMaxStages of them in flight
constexpr int kStageBytes = 16384, kMaxStages = 4, kMinStages = 2;
__host__ __device__ constexpr int frag_copies(int P) {
  return P == kHighest ? 0 : P == kBf16x3 ? 2 : 1;
}
__host__ __device__ constexpr int stage_k(int T, int P) {
  return max_of(1, kStageBytes / (T / 32 * 512 * max_of(frag_copies(P), 1)));
}
__host__ __device__ constexpr int stage_words(int T, int P) {
  return T / 32 * stage_k(T, P) * frag_copies(P) * 128;
}

// The chunked instances' fragments in the device buffer, in the order a
// gradient reads them (stream_params_kernel writes them so, once a launch):
// chunk after chunk of KC rows of K, each its contraction 1 (m-tiles over
// the chunk's rows, k-tiles over D) then its contraction 2 (m-tiles over
// D, k-tiles over the chunk's rows); a contraction in rounds of W m-tiles,
// a round in blocks of SK k-tiles, a block [copy][k-tile][m-tile of the
// round] of 512-byte fragments: so each stage is one contiguous bulk copy
template <int D, int K, int KC, int T, int P>
struct Stream {
  static constexpr int W = T / 32, CP = frag_copies(P), SK = stage_k(T, P);
  static constexpr int MTD = pad16(D) / 16, MTK = pad16(K) / 16, TQF = KC / 16,
                       NQ = cdiv(K, KC);
  static_assert(KC % 16 == 0 && CP > 0, "a ring of bf16 fragments, chunks of whole k-tiles");
  // chunk q's k-row tiles (its last is ragged)
  __host__ __device__ static constexpr int tiles(int q) { return min_of(TQF, MTK - q * TQF); }
  // the first fragment of stage (q, seg, round i, block b), and its count
  __host__ __device__ static constexpr size_t at(int q, int seg, int i, int b) {
    const int tq = tiles(q), rows = seg ? MTD : tq, depth = seg ? tq : MTD;
    const int wi = min_of(W, rows - i * W);
    return (size_t)q * 2 * TQF * MTD * CP + (seg ? (size_t)tq * MTD * CP : 0) +
           ((size_t)i * W * depth + (size_t)b * wi * SK) * CP;
  }
  __host__ __device__ static constexpr int frags(int q, int seg, int i, int b) {
    const int tq = tiles(q), rows = seg ? MTD : tq, depth = seg ? tq : MTD;
    return min_of(W, rows - i * W) * min_of(SK, depth - b * SK) * CP;
  }
  // the fragment (copy cp) of contraction c's (m-tile mt, k-tile kt)
  __host__ __device__ static constexpr size_t of(int c, int mt, int kt, int cp) {
    const int kq = c == 1 ? mt : kt, q = kq / TQF, t = kq % TQF, tq = tiles(q);
    const int m = c == 1 ? t : mt, k = c == 1 ? kt : t;
    const int rows = c == 1 ? tq : MTD, depth = c == 1 ? MTD : tq;
    const int i = m / W, w = m % W, wi = min_of(W, rows - i * W);
    const int b = k / SK, kk = k % SK, sb = min_of(SK, depth - b * SK);
    return at(q, c - 1, i, b) + (size_t)(cp * sb + kk) * wi + w;
  }
};

// The parameter matrix's fragments into the device buffer in Stream order
// (the chunked instances' params_kernel), once a launch
template <int E, int D, int K, int P, int KC, int T>
__global__ void __launch_bounds__(256) stream_params_kernel(Args a) {
  using S = Stream<D, K, KC, T, P>;
  constexpr int W = Params<D, K, P>::kWords;
  uint32_t* frag = reinterpret_cast<uint32_t*>(a.scratch);
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < 2 * W; w += gridDim.x * blockDim.x) {
    const int c = w < W ? 1 : 2, wi = w % W;
    const int kt_count = pad16(c == 1 ? D : K) / 16;
    const int h = wi % 4, lane = (wi / 4) % 32, blk = wi / 128;
    const int mt = blk / kt_count, kt = blk % kt_count, g = lane / 4, q = lane % 4;
    const int m = 16 * mt + g + 8 * (h & 1), k = 16 * kt + 8 * (h >> 1) + 2 * q;
    uint32_t hi, lo;
    split_bf16(param_at<E, D, K>(a, c, m, k), param_at<E, D, K>(a, c, m, k + 1), hi, lo);
    frag[S::of(c, mt, kt, 0) * 128 + lane * 4 + h] = hi;
    if constexpr (P == kBf16x3) frag[S::of(c, mt, kt, 1) * 128 + lane * 4 + h] = lo;
  }
}

// The ring of NS stages in a CTA's shared memory: full[s] completes when
// stage s's bytes have arrived, empty[s] when every warp of the CTA has
// released it. Every thread counts the stages it has taken (g); thread 0
// arms and copies the stage NS ahead, so up to NS stages are in flight. A
// gradient's stages are copied only once it has begun (a NUTS leaf may not
// run), so the ring drains at each gradient's end. The launch's cluster
// (csize CTAs, read from the launch) is 1, or the CTAs that split one tile.
template <int D, int K, int KC, int T, int P, int NS>
struct Ring {
  using S = Stream<D, K, KC, T, P>;
  static constexpr int SW4 = stage_words(T, P) / 4;  // a slot's uint4
  uint64_t* full;
  uint64_t* empty;
  uint4* slots;
  const uint4* stream;  // the device buffer's fragments
  uint32_t g = 0, armed = 0, rank = 0, csize = 1;
  // thread 0: the next stage to arm (chunk, segment, round, block) and the
  // chunk step
  int q = 0, seg = 0, i = 0, b = 0, step = 1;

  // the barriers, before any copy or arrival reaches them
  __device__ __forceinline__ void init(float* base, const float* params) {
    slots = reinterpret_cast<uint4*>(base);
    full = reinterpret_cast<uint64_t*>(base + NS * 4 * SW4);
    empty = full + NS;
    stream = reinterpret_cast<const uint4*>(params);
    rank = cl::rank();
    csize = cl::size();
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS; ++s) {
        cl::bar_init(full + s, 1);
        cl::bar_init(empty + s, T / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // thread 0: arm and copy the next stage of the gradient, once every warp
  // has released its slot
  __device__ __forceinline__ void produce() {
    if (q >= S::NQ) return;
    const uint32_t s = armed % NS;
    const uint32_t bytes = S::frags(q, seg, i, b) * 512u;
    cl::bar_arm(full + s, bytes);
    if (armed >= (uint32_t)NS) cl::bar_wait(empty + s, (armed / NS - 1) & 1);
    cl::bulk_copy(slots + s * SW4, stream + S::at(q, seg, i, b) * 32, bytes, full + s);
    ++armed;
    const int tq = S::tiles(q);
    if (++b < cdiv(seg ? tq : S::MTD, S::SK)) return;
    b = 0;
    if (++i < cdiv(seg ? S::MTD : tq, S::W)) return;
    i = 0;
    if (++seg < 2) return;
    seg = 0;
    q += step;
  }
  // a gradient's start: its first stages (this CTA's chunks first, first +
  // step, ...)
  __device__ __forceinline__ void prime(int first, int stride) {
    if (threadIdx.x == 0) {
      q = first;
      seg = i = b = 0;
      step = stride;
      for (int s = 0; s < NS; ++s) produce();
    }
  }
  __device__ __forceinline__ const uint4* take() {
    cl::bar_wait(full + g % NS, (g / NS) & 1);
    return slots + (g % NS) * SW4;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) cl::bar_arrive(empty + g % NS);
    ++g;
    if (threadIdx.x == 0) produce();
  }
  // a split CTA's last act: no CTA leaves while another may still read its
  // shared memory (the wait of the last gradient's arrival)
  __device__ __forceinline__ void finish() {
    if (csize > 1) cl::wait();
  }
};
// the kernels' ring object: an empty one on the tiles without a ring (an
// unused Ring object moved ten unchunked mm_kernel instances' SASS)
struct NoRing {};
template <bool R, class T> struct RingIf { using type = NoRing; };
template <class T> struct RingIf<true, T> { using type = T; };
// the shared-memory floats of the ring: its stages and their two barriers
// each; and the partials a split tile adds over the cluster: G's [DP][NC]
// and two energy partials a thread
__host__ __device__ constexpr int ring_floats(int T, int P, int NS) {
  return NS ? NS * (stage_words(T, P) + 4) : 0;
}
__host__ __device__ constexpr int split_floats(int DP, int NC, int T) { return DP * NC + 2 * T; }

// The B operands of the ring's contractions, split into bf16 once: per
// (k-tile, n-tile) and lane of an m16n8k16 B fragment the hi registers
// (rows 2q..2q+1 and 2q+8..2q+9 of column g) and, past one bf16 pass, the lo
// ones, BW words a lane (b_words). XB holds contraction 1's (X, D deep),
// filled at each gradient's start; ZB contraction 2's (a chunk's rows of
// dU/dy, r or σ(z)), written by contraction 1's epilogue element by element
__host__ __device__ constexpr int b_words(int P) { return P == kDefault ? 2 : 4; }
__host__ __device__ constexpr int xb_floats(int D, int NC, int P) {
  return pad16(D) / 16 * (NC / 8) * 32 * b_words(P);
}
__host__ __device__ constexpr int zb_floats(int KC, int NC, int P) {
  return KC / 16 * (NC / 8) * 32 * b_words(P);
}
// element (r, c) of a B operand (r < 16·k-tiles, c < NC) into its fragments
template <int NC, int P>
__device__ __forceinline__ void put_b(uint32_t* B, int r, int c, float v) {
  constexpr int BW = b_words(P);
  const int rr = r & 15, lane = (c & 7) * 4 + ((rr & 7) >> 1);
  const size_t w = ((size_t)((r >> 4) * (NC / 8) + (c >> 3)) * 32 + lane) * BW + (rr >> 3);
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(B);
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  h[2 * w + (rr & 1)] = hi;
  if constexpr (BW == 4) h[2 * (w + 2) + (rr & 1)] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// gradient_chunks on the ring (the chunked tiles at the bf16 precisions):
// the same chunks, epilogues and sums, each contraction's A fragments taken
// stage by stage from the ring, warp w the m-tile w of each round (every
// n-tile of it), its B fragments split once (XB, ZB); a stage's products
// accumulate in the mma and are added into the round's sums in
// round-to-nearest (mma.sync's own f32 accumulation truncates; across the
// hundreds or thousands of k-tiles of these depths it would bias the sums).
// Split (a cluster of C > 1 CTAs): this CTA takes the chunks rank, rank +
// C, ... into its partial GP [DP][NC] (put() its energy partials into EP
// [2][T]), then, after a cluster barrier, every CTA adds the cluster's
// partials in rank order into G, finishing the gradient, and hands take(j,
// e) each slot j's sum e of its energy partials; a CTA's next gradient
// writes GP only after every CTA has read it. Else (C = 1): every chunk,
// into G, as gradient_chunks does. Y keeps the chunk's rows as
// gradient_chunks writes them where something reads them (the energy
// terms; sparse coding's residual); Z (dU/dy, σ(z)) lives only in ZB.
template <int E, int D, int K, int KC, int NC, int LDX, int LDY, int T, int P, bool RN,
          bool TERMS, int NS, class Rows, class Between, class After, class Put, class Take>
__device__ __forceinline__ void gradient_ring(Ring<D, K, KC, T, P, NS>& ring,
                                              const float* patch,
                                              const float* X, float* Y, uint32_t* XB,
                                              uint32_t* ZB, float* G, float* GP, float* EP,
                                              const Args& a, bool want_u, Rows rows,
                                              Between between, After after, Put put, Take take) {
  using S = Stream<D, K, KC, T, P>;
  constexpr int W = S::W, SK = S::SK, MTD = S::MTD, NQ = S::NQ, NT = NC / 8, BW = b_words(P);
  constexpr int K4 = round_up(K, 4), D4 = round_up(D, 4);
  static_assert(NC % 8 == 0, "n-tiles of 8 columns");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, qd = lane % 4;
  const bool split = ring.csize > 1;
  const int first = split ? (int)ring.rank : 0, step = split ? (int)ring.csize : 1;
  float* GA = split ? GP : G;  // where contraction 2 adds
  // X's fragments, D deep (0 past D), before any warp reads them
  for (int idx = threadIdx.x; idx < MTD * NT * 32; idx += T) {
    const int ln = idx % 32, col = (idx / 32) % NT * 8 + ln / 4;
    const int k = 16 * (idx / 32 / NT) + 2 * (ln % 4);
    auto x_at = [&](int kk) { return kk < D ? X[kk * LDX + col] : 0.f; };
    uint32_t h0, l0, h1, l1;
    split_bf16(x_at(k), x_at(k + 1), h0, l0);
    split_bf16(x_at(k + 8), x_at(k + 9), h1, l1);
    if constexpr (BW == 4)
      reinterpret_cast<uint4*>(XB)[idx] = make_uint4(h0, h1, l0, l1);
    else
      reinterpret_cast<uint2*>(XB)[idx] = make_uint2(h0, h1);
  }
  __syncthreads();
  if (split) {
    cl::wait();  // every CTA has read GP and EP of the last gradient
    if (first >= NQ)
      for (int idx = threadIdx.x; idx < D4 * NC; idx += T) GP[idx] = 0.f;
  }
  ring.prime(first, step);
  // one stage of the warp's m-tile: its sb k-tiles (from kt0 of B's) into
  // the round's sums
  auto stage = [&](const uint4* st, int wi, int sb, int kt0, const uint32_t* B,
                   float (&hh)[NT][4], float (&hl)[NT][4], float (&lh)[NT][4]) {
    float th[NT][4] = {}, tl[NT][4] = {}, tm[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      if (kk < sb) {
        const uint4 av = st[(kk * wi + warp) * 32 + lane];
        const uint32_t ah[4] = {av.x, av.y, av.z, av.w};
        uint32_t al[4] = {};
        if constexpr (P == kBf16x3) {
          const uint4 lv = st[((sb + kk) * wi + warp) * 32 + lane];
          al[0] = lv.x, al[1] = lv.y, al[2] = lv.z, al[3] = lv.w;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const size_t at = ((size_t)(kt0 + kk) * NT + nt) * 32 + lane;
          uint32_t b[4];
          if constexpr (BW == 4) {
            const uint4 bv = reinterpret_cast<const uint4*>(B)[at];
            b[0] = bv.x, b[1] = bv.y, b[2] = bv.z, b[3] = bv.w;
          } else {
            const uint2 bv = reinterpret_cast<const uint2*>(B)[at];
            b[0] = bv.x, b[1] = bv.y, b[2] = b[3] = 0u;
          }
          mma_bf16(th[nt], ah, b[0], b[1]);
          if constexpr (P != kDefault) mma_bf16(tl[nt], ah, b[2], b[3]);
          if constexpr (P == kBf16x3) mma_bf16(tm[nt], al, b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        hh[nt][h] += th[nt][h];
        if constexpr (P != kDefault) hl[nt][h] += tl[nt][h];
        if constexpr (P == kBf16x3) lh[nt][h] += tm[nt][h];
      }
  };
  auto value = [&](const float (&hh)[NT][4], const float (&hl)[NT][4], const float (&lh)[NT][4],
                   int nt, int h) {
    float v = hh[nt][h];
    if constexpr (P == kBf16x3) v = hh[nt][h] + (hl[nt][h] + lh[nt][h]);
    if constexpr (P == kBf16x2) v = hh[nt][h] + hl[nt][h];
    return v;
  };
  // the gradient's last step on an added element (rg, c): sparse coding's
  // λ·a/√(a²+ε) − σ⁻²·Φᵀr, logreg's Xsᵀσ(z) + θ/σ₀²
  auto close = [&](int rg, int c, float s) {
    if constexpr (E == kSparseCoding) {
      const float av = X[rg * LDX + c];
      const float sq = sqrtf(add_<RN>(mul_<RN>(av, av), a.k3));
      s = sub_<RN>(mul_<RN>(a.k0, div_<RN>(av, sq)), mul_<RN>(a.k1, s));
    } else if constexpr (E == kLogreg) {
      s = add_<RN>(s, mul_<RN>(X[rg * LDX + c], a.k0));
    }
    return s;
  };
  for (int q = first; q < NQ; q += step) {
    const int k0 = q * KC, tq = S::tiles(q);
    const bool first_q = q == first, last_q = !split && q == NQ - 1;
    // contraction 1: the chunk's rows of y, r or z (D deep), contraction 2's
    // operand into ZB (0 past K)
    for (int i = 0; i < cdiv(tq, W); ++i) {
      const int wi = min_of(W, tq - i * W);
      float hh[NT][4] = {}, hl[NT][4] = {}, lh[NT][4] = {};
      for (int b = 0; b < cdiv(MTD, SK); ++b) {
        const uint4* st = ring.take();
        if (warp < wi) stage(st, wi, min_of(SK, MTD - b * SK), b * SK, XB, hh, hl, lh);
        ring.release();
      }
      if (warp < wi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int rg = 16 * (q * S::TQF + i * W + warp) + gq + 8 * (h >> 1), rl = rg - k0;
            const int c = nt * 8 + 2 * qd + (h & 1);
            const float v = value(hh, hl, lh, nt, h);
            float bv = 0.f;  // the operand of contraction 2
            if constexpr (E == kProductOfT) {  // y, log1p(y²/ν) where wanted, dU/dy
              if (rg < K4) {
                if constexpr (!TERMS)
                  Y[rl * LDY + c] = v;
                else if (want_u)
                  Y[rl * LDY + c] = log1pf(v * v * a.k3);
              }
              bv = div_<RN>(mul_<RN>(a.k0, v), add_<RN>(a.k1, mul_<RN>(v, v)));
            } else if constexpr (E == kSparseCoding) {  // the residual, 0 on padded rows
              bv = sub_<RN>(rg < K ? patch[rg] : 0.f, v);
              if (rg < K4) Y[rl * LDY + c] = bv;
            } else {  // z, softplus(z) where wanted, σ(z)
              // one exponential for both: σ(z) = 1/(1 + e) for z ≥ 0 and
              // e/(1 + e) below, e = exp(−|z|)
              const float e = expf(-fabsf(v));
              if (rg < K4) {
                if constexpr (!TERMS)
                  Y[rl * LDY + c] = v;
                else if (want_u)
                  Y[rl * LDY + c] = fmaxf(v, 0.f) + log1pf(e);
              }
              const float den = add_<RN>(1.0f, e);
              bv = v >= 0.f ? div_<RN>(1.0f, den) : div_<RN>(e, den);
            }
            put_b<NC, P>(ZB, rl, c, rg < K ? bv : 0.f);
          }
    }
    between();
    rows(k0);
    // contraction 2: the chunk's share of the gradient (the chunk's rows deep)
    for (int i = 0; i < cdiv(MTD, W); ++i) {
      const int wi = min_of(W, MTD - i * W);
      float hh[NT][4] = {}, hl[NT][4] = {}, lh[NT][4] = {};
      for (int b = 0; b < cdiv(tq, SK); ++b) {
        const uint4* st = ring.take();
        if (warp < wi) stage(st, wi, min_of(SK, tq - b * SK), b * SK, ZB, hh, hl, lh);
        ring.release();
      }
      if (warp < wi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int rg = 16 * (i * W + warp) + gq + 8 * (h >> 1);
            const int c = nt * 8 + 2 * qd + (h & 1);
            const float v = value(hh, hl, lh, nt, h);
            if (rg >= D4) continue;
            float s = first_q ? v : add_<RN>(GA[rg * NC + c], v);
            if (last_q) s = close(rg, c, s);
            GA[rg * NC + c] = s;
          }
    }
    if (q + step < NQ) after();
  }
  if (split) {
    // the cluster's partials, added in rank order by every CTA alike
    put(EP);
    cl::sync();
    for (int idx = threadIdx.x; idx < D4 * NC; idx += T) {
      float s = cl::ld_f32(GP + idx, 0);
      for (uint32_t r = 1; r < ring.csize; ++r) s = add_<RN>(s, cl::ld_f32(GP + idx, r));
      G[idx] = close(idx / NC, idx % NC, s);
    }
    for (int j = 0; j < 2; ++j) {
      float e = cl::ld_f32(EP + j * T + threadIdx.x, 0);
      for (uint32_t r = 1; r < ring.csize; ++r)
        e = add_<RN>(e, cl::ld_f32(EP + j * T + threadIdx.x, r));
      take(j, e);
    }
    cl::arrive();  // this CTA's reads of GP and EP are done
  }
}

// The plan of a ring tile's launch (ops/cuda_mjhmc.py::cluster_plan mirrors
// it), from the tiles of the chain count and the clusters the card holds at
// once at C = 2, 4, 8 and 16 (held[0..3], cudaOccupancyMaxActiveClusters at
// the tile's threads and shared bytes): where the tile may split and the
// card holds a cluster of two for every tile, each tile runs on a cluster
// of its own, the largest C of which the card holds one a tile, its C CTAs
// splitting the chunks; else a CTA a tile (C = 1). (On the H100 clusters of
// 2-8 CTAs that shared each stage by multicast, each its own tile, ran no
// faster than single CTAs: PERF.md §6.)
struct ClusterPlan {
  int c, grid;
};
constexpr int kClusterSizes[4] = {2, 4, 8, 16};
inline ClusterPlan cluster_plan(int tiles, const int* held, bool split) {
  if (split && tiles <= held[0])
    for (int s = 3; s >= 0; --s)
      if (held[s] >= tiles) return {kClusterSizes[s], tiles * kClusterSizes[s]};
  return {1, tiles};
}

// The sum down column c of slot s of red, where each of a block's T threads
// put one partial at red[s·T + tid] and a column's owners are the threads
// c, c + NC, ...: their T / NC partials added in that order
template <int T, int NC>
__device__ __forceinline__ float column_sum(const float* red, int s, int c) {
  const float* p = red + s * T + c;
  float acc = p[0];
MJHMC_MM_UNROLL_OWNED(T/NC)
  for (int j = 1; j < T / NC; ++j) acc = __fadd_rn(acc, p[j * NC]);
  return acc;
}

// The tile rule, one for both kernels at every shape (ops/cuda_mjhmc.py
// mirrors it: mm_tile_rule, nuts_mm_tile_rule). A tile starts from its
// energy's base, the presets' tiles: product of t 8 chains a block on 96
// threads (MINB 4), sparse coding 16 on 256 (MINB 2), logreg 8 on 128
// (MINB 3; mm_kernel's MJHMC 4 chains, their 8 columns one mma n-tile).
// Where its layout does not fit the 227 KB a block may opt into (a large
// parameter matrix), it halves the chains a block, and the threads with
// them (a chain keeps its threads; whole warps), down to one mma n-tile of 8
// columns; where even that does not fit, the parameter matrix moves to a
// device buffer (off) and the tile starts again from the base. MINB is the
// base's, or the blocks an SM's shared memory holds where they are fewer.
// NUTS keeps its tree state on chip (onchip) where it fits beside the rest
// at max_depth 12. At the presets this gives their tiles: the library's
// instances are the ones the per-energy constants gave.
//
// Where even the 8-column tile does not fit off chip (the k-row
// intermediates Y and Z, K·NC floats each, pass the block's 227 KB), the K
// rows run in chunks of kc (gradient_chunks): Y and Z hold one chunk, so K
// leaves the sum. The tile starts again from the base, its threads doubled
// (a chain's, up to 1,024 a block) until an owner holds at most
// kOwnerGroups groups of four dims (NUTS kOwnerDims dims); kc is the
// largest multiple of 16 and of a chain's threads up to kChunkMax rows (and
// K) that fits. Where even 8 columns of X and G do not fit beside a chunk
// (d in the thousands), X, G and the mass move to the block's slice of the
// device scratch (xg), the tile is the 8-column one, and the rule has no
// refusal left: past that the device scratch is the limit. MINB there is
// at most 1,024 / T, so that a thread keeps 64 registers. At the bf16
// precisions a chunked tile with X and G on chip also holds a ring of ns
// stages (Ring, 2 to kMaxStages) and, where a tile may split over a cluster
// (NUTS: its tree state on chip too), the cluster's partials
// (split_floats); mm_kernel's tile starts from kRingColumns columns and
// NUTS's from kRingThreads threads (both threads at least kRingThreads):
// mm_kernel takes the most blocks an SM that any ring and chunk give, then
// the largest kc, then the most stages; NUTS its tree state on chip where
// it fits, then the most stages, then the largest kc. A ring's kc is also a
// multiple of 16 rows for each warp (ring_quantum), so that every round of
// a chunk's first contraction is whole. The XG tiles (8 columns) and
// kHighest's take no ring: at 8 columns a ring's stage feeds one mma n-tile
// a fragment, and its handoff cost more than the loads it hid (PERF.md §6).
constexpr int kChunkMax = 512, kOwnerGroups = 4, kOwnerDims = 16, kMaxThreads = 1024;
// the ring's tiles with X and G on chip: kRingColumns columns a block (each
// A fragment feeds four mma n-tiles), kRingThreads threads (a warp for each
// of a9a's eight m-tiles of its second contraction) and more where an
// owner would hold more than kOwnerGroups groups
constexpr int kRingColumns = 32, kRingThreads = 256;
struct TileRule {
  int ch, t, minb;
  bool off, onchip;
  int kc;      // rows of a chunk of the intermediate (0: all K at once)
  bool xg;     // X, G and the mass in the block's slice of the device scratch
  int ns = 0;  // the ring's stages (0: none; the chunks read from device memory)
};
__host__ __device__ constexpr int base_chains(int E, int VAR) {
  return E == kProductOfT ? 8 : E == kSparseCoding ? 16 : VAR == kMjhmc ? 4 : 8;
}
__host__ __device__ constexpr int base_threads(int E) {
  return E == kProductOfT ? 96 : E == kSparseCoding ? 256 : 128;
}
__host__ __device__ constexpr int base_minb(int E) {
  return E == kProductOfT ? 4 : E == kSparseCoding ? 2 : 3;
}
// the blocks of `floats` an SM holds, at most the base's MINB, at least 1
__host__ __device__ constexpr int minb_for(int E, int floats) {
  const int fit = kSmemSM / (4 * floats + kSmemReserved);
  return fit < 1 ? 1 : min_of(base_minb(E), fit);
}

// mm_kernel's geometry at (D, K) on a tile of CH chains and T threads: NC
// columns (MJHMC spends two on each chain, forward in c and backward in CH +
// c; control and MALT one), operand rows LD = NC + 4 floats (≡ 4 mod 8: the
// B fragments' loads hit 32 banks). A chain's RY = T / CH threads own the
// rows r, r + RY, ... (NK of them, KP in all) of each of its columns; the
// first R also own the dims' groups of four r, r + R, ... (NG of them, DP
// dims in all). DP ≥ D and KP ≥ K pad the tile: the padded dims draw no
// momentum and stay 0, the padded rows' terms are masked. Then the shared
// memory, in floats: the parameter matrix (Params; none where off), X
// [DP][LD], G [DP][NC], Y ([KP][LD] at sparse coding, the residual operand;
// else [KP][NC], the rows' energy terms), Z [KP][LD] (dU/dy or σ(z); none at
// sparse coding), the mass [2DP] (BR), the bf16 fragments at FRAG (16-byte
// aligned), then the chains' partial sums, SLOTS × T (MJHMC 4, control and
// MALT 3); the patch is read from device memory
// (ops/cuda_mjhmc.py::mm_geometry mirrors this).
// A chunked tile's MINB: the blocks an SM's shared memory holds, at most
// 1,024 / T (64 registers a thread)
__host__ __device__ constexpr int chunked_minb(int E, int floats, int t) {
  return min_of(minb_for(E, floats), max_of(1, kMaxThreads / t));
}
// a chunk's rows: multiples of 16 (k-tiles) and of the q owners of a column
// (whole rows for each), at most kChunkMax and K rounded up
__host__ __device__ constexpr int chunk_quantum(int owners) {
  return owners / gcd_of(owners, 16) * 16;
}
__host__ __device__ constexpr int chunk_start(int K, int q) {
  return min_of(round_up(K, q), max_of(kChunkMax / q, 1) * q);
}
__host__ __device__ constexpr int ring_quantum(int owners, int T) {
  return chunk_quantum(owners) / gcd_of(chunk_quantum(owners), 16 * (T / 32)) * 16 * (T / 32);
}

struct MmGeom {
  int nc, ld, ry, r, ng, nk, dp, kp;
  int a1, a2, x, g, y, z, mass, frag, red, slots, floats;
  int slice;  // xg: the block's floats of the device scratch (X, G, the mass)
  // NS > 0: the ring (Ring's layout), the B fragments ZB and XB, the split
  // partials
  int ring, zb, xb, gp;
};
// ... KC > 0: Y and Z hold a chunk of KC rows (kp = KC, nk = KC / RY);
// XG: X [DP][LD], G [DP][NC] and the mass [2DP] in the block's slice of the
// device scratch, none of them in shared memory; NS > 0 (never with XG): no
// f32 Z (its fragments are in ZB), and after the fragments the ring
// (ring_floats), ZB, XB and the split partials (split_floats), then the
// partial sums
__host__ __device__ constexpr MmGeom mm_geom(int E, int VAR, int P, bool BR, bool OFF, int D,
                                             int K, int CH, int T, int KC = 0, bool XG = false,
                                             int NS = 0) {
  MmGeom m{};
  m.nc = VAR == kMjhmc ? 2 * CH : CH;
  m.ld = m.nc + 4;
  m.ry = T / CH;
  const int groups = cdiv(D, 4);
  m.ng = cdiv(groups, m.ry);
  m.r = cdiv(groups, m.ng);
  m.dp = 4 * m.r * m.ng;
  m.nk = KC ? KC / m.ry : cdiv(K, m.ry);
  m.kp = KC ? KC : m.ry * m.nk;
  const bool f32 = P == kHighest && !OFF;
  const int copies = OFF || P == kHighest ? 0 : P == kBf16x3 ? 2 : 1;
  m.a1 = 0;
  m.a2 = m.a1 + (f32 ? D * round_up(K, 4) : 0);
  m.x = m.a2 + (f32 ? K * round_up(D, 4) : 0);
  m.g = m.x + (XG ? 0 : m.dp * m.ld);
  m.y = m.g + (XG ? 0 : m.dp * m.nc);
  m.z = m.y + m.kp * (E == kSparseCoding ? m.ld : m.nc);
  m.mass = m.z + (E != kSparseCoding && !NS ? m.kp * m.ld : 0);
  m.frag = (m.mass + (BR && !XG ? 2 * m.dp : 0) + 3) / 4 * 4;
  m.ring = m.frag + 2 * copies * (pad16(K) * pad16(D) / 2);
  m.zb = m.ring + ring_floats(T, P, NS);
  m.xb = m.zb + (NS ? zb_floats(KC, m.nc, P) : 0);
  m.gp = m.xb + (NS ? xb_floats(D, m.nc, P) : 0);
  m.red = m.gp + (NS ? split_floats(m.dp, m.nc, T) : 0);
  m.slots = VAR == kMjhmc ? 4 : 3;
  m.floats = m.red + m.slots * T;
  m.slice = XG ? m.dp * (m.ld + m.nc + 2) : 0;
  return m;
}
// mm_kernel's tile of body VAR on energy E at (D, K) and precision P (the
// layout with the branches, the larger one, must fit)
__host__ __device__ constexpr TileRule mm_rule(int E, int VAR, int P, int D, int K) {
  const int ch0 = base_chains(E, VAR), t0 = base_threads(E);
  for (int off = 0; off < 2; ++off)
    for (int ch = ch0; (VAR == kMjhmc ? 2 * ch : ch) >= 8; ch /= 2) {
      const int t = round_up(t0 / ch0 * ch, 32);
      const int floats = mm_geom(E, VAR, P, true, off != 0, D, K, ch, t).floats;
      if (4 * floats <= kSmemBlock) return {ch, t, minb_for(E, floats), off != 0, false};
    }
  // chunked k, the parameter matrix off chip: X and G on chip, at the bf16
  // precisions with a ring beside them (pass 0), else without (1), then
  // (xg, pass 2) in the device scratch on the 8-column tile; without a
  // ring, the largest kc that fits
  const int ch8 = VAR == kMjhmc ? 4 : 8;
  const int wide = VAR == kMjhmc ? kRingColumns / 2 : kRingColumns;
  for (int pass = P == kHighest ? 1 : 0; pass < 3; ++pass) {
    const int xg = pass == 2;
    const int ns_hi = pass ? 0 : kMaxStages, ns_lo = ns_hi ? kMinStages : 0;
    for (int ch = xg ? ch8 : ns_hi ? wide : ch0; (VAR == kMjhmc ? 2 * ch : ch) >= 8; ch /= 2) {
      int t = ns_hi ? max_of(kRingThreads, round_up(ch, 32)) : round_up(t0 / ch0 * ch, 32);
      while (2 * t <= kMaxThreads && cdiv(cdiv(D, 4), t / ch) > kOwnerGroups) t *= 2;
      if (!ns_hi) {
        const int q = chunk_quantum(t / ch);
        for (int kc = chunk_start(K, q); kc >= q; kc -= q) {
          const int floats = mm_geom(E, VAR, P, true, true, D, K, ch, t, kc, xg != 0).floats;
          if (4 * floats <= kSmemBlock)
            return {ch, t, chunked_minb(E, floats, t), true, false, kc, xg != 0};
        }
        continue;
      }
      const int q = ring_quantum(t / ch, t);
      const int least = mm_geom(E, VAR, P, true, true, D, K, ch, t, q, false, ns_lo).floats;
      if (4 * least > kSmemBlock) continue;
      const int best = chunked_minb(E, least, t);
      for (int kc = chunk_start(K, q); kc >= q; kc -= q)
        for (int ns = ns_hi; ns >= ns_lo; --ns) {
          const int floats = mm_geom(E, VAR, P, true, true, D, K, ch, t, kc, false, ns).floats;
          if (4 * floats <= kSmemBlock && chunked_minb(E, floats, t) == best)
            return {ch, t, best, true, false, kc, false, ns};
        }
    }
  }
  return {0, 0, 0, true, false};
}

// The tile of mm_kernel's body VAR on energy E at (D, K) and precision P:
// CH chains a block, T threads, MINB blocks an SM asked of
// __launch_bounds__, OFF the parameter matrix in a device buffer. At the
// presets' widths (product of t 4,096, sparse coding 8,192, logreg 2,048
// chains): 512 blocks each, but logreg's control and MALT 256 (the mma
// n-tile is 8 columns).
template <int E, int D, int K, int VAR, int P>
struct MmTile {
  static constexpr TileRule rule = mm_rule(E, VAR, P, D, K);
  static_assert(rule.ch > 0, "no tile of mm_kernel fits this shape, even off chip");
  static constexpr int CH = rule.ch, T = rule.t, MINB = rule.minb, KC = rule.kc, NS = rule.ns;
  static constexpr bool OFF = rule.off, XG = rule.xg;
  static constexpr int NC = VAR == kMjhmc ? 2 * CH : CH;
};

// mm_kernel's layout (mm_geom) on its tile
template <int E, int D, int K, int VAR, int P, bool BR>
struct MmLayout {
  using TL = MmTile<E, D, K, VAR, P>;
  static constexpr MmGeom M =
      mm_geom(E, VAR, P, BR, TL::OFF, D, K, TL::CH, TL::T, TL::KC, TL::XG, TL::NS);
  static constexpr int CH = TL::CH, NC = TL::NC, T = TL::T, KC = TL::KC, NS = TL::NS;
  static constexpr bool OFF = TL::OFF, XG = TL::XG;
  static constexpr int LD = M.ld, RY = M.ry, R = M.r, NG = M.ng, NK = M.nk, DP = M.dp,
                       KP = M.kp, SLICE = M.slice;
  static_assert(T % CH == 0 && T % 32 == 0 && R <= RY && DP == 4 * R * NG && DP >= D &&
                    KP == RY * NK && (KC ? KC % 16 == 0 && OFF : KP >= K),
                "a chain's threads own whole groups of dims and whole rows (of a chunk)");
  static_assert(NC % 8 == 0, "mma.sync n-tiles of 8 columns");
  static constexpr int A1 = M.a1, A2 = M.a2, X = M.x, G = M.g, Y = M.y, Z = M.z,
                       MASS = M.mass, FRAG = M.frag, RED = M.red, SLOTS = M.slots,
                       kFloats = M.floats, RING = M.ring, ZB = M.zb, XB = M.xb, GP = M.gp;
  // a tile that may split over a cluster (the ring's tiles)
  static constexpr bool SPLITS = NS > 0;
};

// The PROF instances' phases of an iteration (ops/cuda_mjhmc.py,
// MM_PROF_PHASES): the normals (refresh, corruption, O-steps), the owners'
// kick-drift and closing kick, the two contractions, the partial and column
// sums, the decision and move (with the moments and emissions), barrier
// waits and the rest; then the gradients (two contractions each) a block ran
enum MmPhase {
  kMmDraws = 0, kMmKickDrift, kMmContract1, kMmContract2, kMmSums, kMmDecide, kMmBarrier,
  kMmOther, kMmGradients, kMmPhases
};

// VAR: kMjhmc (the forward and backward trajectories of CH chains in the
// NC = 2·CH columns), or kControl / kMalt (the forward trajectories of CH
// chains, one a column). BR=false compiles neither the mass nor the
// two-stage integrator (MJHMC's fast path, as the TPU kernel compiles them
// statically); BR=true takes both from the arguments. PROF stamps the
// phases of every iteration into a.prof (MmPhase).
template <int E, int D, int K, int VAR, bool EMIT, bool STUB, bool BR, int P, bool PROF>
__global__ void __launch_bounds__(MmTile<E, D, K, VAR, P>::T, MmTile<E, D, K, VAR, P>::MINB)
    mm_kernel(Args a) {
  using L = MmLayout<E, D, K, VAR, P, BR>;
  constexpr int CH = L::CH, NC = L::NC, LD = L::LD, T = L::T, DP = L::DP, KP = L::KP;
  constexpr int RY = L::RY, R = L::R, NG = L::NG, NK = L::NK, NE = 4 * NG;
  // a padded tile's dims past D and rows past K (mm_geom), and the
  // parameter matrix in the device buffer (a.scratch) where it is OFF
  constexpr bool PAD = DP != D, OFF = L::OFF;
  // KC: the intermediate's rows in chunks; XG: X, G and the mass in the
  // block's slice of a.scratch, after the parameter matrix (mm_geom)
  constexpr int KC = L::KC;
  constexpr bool XG = L::XG;
  constexpr int D4 = round_up(D, 4);
  constexpr bool MJ = VAR == kMjhmc;
  constexpr int NT = MJ ? 2 : 1;                    // trajectories: columns c (, CH + c)
  constexpr int LY = E == kSparseCoding ? LD : NC;  // Y's row stride
  // the partial sums' slots: ΣvᵀM⁻¹v of the chain's v (the start's H),
  // the forward trajectory's U and ΣvᵀM⁻¹v, MJHMC's backward H; MALT's U
  // and ΣvᵀM⁻¹v after a step and ΣvᵀM⁻¹v after the next O-step
  enum { kV0 = 0, kUF = 1, kVF = 2, kHB = 3, kIn = 0 };

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* X = sm + L::X;
  float* G = sm + L::G;
  float* Y = sm + L::Y;
  float* Z = sm + L::Z;
  float* IM = sm + L::MASS;  // BR: [DP] M^-1, then [DP] sqrt(M)
  float* red = sm + L::RED;  // [SLOTS][T]
  if constexpr (XG) {
    X = a.scratch + Params<D, K, P>::kFloats + (size_t)blockIdx.x * L::SLICE;
    G = X + DP * LD;
    IM = G + DP * NC;
  }
  // the ring's tiles (NS > 0): a cluster of C CTAs a tile (ClusterPlan);
  // past one, they run their tile alike and its rank 0 alone writes to
  // device memory
  constexpr bool RING = L::NS > 0;
  typename RingIf<RING, Ring<D, K, RING ? KC : 16, T, RING ? P : kDefault, RING ? L::NS : 1>>::type
      ring;
  uint32_t tile = blockIdx.x;
  bool writer = true;
  if constexpr (RING) {
    tile = blockIdx.x / cl::size();
    writer = cl::rank() == 0;
  }

  const int tid = threadIdx.x, c = tid % CH, r = tid / CH;
  const bool owner = r < R;  // of dims (every thread owns rows)
  const uint32_t chain = tile * CH + c;
  const bool live = chain < (uint32_t)a.n;
  const size_t n = a.n;
  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  PhaseClock<PROF, kMmPhases, kMmBarrier> prof;
  prof.start();
  // G's rows past the contraction's D4 are never written: 0, as the padded
  // dims' gradient
  if constexpr (DP != D4)
    for (int idx = tid; idx < (DP - D4) * NC; idx += T) G[D4 * NC + idx] = 0.f;
  load_params<E, D, K, DP, T, BR, P, OFF>(a, sm + L::A1, sm + L::A2, nullptr, IM,
                                          reinterpret_cast<uint32_t*>(sm + L::FRAG));
  if constexpr (RING) {
    ring.init(sm + L::RING, a.scratch);
    if (ring.csize > 1) cl::arrive();  // pairs the first gradient's wait
  }
  const float* A1 = sm + L::A1;
  const float* A2 = sm + L::A2;
  const uint32_t* frag = reinterpret_cast<const uint32_t*>(sm + L::FRAG);
  if constexpr (OFF) {
    A1 = a.scratch;
    A2 = a.scratch + Params<D, K, P>::kF32_1;
    frag = reinterpret_cast<const uint32_t*>(a.scratch);
  }
  const float* sqm = BR ? IM + DP : nullptr;

  // the thread's k-th dim (k / 4 its group) and j-th row
  auto dim = [&](int k) { return 4 * (r + (k / 4) * R) + k % 4; };
  auto row = [&](int j) { return r + j * RY; };
  auto im = [&](int i) { return BR ? IM[i] : 1.f; };
  auto put = [&](int s, float part) { red[s * T + tid] = part; };
  auto col_sum = [&](int s) { return column_sum<T, CH>(red, s, c); };

  // the chain's point (x, v, g), its Kahan moments and the trajectories'
  // momenta vt of the owned dims; the chains past n (ragged last tile) run
  // on zeros and are never stored
  float x[NE], v[NE], g[NE], wx[NE], wxc[NE], wx2[NE], wx2c[NE], vt[NT][NE];
MJHMC_MM_UNROLL_OWNED(NE)
  for (int k = 0; k < NE; ++k) {
    const size_t gi = (size_t)dim(k) * n + chain;
    if constexpr (PAD) {  // a padded dim starts at 0
      const bool in = owner && live && dim(k) < D;
      x[k] = in ? a.x[gi] : 0.f;
      v[k] = in ? a.v[gi] : 0.f;
      g[k] = in ? a.g[gi] : 0.f;
    } else {
      x[k] = owner && live ? a.x[gi] : 0.f;
      v[k] = owner && live ? a.v[gi] : 0.f;
      g[k] = owner && live ? a.g[gi] : 0.f;
    }
    wx[k] = wxc[k] = wx2[k] = wx2c[k] = 0.f;
#pragma unroll
    for (int q = 0; q < NT; ++q) vt[q][k] = 0.f;
  }
  // the chain's scalars, kept alike by its threads
  float u = live ? a.u[chain] : 0.f;
  float h_back = live ? a.h_back[chain] : 0.f;
  float valid = live ? a.valid[chain] : 0.f;
  float w = 0.f, wc = 0.f;
  int evals = 0;

  const bool two_stage = BR && a.two_stage;
  const int m_cost = two_stage ? 2 * a.m : a.m;
  const float sb = sqrtf(a.beta), sb1 = sqrtf(fmaxf(1.f - a.beta, 0.f));  // control
  // MALT: beta is the friction; rounded one operation at a time
  const float eta = expf(__fmul_rn(__fmul_rn(-a.beta, eps), 0.5f));
  const float sig = sqrtf(fmaxf(0.f, __fsub_rn(1.f, __fmul_rn(eta, eta))));
  constexpr uint32_t kBlocks = (2 * D + 3) / 4;  // slots of one O-step's noise
  float ul = 0.f, delta = 0.f, h_in = 0.f;        // MALT

  // the thread's partial of Σ vv²·M^-1 over its dims
  auto sq = [&](const float(&vv)[NE]) -> float {
    float s = 0.f;
    if (owner)
MJHMC_MM_UNROLL_OWNED(NE)
      for (int k = 0; k < NE; ++k) s += vv[k] * vv[k] * im(dim(k));
    return s;
  };
  // chunked: the thread's partials of each trajectory's rows' terms of the
  // last gradient that wanted them, added chunk by chunk in row order
  float eacc[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) eacc[q] = 0.f;
  auto chunk_terms = [&](int k0) {
#pragma unroll
    for (int q = 0; q < NT; ++q)
      for (int j = 0; j < NK; ++j) {
        const int rl = r + j * RY;  // the chunk's row k0 + rl
        if (k0 + rl >= K) break;
        const float yv = Y[rl * LY + c + q * CH];
        eacc[q] += E == kSparseCoding ? yv * yv : yv;
      }
  };
  // the thread's partial of trajectory q's energy from the last gradient's
  // x and y (its rows' terms), r (sparse coding) or z terms
  auto energy = [&](int q) -> float {
    const int col = c + q * CH;
    float s1 = 0.f, s2 = 0.f;
    if (E != kProductOfT && owner) {
MJHMC_MM_UNROLL_OWNED(NE)
      for (int k = 0; k < NE; ++k) {
        const float xx = X[dim(k) * LD + col];
        if constexpr (PAD) {  // a padded dim adds no λ√ε
          if (dim(k) < D) s1 += E == kSparseCoding ? sqrtf(xx * xx + a.k3) : xx * xx;
        } else {
          s1 += E == kSparseCoding ? sqrtf(xx * xx + a.k3) : xx * xx;
        }
      }
    }
    if constexpr (KC > 0) {
      s2 = eacc[q];
    } else {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float yv = Y[row(j) * LY + col];
        if constexpr (KP != K) {  // a padded row adds no softplus(0) (or unwritten term)
          if (row(j) < K) s2 += E == kSparseCoding ? yv * yv : yv;
        } else {
          s2 += E == kSparseCoding ? yv * yv : yv;
        }
      }
    }
    return E == kProductOfT ? a.k2 * s2 : E == kSparseCoding ? a.k0 * s1 + a.k2 * s2
                                                             : s2 + a.k1 * s1;
  };
  // the owners' kick v −= c_kick·g (where kick; g the chain's where first,
  // else the last gradient's) and drift x += c_drift·M^-1·v (from the
  // chain's x where first) of every trajectory, x into X
  auto kick_drift = [&](bool first, bool kick, float c_kick, float c_drift) {
    if (owner)
#pragma unroll
      for (int q = 0; q < NT; ++q)
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) {
          const int i = dim(k), col = c + q * CH;
          float vv = vt[q][k];
          if (kick) vv = vv - c_kick * (first ? g[k] : G[i * NC + col]);
          vt[q][k] = vv;
          X[i * LD + col] = (first ? x[k] : X[i * LD + col]) + c_drift * (im(i) * vv);
        }
  };
  auto close_kick = [&](float c_kick) {
    if (owner)
#pragma unroll
      for (int q = 0; q < NT; ++q)
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k)
          vt[q][k] = vt[q][k] - c_kick * G[dim(k) * NC + c + q * CH];
    prof.mark(kMmKickDrift);
  };
  // the gradient of every column after the owners' drift: a barrier, then
  // after_a(), the two contractions and a barrier after each
  auto gradient = [&](bool want_u, auto after_a) {
    prof.sync(kMmKickDrift);
    after_a();
    prof.count(kMmGradients);
    if constexpr (KC > 0) {
      if (want_u)
#pragma unroll
        for (int q = 0; q < NT; ++q) eacc[q] = 0.f;
      auto rows = [&](int k0) {
        if (want_u) chunk_terms(k0);
      };
      if constexpr (RING)
        gradient_ring<E, D, K, KC, NC, LD, LY, T, P, false, true, L::NS>(
            ring, a.p1, X, Y, reinterpret_cast<uint32_t*>(sm + L::XB),
            reinterpret_cast<uint32_t*>(sm + L::ZB), G, sm + L::GP, sm + L::GP + DP * NC, a,
            want_u, rows,
            [&] { prof.sync(kMmContract1); }, [&] { prof.sync(kMmContract2); },
            [&](float* ep) {
              for (int q = 0; q < NT; ++q) ep[q * T + tid] = eacc[q];
            },
            [&](int j, float e) {
              for (int q = 0; q < NT; ++q)
                if (want_u && q == j) eacc[q] = e;
            });
      else
        gradient_chunks<E, D, K, KC, NC, LD, LY, LD, T, P, false, true>(
            A1, A2, frag, a.p1, X, Y, Z, G, a, want_u, rows, [&] { prof.sync(kMmContract1); },
            [&] { prof.sync(kMmContract2); });
    } else {
      gradient_tile<E, D, K, NC, LD, T, STUB, P, false, true>(
          A1, A2, frag, a.p1, X, Y, Z, G, a, want_u,
          [&] { prof.sync(kMmContract1); });
    }
    prof.sync(kMmContract2);
  };
  // integrator step s of every trajectory (leapfrog, or the two-stage
  // splitting); its last gradient writes the energy terms where want_u
  auto integrator_step = [&](int s, bool want_u, auto after_a) {
    if (two_stage) {
      const float cb = kTwoStageB * eps, cm = kTwoStageMid * eps;
      kick_drift(s == 0, true, cb, he);
      gradient(false, after_a);
      close_kick(cm);
      kick_drift(false, false, 0.f, he);
      gradient(want_u, [] {});
      close_kick(cb);
    } else {
      kick_drift(s == 0, true, he, eps);
      gradient(want_u, after_a);
      close_kick(he);
    }
  };
  // MALT's O half-step o of the owned dims: vt <- eta vt + sig z
  auto o_step = [&](int t, int o) {
    if (owner)
MJHMC_MM_UNROLL_OWNED(NG)
      for (int gq = 0; gq < NG; ++gq) {
        float z[4];
        normals4<D, 0, PAD>(a, chain, t, 4 * (r + gq * R), kTagMaltNoise, o * kBlocks, sqm, key, z);
#pragma unroll
        for (int j = 0; j < 4; ++j) vt[0][4 * gq + j] = eta * vt[0][4 * gq + j] + sig * z[j];
      }
    prof.mark(kMmDraws);
  };

  for (int t = 0; t < a.num_iters; ++t) {
    // the trajectories: MJHMC forward from (x, v) and backward from (x, -v);
    // control from the corrupted v; MALT from v0 ~ N(0, M) (kept in v until
    // the decision)
    if (owner)
MJHMC_MM_UNROLL_OWNED(NG)
      for (int gq = 0; gq < NG; ++gq) {
        float z[4];
        if constexpr (VAR == kControl)
          normals4<D, 0, PAD>(a, chain, t, 4 * (r + gq * R), kTagControl, 0u, sqm, key, z);
        if constexpr (VAR == kMalt)
          normals4<D, 0, PAD>(a, chain, t, 4 * (r + gq * R), kTagMaltRefresh, 0u, sqm, key, z);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * gq + j;
          if constexpr (VAR == kControl) v[k] = sb1 * v[k] + sb * z[j];
          if constexpr (VAR == kMalt) v[k] = z[j];
          vt[0][k] = v[k];
          if constexpr (MJ) vt[1][k] = -v[k];
        }
      }
    prof.mark(kMmDraws);

    float h_cur = 0.f, u_l = 0.f, h_l = 0.f, h_b = 0.f;
    if constexpr (VAR == kMalt) {
      // each step's sums are put before the next step's kick-drift and read
      // after its first barrier; the last ones after a barrier of their own
      ul = u;
      delta = 0.f;
      o_step(t, 0);
      put(kIn, sq(vt[0]));
      prof.mark(kMmSums);
      for (int step = 0; step < a.m; ++step) {
        integrator_step(step, true, [&] {
          if (step > 0) {
            ul = col_sum(kUF);
            delta = delta + (ul + 0.5f * col_sum(kVF) - h_in);
          }
          h_in = ul + 0.5f * col_sum(kIn);
          prof.mark(kMmSums);
        });
        // the BAB step's energy error, from this step's x and y, r or z
        const float pu = energy(0), pv = sq(vt[0]);
        prof.mark(kMmSums);
        o_step(t, 2 * step + 1);
        if (step + 1 < a.m) {
          o_step(t, 2 * step + 2);
          put(kIn, sq(vt[0]));
        }
        put(kUF, pu);
        put(kVF, pv);
        prof.mark(kMmSums);
      }
      prof.sync(kMmSums);
      ul = col_sum(kUF);
      delta = delta + (ul + 0.5f * col_sum(kVF) - h_in);
    } else {
      for (int step = 0; step < a.m; ++step) integrator_step(step, step + 1 == a.m, [] {});
      // the start's H and the trajectories' end energies, from the last
      // step's x and y or r
      put(kV0, sq(v));
      put(kUF, energy(0));
      put(kVF, sq(vt[0]));
      if constexpr (MJ) put(kHB, energy(1) + 0.5f * sq(vt[1]));
      prof.sync(kMmSums);
      h_cur = u + 0.5f * col_sum(kV0);
      u_l = col_sum(kUF);
      h_l = u_l + 0.5f * col_sum(kVF);
      if constexpr (MJ) h_b = valid > 0.5f ? h_back : col_sum(kHB);
    }
    prof.mark(kMmSums);

    const bool emit_now = EMIT && (t + 1) % a.thin == 0;
    const size_t emit_row = t / a.thin;
    // every thread of the chain decides alike; the owners move its dims
    auto move = [&]() {  // to the forward trajectory's end
      if (owner)
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) {
          const int i = dim(k);
          x[k] = X[i * LD + c];
          v[k] = vt[0][k];
          g[k] = G[i * NC + c];
        }
    };
    auto flip = [&]() {
      if (owner)
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) v[k] = -v[k];
    };
    if constexpr (MJ) {
      const float log_gl = log_rate(h_l, h_cur);
      const float log_glf = log_rate(h_b, h_cur);
      const float gamma_l = expf(log_gl < kNegInf ? kNegInf : log_gl);
      const float df = expf(log_glf) - gamma_l;
      const float gamma_f = df < 0.f ? 0.f : df;
      const float total = gamma_l + gamma_f + a.beta;
      const float dwell = 1.0f / total;

      // categorical clock choice by inverse CDF from one uniform (word 0)
      const float u0 = a.fixed_uniform ? 0x1p-25f : philox_uniform(philox_word(chain, t, 0u, key));
      const float u_sel = u0 * total;
      const bool is_l = u_sel < gamma_l;
      const bool is_f = !is_l && u_sel < gamma_l + gamma_f;

      evals += valid > 0.5f ? m_cost : 2 * m_cost;
      kadd(w, wc, dwell);
      if (emit_now && live && r == 0 && writer) {
        a.ws[emit_row * n + chain] = dwell;
        a.es[emit_row * n + chain] = evals;
      }
      // the moments and emissions take the pre-transition x
      if (owner)
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) {
          kadd(wx[k], wxc[k], dwell * x[k]);
          kadd(wx2[k], wx2c[k], dwell * x[k] * x[k]);
          if constexpr (PAD) {
            if (emit_now && live && writer && dim(k) < D)
              a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
          } else {
            if (emit_now && live && writer) a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
          }
        }
      if (is_l) {
        u = u_l;
        h_back = h_cur;
        move();
      } else if (is_f) {
        h_back = h_l;
        flip();
      } else if (owner) {
        // refresh by Box-Muller's cosine branch from words 1+i, 1+D+i
MJHMC_MM_UNROLL_OWNED(NG)
        for (int gq = 0; gq < NG; ++gq) {
          float z[4];
          normals4<D, 1, PAD>(a, chain, t, 4 * (r + gq * R), kTagMjhmc, 0u, sqm, key, z);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[4 * gq + j] = z[j];
        }
      }
      valid = (is_l || is_f) ? 1.f : 0.f;
    } else {
      // Metropolis on H_L (control) or on Δ (MALT); a non-finite value
      // rejects, a NaN log-ratio too (as jnp.minimum keeps NaN); then the
      // post-transition x with weight 1
      const float h = VAR == kControl ? h_l : delta;
      const float lr = VAR == kControl ? h_cur - h : -delta;
      const bool ok = fabsf(h) < 1e30f && h == h;
      const float lp = lr > 0.f ? 0.f : lr;
      const float pacc = ok ? expf(lp) : 0.f;
      const uint32_t tag = VAR == kControl ? kTagControl : kTagMaltRefresh;
      const float um = a.fixed_uniform
          ? 0x1p-25f
          : philox_uniform(philox_word(chain, t, 2 * D, key, tag));
      if (um < pacc) {
        u = VAR == kControl ? u_l : ul;
        move();
      } else {
        flip();  // MALT: −v0
      }
      evals += m_cost;
      kadd(w, wc, 1.f);
      if (emit_now && live && r == 0 && writer) {
        a.ws[emit_row * n + chain] = 1.f;
        a.es[emit_row * n + chain] = evals;
      }
      if (owner)
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) {
          kadd(wx[k], wxc[k], x[k]);
          kadd(wx2[k], wx2c[k], x[k] * x[k]);
          if constexpr (PAD) {
            if (emit_now && live && writer && dim(k) < D)
              a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
          } else {
            if (emit_now && live && writer) a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
          }
        }
    }
    prof.mark(kMmDecide);
  }

  if (owner && live && writer)
MJHMC_MM_UNROLL_OWNED(NE)
    for (int k = 0; k < NE; ++k) {
      if constexpr (PAD) {
        if (dim(k) >= D) continue;
      }
      const size_t gi = (size_t)dim(k) * n + chain;
      a.xo[gi] = x[k];
      a.vo[gi] = v[k];
      a.go[gi] = g[k];
      a.wx[gi] = wx[k];
      a.wx2[gi] = wx2[k];
    }
  if (r == 0 && live && writer) {
    a.uo[chain] = u;
    a.hbo[chain] = h_back;
    a.valido[chain] = valid;
    a.w[chain] = w;
    a.evals[chain] = evals;
  }
  if constexpr (RING) ring.finish();
  prof.mark(kMmOther);
  prof.write(a, T);
}

// ---------------------------------------------------------------------------
// NUTS: the step body _make_step_nuts (pallas_mjhmc.py:1011-1210) on the
// matmul energies, with the semantics of the elementwise nuts_kernel
// (mjhmc_engine.cuh): per chain and iteration a fresh v0 ~ N(0, M)
// (tag 1), up to max_depth doubling rounds in directions drawn from tag 2,
// progressive multinomial sampling with leaf uniforms drawn from tag 3 by
// tree position, the binary-counter U-turn stack, divergence at |h| ≥
// 1e30, NaN or ΔH > 1000, the biased merge and the global U-turn; output
// (x_prop, v0, g_prop, u_prop) with h_back and valid passed through, the
// post-transition x with weight 1, and evals equal to the integrated leaves.
//
// Design: a block runs the NC chains of its tile in lockstep, one column
// each, as the TPU's lane block does (NUTS has no backward trajectory).
// The tiles are narrow (NutsTile, from the tile rule: at the presets 8
// chains for product of t and logistic regression, 16 for sparse coding;
// 8 where a large parameter matrix needs the room), so that the presets'
// widths make
// 256-512 blocks, two or more resident on each of the 132 SMs, and a tile
// runs few leaves that only its deepest tree needs. Each leaf is one
// leapfrog step of every column: the energy's two contractions over the
// tile through contract() (mma.sync at the bf16 precisions), whose
// epilogues write y, r or z and the gradient of every column. The rest is
// the work of the element owners: thread tid owns column c = tid % NC and
// the dims (and the rows of the intermediate) r, r + R, ... (r = tid / NC,
// R = T / NC). An owner keeps the trajectory's x, v, g and the chain's
// sample x, g of its elements in registers, runs their kick-drift and
// closing kick (a column that is done or stopped keeps its state), and
// reads and writes their rows of the tree state, which no other thread
// touches, so the tree state needs no barrier. A column's sums (its
// energy, ½vᵀM⁻¹v, the U-turn projections) are each owner's partial sum in
// its dim order, then the R partials added in row order through shared
// memory (red); every owner of the column reads them, so all R owners keep
// the chain's scalars (u, h0, the log weights, done, stop, the direction,
// the leaf count) alike and no flag is broadcast. A leaf takes four
// barriers: the __syncthreads_or that decides whether it runs, after the
// owners' kick-drift, one after each contraction, and one before the
// partials are read; a round one more, for its end's U-turn check. Every
// draw is keyed by (chain, iteration, slot, tag), so no chain's result
// depends on the tiling.
//
// The tree state (both endpoints' x, v, g in the trajectory frame, the
// subtree proposal's x, g and the 2(max_depth − 1) U-turn stack rows,
// nuts::rows) is rows(max_depth)·DP floats a chain. It lives in shared
// memory where the tile's fits beside the rest at max_depth 12 (kTileDepth;
// the tile rule's onchip: product of t 25 KB and logreg 11 KB a tile at
// max_depth 8), else (sparse coding, 11 KB a chain) in the (rows, DP, n)
// scratch buffer in device memory that the wrapper allocates (after the
// parameter matrix where that is off chip), where an owner's loads are
// independent (all in flight at once) and a warp's are coalesced across the
// tile's chains. max_depth runs 1..kMaxDepth (31: a tree's 2^31 − 1 leaves
// and every tree position fit an int32, as JAX's leaf counters are) at run
// time, and a launch up to kTileDepth takes the shared memory of its own
// max_depth (NutsLayout::floats): each depth adds 2·D·NC floats of stack
// (on chip) and 2·T of column-sum slots, so trees past 10 may hold fewer
// blocks an SM (product of t at highest three where it holds four up to
// 10) while shallower launches keep theirs. The tile rule sizes every tile
// at kTileDepth, so a deeper tree runs on the same tile: its launch takes the
// DEEP instance (the branch instance, M = I where no mass is given, which
// multiplies by 1 exactly; instantiated beside the others, launch_body_at),
// whose shared memory is the layout at kTileDepth and whose stack rows and
// span slots past it (2(max_depth − kTileDepth) of each, mm ≥ kTileDepth)
// live in the device scratch: the rows (rows,
// DP, n) coalesced across chains as sparse coding's tree state is (that
// state grows by them where it is in the scratch already), the slots a
// block's [slot][T] after them. Those spans close once in 4,096 leaves or
// fewer, so their device-memory round trips are rare. Round jj's leaves are
// tree positions 2^jj − 1 .. 2^(jj+1) − 2 (at most 2^31 − 2), span slots
// kSpan + 2(mm − 1) for mm ≤ jj < max_depth, so no loop or slot assumes a
// depth. The elementwise arithmetic rounds one IEEE
// operation at a time, as the plain version does; the contractions and the
// column sums add in other orders than torch.matmul and the plain version's
// sums, so trees are held to the plain version at a tolerance, not bit for
// bit.
//
// What bounds it: latency, not the card's rates (the operations are a few
// percent of the bound's time, PERF.md §6). A leaf is a chain of dependent
// steps between four barriers, the two contractions a third to a half of
// its cycles, then the owners' partials and column sums and the tree
// bookkeeping, and a tile runs as many leaves as its deepest tree. Two to
// four resident blocks an SM overlap one block's barriers with another's
// work. Sparse coding also waits on its stack rows in device memory, and
// its instances sit at the 128 registers a thread that two blocks an SM
// allow, with some spills (PERF.md §6 lists the breakdown, the registers
// and the spills).
namespace nuts {

// the deepest tree (2^31 − 1 leaves: its leaf counts and tree positions fit
// an int32), and the depth whose layout the tile rule fits on chip
constexpr int kMaxDepth = 31;
constexpr int kTileDepth = 12;
constexpr float kDivThreshold = 1000.0f;
// tree rows: the tree endpoints, the subtree proposal, then the stack
// (x, v of span row mm at kStack + 2(mm − 1))
enum Row { kXM = 0, kVM, kGM, kXP, kVP, kGP, kXS, kGS, kStack };
__host__ __device__ constexpr int rows(int max_depth) { return kStack + 2 * (max_depth - 1); }
// the column sums' slots in red: the round end's two U-turn projections,
// a leaf's two energy terms (kE1 is also ½v0ᵀM⁻¹v0 at an iteration's
// start) and ½vᵀM⁻¹v, then two for each U-turn span that can close at a
// leaf. A slot is written again only after a barrier that follows its reads.
enum Slot { kEndM = 0, kEndP, kE1, kE2, kHalf, kSpan };
__host__ __device__ constexpr int slots(int max_depth) { return kSpan + 2 * (max_depth - 1); }
// the stack rows and the span slots a DEEP launch keeps in the device
// scratch: those of the spans mm ≥ kTileDepth
__host__ __device__ constexpr int deep_rows(int max_depth) {
  return max_depth > kTileDepth ? 2 * (max_depth - kTileDepth) : 0;
}

// jnp.logaddexp: max + log1p(exp(−|Δ|)), or a + b where Δ is NaN
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = __fsub_rn(a, b);
  if (d != d) return __fadd_rn(a, b);
  return __fadd_rn(a > b ? a : b, log1pf(expf(-fabsf(d))));
}

__device__ __forceinline__ float uniform(const Args& a, uint32_t word) {
  return a.fixed_uniform ? 0x1p-25f : philox_uniform(word);
}

// The PROF instances' per-leaf phase breakdown (PhaseClock): each phase's
// cycles, the waits inside block barriers (kPhBarrier) apart, and the
// block's leaf steps (kPhLeaves)
enum Phase {
  kPhKickDrift = 0, kPhContract1, kPhContract2, kPhEnergy, kPhMultinomial, kPhStack,
  kPhLeafUturn, kPhRoundEnd, kPhBarrier, kPhOther, kPhLeaves, kPhases
};
template <bool ON>
using Prof = PhaseClock<ON, kPhases, kPhBarrier>;

}  // namespace nuts

// The NUTS geometry of energy E at (D, K) on a tile of NC chains (one
// column each) and T threads, T a multiple of NC so that a thread's
// elements lie in one column: R = T / NC owners a column, each owning the
// dims r, r + R, ... (NE of them, DP in all) and the rows of the
// intermediate r, r + R, ... (NK, KP in all); DP ≥ D and KP ≥ K pad the
// tile as mm_geom's do. Then the shared memory, in floats: the parameter
// matrix as load_params writes it (f32 copies A1, A2 at kHighest, else the
// bf16 A fragments at FRAG; none where off), the patch [K4], X and G [DP][NC],
// Y and Z [KP][NC] (no Z at sparse coding) and the mass [2DP]; then, sized by
// max_depth, the tree state (onchip) and the column sums' partials, slots
// × T (ops/cuda_mjhmc.py::nuts_mm_geometry mirrors this). KC > 0: Y and Z
// hold a chunk of KC rows (kp = KC, nk = KC / R) and the patch is read from
// device memory; XG: X, G [DP][NC] and the mass [2DP] in the block's slice
// of the device scratch (after the parameter matrix and the tree state
// there, 16-byte aligned), none of them in shared memory.
struct NutsGeom {
  int r, ne, nk, dp, kp, nc, t;
  int a1, a2, patch, x, g, y, z, mass, frag, tree;
  bool onchip;
  int slice;             // xg: the block's floats of the device scratch
  int ring, zb, xb, gp;  // NS > 0: mm_geom's
  __host__ __device__ constexpr int red(int max_depth) const {
    return tree + (onchip ? nuts::rows(max_depth) * dp * nc : 0);
  }
  __host__ __device__ constexpr int floats(int max_depth) const {
    return red(max_depth) + nuts::slots(max_depth) * t;
  }
};
__host__ __device__ constexpr NutsGeom nuts_geom(int E, int P, bool OFF, bool ONCHIP, int D,
                                                 int K, int NC, int T, int KC = 0,
                                                 bool XG = false, int NS = 0) {
  NutsGeom m{};
  m.nc = NC;
  m.t = T;
  m.r = T / NC;
  m.ne = cdiv(D, m.r);
  m.dp = m.r * m.ne;
  m.nk = KC ? KC / m.r : cdiv(K, m.r);
  m.kp = KC ? KC : m.r * m.nk;
  const bool f32 = P == kHighest && !OFF;
  const int copies = OFF || P == kHighest ? 0 : P == kBf16x3 ? 2 : 1;
  m.a1 = 0;
  m.a2 = m.a1 + (f32 ? D * round_up(K, 4) : 0);
  m.patch = m.a2 + (f32 ? K * round_up(D, 4) : 0);
  m.x = m.patch + (KC ? 0 : round_up(K, 4));
  m.g = m.x + (XG ? 0 : m.dp * NC);
  m.y = m.g + (XG ? 0 : m.dp * NC);
  m.z = m.y + m.kp * NC;
  m.mass = m.z + (E != kSparseCoding && !NS ? m.kp * NC : 0);
  m.frag = (m.mass + (XG ? 0 : 2 * m.dp) + 3) / 4 * 4;  // 16-byte aligned
  m.ring = m.frag + 2 * copies * (pad16(K) * pad16(D) / 2);
  m.zb = m.ring + ring_floats(T, P, NS);
  m.xb = m.zb + (NS ? zb_floats(KC, NC, P) : 0);
  m.gp = m.xb + (NS ? xb_floats(D, NC, P) : 0);
  m.tree = m.gp + (NS && ONCHIP ? split_floats(m.dp, NC, T) : 0);
  m.onchip = ONCHIP;
  m.slice = XG ? round_up(m.dp * (2 * NC + 2), 4) : 0;  // 16-byte aligned
  return m;
}
// The NUTS tile of energy E at (D, K) and precision P (the tile rule above;
// the layout at kTileDepth must fit)
__host__ __device__ constexpr TileRule nuts_rule(int E, int P, int D, int K) {
  const int nc0 = base_chains(E, kNuts), t0 = base_threads(E);
  for (int off = 0; off < 2; ++off)
    for (int nc = nc0; nc >= 8; nc /= 2) {
      const int t = round_up(t0 / nc0 * nc, 32);
      if (4 * nuts_geom(E, P, off != 0, false, D, K, nc, t).floats(nuts::kTileDepth) >
          kSmemBlock)
        continue;
      const bool onchip =
          4 * nuts_geom(E, P, off != 0, true, D, K, nc, t).floats(nuts::kTileDepth) <= kSmemBlock;
      return {nc, t, minb_for(E, nuts_geom(E, P, off != 0, onchip, D, K, nc, t).floats(1)),
              off != 0, onchip};
    }
  // chunked k, the parameter matrix off chip (mm_rule's passes): without a
  // ring the largest kc, the tree state on chip where it fits beside the
  // rest at kTileDepth; with one the tree state on chip where any ring and
  // chunk let it fit, then the most stages, then the largest kc
  for (int pass = P == kHighest ? 1 : 0; pass < 3; ++pass)
    for (int nc = pass == 2 ? 8 : nc0; nc >= 8; nc /= 2) {
      const int xg = pass == 2;
      const bool ring = pass == 0;
      int t = round_up(t0 / nc0 * nc, 32);
      if (ring) t = max_of(t, kRingThreads);
      while (2 * t <= kMaxThreads && cdiv(D, t / nc) > kOwnerDims) t *= 2;
      const int q = ring ? ring_quantum(t / nc, t) : chunk_quantum(t / nc);
      for (int onchip = 1; onchip >= 0; --onchip)
        for (int ns = ring ? kMaxStages : 0; ns >= (ring ? kMinStages : 0); --ns)
          for (int kc = chunk_start(K, q); kc >= q; kc -= q) {
            if (!ring && onchip) {
              // the largest kc off chip decides; then on chip if it fits
              if (4 * nuts_geom(E, P, true, false, D, K, nc, t, kc, xg != 0).floats(
                          nuts::kTileDepth) > kSmemBlock)
                continue;
              const bool on = 4 * nuts_geom(E, P, true, true, D, K, nc, t, kc, xg != 0)
                                      .floats(nuts::kTileDepth) <= kSmemBlock;
              const int floats = nuts_geom(E, P, true, on, D, K, nc, t, kc, xg != 0).floats(1);
              return {nc, t, chunked_minb(E, floats, t), true, on, kc, xg != 0};
            }
            const NutsGeom m = nuts_geom(E, P, true, onchip != 0, D, K, nc, t, kc, xg != 0, ns);
            if (4 * m.floats(nuts::kTileDepth) <= kSmemBlock)
              return {nc, t, chunked_minb(E, m.floats(1), t), true, onchip != 0, kc, xg != 0, ns};
          }
    }
  return {0, 0, 0, true, false};
}

// The NUTS tile of energy E at (D, K) and precision P: NC chains and T
// threads a block, MINB blocks an SM asked of __launch_bounds__, OFF the
// parameter matrix in a device buffer, ONCHIP the tree state in shared
// memory (else in the (rows, DP, n) scratch buffer in device memory that the
// wrapper allocates, after the parameter matrix's where OFF)
template <int E, int D, int K, int P>
struct NutsTile {
  static constexpr TileRule rule = nuts_rule(E, P, D, K);
  static_assert(rule.ch > 0, "no tile of nuts_mm_kernel fits this shape, even off chip");
  static constexpr int NC = rule.ch, T = rule.t, MINB = rule.minb, KC = rule.kc, NS = rule.ns;
  static constexpr bool OFF = rule.off, ONCHIP = rule.onchip, XG = rule.xg;
};

// The NUTS kernel's layout (nuts_geom) on its tile
template <int E, int D, int K, int P>
struct NutsLayout {
  using TL = NutsTile<E, D, K, P>;
  static constexpr NutsGeom M =
      nuts_geom(E, P, TL::OFF, TL::ONCHIP, D, K, TL::NC, TL::T, TL::KC, TL::XG, TL::NS);
  static constexpr int NC = TL::NC, T = TL::T, R = M.r, NE = M.ne, NK = M.nk, DP = M.dp,
                       KP = M.kp, KC = TL::KC, SLICE = M.slice, NS = TL::NS, RING = M.ring,
                       ZB = M.zb, XB = M.xb, GP = M.gp;
  static constexpr bool XG = TL::XG;
  // a tile that may split over a cluster (the ring's tiles with the tree
  // state on chip)
  static constexpr bool SPLITS = NS > 0 && TL::ONCHIP;
  static_assert(T % NC == 0 && DP >= D && (KC ? KC % 16 == 0 && KC % R == 0 && TL::OFF : KP >= K),
                "a thread's elements in one column");
  static_assert(NC % 8 == 0, "mma.sync n-tiles of 8 columns");
  static constexpr int A1 = M.a1, A2 = M.a2, PATCH = M.patch, X = M.x, G = M.g, Y = M.y,
                       Z = M.z, MASS = M.mass, FRAG = M.frag, TREE = M.tree;
  // from the scalars alone, so that device code can call them (nuts_geom's)
  __host__ __device__ static constexpr int red(int max_depth) {
    return TREE + (TL::ONCHIP ? nuts::rows(max_depth) * DP * NC : 0);
  }
  __host__ __device__ static constexpr int floats(int max_depth) {
    return red(max_depth) + nuts::slots(max_depth) * T;
  }
  static_assert(floats(nuts::kTileDepth) == M.floats(nuts::kTileDepth), "nuts_geom's floats");
};

// DEEP: the instance for trees past kTileDepth (the shared memory of the
// layout at kTileDepth, the stack rows and span slots past it in a.scratch),
// kept apart from the others: its accesses that branch between the two
// memories cost trees to kTileDepth 11-17% (product of t with a mass,
// PERF.md §6 PR 21)
template <int E, int D, int K, bool EMIT, bool BR, int P, bool PROF, bool DEEP = false>
__global__ void __launch_bounds__(NutsTile<E, D, K, P>::T, NutsTile<E, D, K, P>::MINB)
    nuts_mm_kernel(Args a) {
  using namespace nuts;
  using L = NutsLayout<E, D, K, P>;
  using TL = NutsTile<E, D, K, P>;
  constexpr int NC = L::NC, T = L::T, R = L::R, DP = L::DP, KP = L::KP;
  constexpr int NE = L::NE, NK = L::NK;  // a thread's dims and rows of the intermediate
  // a padded tile's dims past D and rows past K (nuts_geom), and the
  // parameter matrix in the device buffer (a.scratch) where it is OFF
  constexpr bool PAD = DP != D, OFF = TL::OFF;
  constexpr int D4 = round_up(D, 4);

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* X = sm + L::X;
  float* G = sm + L::G;
  float* Y = sm + L::Y;
  float* IM = sm + L::MASS;  // [DP] M^-1, then [DP] sqrt(M)
  const int max_depth = a.m;
  // the depth whose layout the shared memory holds
  int chip_depth = max_depth;
  if constexpr (DEEP) chip_depth = min(max_depth, kTileDepth);
  float* tree_s = sm + L::TREE;           // ONCHIP: [rows][DP][NC]
  float* red = sm + L::red(chip_depth);   // [slots][T]
  // KC: the intermediate's rows in chunks; XG: X, G and the mass in the
  // block's slice of a.scratch, after the parameter matrix and the tree
  // state there (nuts_geom); DEEP: the tree rows past kTileDepth's where the
  // rest are on chip (after the parameter matrix where OFF), and a block's
  // span slots past kTileDepth's after the slices (ops/cuda_mjhmc.py,
  // nuts_scratch_floats, mirrors this)
  constexpr int KC = L::KC;
  constexpr bool XG = L::XG;
  constexpr size_t kHead = OFF ? Params<D, K, P>::kFloats : 0;
  float* deep_tree = nullptr;
  float* deep_red = nullptr;
  uint32_t* XB = reinterpret_cast<uint32_t*>(sm + L::XB);  // the ring's tiles: X's fragments
  if constexpr (DEEP) {
    const size_t tree_floats =
        (size_t)(TL::ONCHIP ? deep_rows(max_depth) : rows(max_depth)) * DP * a.n;
    const size_t slices = (kHead + tree_floats + 3) / 4 * 4;
    deep_tree = a.scratch + kHead;
    deep_red = a.scratch + slices + (XG ? (size_t)gridDim.x * L::SLICE : 0) +
               (size_t)blockIdx.x * deep_rows(max_depth) * T;
    if constexpr (XG) {
      X = a.scratch + slices + (size_t)blockIdx.x * L::SLICE;
      G = X + DP * NC;
      IM = G + DP * NC;
    }
  } else if constexpr (XG) {
    const size_t tree_floats = TL::ONCHIP ? 0 : (size_t)rows(max_depth) * DP * a.n;
    X = a.scratch + (Params<D, K, P>::kFloats + tree_floats + 3) / 4 * 4 +
        (size_t)blockIdx.x * L::SLICE;
    G = X + DP * NC;
    IM = G + DP * NC;
  }

  // the ring's tiles (NS > 0): mm_kernel's
  constexpr bool RING = L::NS > 0;
  typename RingIf<RING, Ring<D, K, RING ? KC : 16, T, RING ? P : kDefault, RING ? L::NS : 1>>::type
      ring;
  int tile = blockIdx.x;
  bool writer = true;
  if constexpr (RING) {
    tile = blockIdx.x / cl::size();
    writer = cl::rank() == 0;
  }

  const int tid = threadIdx.x, c = tid % NC, r = tid / NC;
  const int chain = tile * NC + c;
  const size_t n = a.n;
  const bool chain_live = chain < a.n;
  const float eps = a.eps, he = 0.5f * a.eps;
  const uint2 key = make_uint2(a.seed, 0u);

  Prof<PROF> prof;
  prof.start();
  // G's rows past the contraction's D4 are never written: 0, as the padded
  // dims' gradient
  if constexpr (DP != D4)
    for (int idx = tid; idx < (DP - D4) * NC; idx += T) G[D4 * NC + idx] = 0.f;
  // chunked, the patch is read from device memory (a.p1)
  load_params<E, D, K, DP, T, BR, P, OFF>(a, sm + L::A1, sm + L::A2,
                                          KC > 0 ? nullptr : sm + L::PATCH, IM,
                                          reinterpret_cast<uint32_t*>(sm + L::FRAG));
  if constexpr (RING) {
    ring.init(sm + L::RING, a.scratch);
    if (ring.csize > 1) cl::arrive();  // pairs the first gradient's wait
  }

  auto dim = [&](int k) { return r + k * R; };  // the thread's k-th dim
  auto im = [&](int i) { return BR ? IM[i] : 1.f; };
  // tree row rr, dim i of the thread's chain (only its owners touch it)
  auto tree = [&](int rr, int i) -> float& {
    // else (rows, DP, n) in a.scratch, after the parameter matrix where OFF
    if constexpr (TL::ONCHIP)
      return tree_s[(rr * DP + i) * NC + c];
    else if constexpr (OFF)
      return a.scratch[Params<D, K, P>::kFloats + ((size_t)rr * DP + i) * n + chain];
    else
      return a.scratch[((size_t)rr * DP + i) * n + chain];
  };
  // DEEP: the stack rows past kTileDepth's where the rest are on chip, and
  // the span slots past kTileDepth's, in a.scratch. Each access below
  // branches between the two memories, so that every load and store keeps
  // its own address space (a reference that may point to either would
  // take generic loads and stores at every leaf)
  auto deep_row = [&](int rr) { return DEEP && TL::ONCHIP && rr >= rows(kTileDepth); };
  auto deep_at = [&](int rr, int i) -> float& {
    return deep_tree[((size_t)(rr - rows(kTileDepth)) * DP + i) * n + chain];
  };
  // (the ring's tiles: a split tile's rows are its rank 0's, read past L1)
  auto stack = [&](int rr, int i) -> float {
    if constexpr (RING) {
      if (deep_row(rr)) return __ldcg(&deep_at(rr, i));
    } else {
      if (deep_row(rr)) return deep_at(rr, i);
    }
    return tree(rr, i);
  };
  auto set_stack = [&](int rr, int i, float v) {
    if (deep_row(rr)) {
      if (writer) deep_at(rr, i) = v;
    } else {
      tree(rr, i) = v;
    }
  };
  auto put = [&](int s, float part) {
    if (DEEP && s >= slots(kTileDepth))
      deep_red[(s - slots(kTileDepth)) * T + tid] = part;
    else
      red[s * T + tid] = part;
  };
  auto col_sum = [&](int s) {
    if (DEEP && s >= slots(kTileDepth))
      return column_sum<T, NC>(deep_red, s - slots(kTileDepth), c);
    return column_sum<T, NC>(red, s, c);
  };
  // acc + ((xa − xb)·w)·M^-1 of dim i (a U-turn projection's term)
  auto proj = [&](float acc, float xa, float xb, float w, int i) {
    return __fadd_rn(acc, __fmul_rn(__fmul_rn(__fsub_rn(xa, xb), w), im(i)));
  };
  // chunked: the thread's partial of the leaf's rows' terms (the energy's
  // second sum), added chunk by chunk in row order as the loop below adds
  // them
  float e2c = 0.f;
  auto chunk_terms = [&](int k0) {
    for (int k = 0; k < NK; ++k) {
      const int rl = dim(k);  // the chunk's row k0 + rl
      if (k0 + rl >= K) break;
      const float y = Y[rl * NC + c];
      if constexpr (E == kProductOfT)  // log1p(y²/ν)
        e2c = __fadd_rn(e2c, log1pf(__fmul_rn(__fmul_rn(y, y), a.k3)));
      else if constexpr (E == kSparseCoding)  // r²
        e2c = __fadd_rn(e2c, __fmul_rn(y, y));
      else  // softplus(z) = max(z, 0) + log1p(e^{−|z|})
        e2c = __fadd_rn(e2c, __fadd_rn(fmaxf(y, 0.f), log1pf(expf(-fabsf(y)))));
    }
  };

  // the chain's sample (x, g) and Kahan moments, and the trajectory (xt,
  // vt, gt), of the thread's elements; the chains past n (ragged last
  // tile) are never live
  float x[NE], g[NE], wx[NE], wxc[NE], wx2[NE], wx2c[NE], xt[NE], vt[NE], gt[NE];
MJHMC_MM_UNROLL_OWNED(NE)
  for (int k = 0; k < NE; ++k) {
    const size_t gi = (size_t)dim(k) * n + chain;
    if constexpr (PAD) {  // a padded dim starts at 0
      const bool in = chain_live && dim(k) < D;
      x[k] = in ? a.x[gi] : 0.f;
      g[k] = in ? a.g[gi] : 0.f;
      wx[k] = wxc[k] = wx2[k] = wx2c[k] = 0.f;
      xt[k] = vt[k] = gt[k] = 0.f;
      if (in && writer && a.num_iters == 0) a.vo[gi] = a.v[gi];
    } else {
      x[k] = chain_live ? a.x[gi] : 0.f;
      g[k] = chain_live ? a.g[gi] : 0.f;
      wx[k] = wxc[k] = wx2[k] = wx2c[k] = 0.f;
      xt[k] = vt[k] = gt[k] = 0.f;
      // each iteration writes its v0
      if (chain_live && writer && a.num_iters == 0) a.vo[gi] = a.v[gi];
    }
  }
  // the chain's scalars, kept alike by its R owners
  float u = chain_live ? a.u[chain] : 0.f;
  float w = 0.f, wc = 0.f;
  int evals = 0;
  float h0 = 0.f, log_w_tree = 0.f, log_w_sub = kNegInf, us = 0.f;
  bool done = true, stop = false, right = false;
  uint32_t merge_word = 0;
  int nl = 0;

  for (int t = 0; t < a.num_iters; ++t) {
    // a fresh momentum v0 ~ N(0, M) (words i and D+i of tag 1); both tree
    // endpoints start at the chain's point
    float hv = 0.f;
    if (chain_live) {
MJHMC_MM_UNROLL_OWNED(NE)
      for (int k = 0; k < NE; ++k) {
        const int i = dim(k);
        float v0 = normal_of<D>(a, chain, t, i, kTagNutsMomentum, 0u,
                                BR ? IM[DP + i] : 1.f, key);
        if constexpr (PAD) {  // a padded dim draws no momentum
          v0 = i < D ? v0 : 0.f;
          if (i < D && writer) a.vo[(size_t)i * n + chain] = v0;
        } else {
          if (writer) a.vo[(size_t)i * n + chain] = v0;
        }
        tree(kXM, i) = tree(kXP, i) = x[k];
        tree(kVM, i) = tree(kVP, i) = v0;
        tree(kGM, i) = tree(kGP, i) = g[k];
        hv = __fadd_rn(hv, __fmul_rn(__fmul_rn(v0, v0), im(i)));
      }
    }
    put(kE1, hv);
    prof.sync(kPhOther);
    done = !chain_live;
    h0 = __fadd_rn(u, __fmul_rn(0.5f, col_sum(kE1)));
    log_w_tree = 0.f;
    nl = 0;

    for (int jj = 0; jj < max_depth; ++jj) {
      if (!prof.sync_or(kPhOther, !done)) break;
      // the round's direction, and the integration frame: outward from the
      // chosen endpoint (the minus end's momentum negated)
      stop = false;
      log_w_sub = kNegInf;
      if (!done) {
        const uint4 rr = philox4x32_10(make_uint4(chain, t, jj, kTagNutsRound), key);
        right = uniform(a, rr.x) < 0.5f;
        merge_word = rr.y;
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) {
          const int i = dim(k);
          xt[k] = tree(right ? kXP : kXM, i);
          vt[k] = right ? tree(kVP, i) : -tree(kVM, i);
          gt[k] = tree(right ? kGP : kGM, i);
        }
      }
      prof.mark(kPhOther);

      const int leaves = 1 << jj;
      const uint32_t k0 = leaves - 1;  // tree position of the round's first leaf
      for (int leaf = 0; leaf < leaves; ++leaf) {
        const bool act = !done && !stop;
        // the owners' half kick and drift, into X for the contractions
        if (act) {
MJHMC_MM_UNROLL_OWNED(NE)
          for (int k = 0; k < NE; ++k) {
            const int i = dim(k);
            vt[k] = __fsub_rn(vt[k], __fmul_rn(he, gt[k]));
            xt[k] = __fadd_rn(xt[k], __fmul_rn(eps, BR ? __fmul_rn(IM[i], vt[k]) : vt[k]));
            X[i * NC + c] = xt[k];
          }
        }
        if (!prof.sync_or(kPhKickDrift, act)) break;
        prof.count(kPhLeaves);
        // the leaf's gradient, rounded one operation at a time
        if constexpr (KC > 0 && RING) {
          e2c = 0.f;
          gradient_ring<E, D, K, KC, NC, NC, NC, T, P, true, false, L::NS>(
              ring, a.p1, X, Y, XB, reinterpret_cast<uint32_t*>(sm + L::ZB), G, sm + L::GP,
              sm + L::GP + DP * NC, a, false,
              chunk_terms, [&] { prof.sync(kPhContract1); }, [&] { prof.sync(kPhContract2); },
              [&](float* ep) { ep[tid] = e2c; }, [&](int j, float e) {
                if (j == 0) e2c = e;
              });
        } else if constexpr (KC > 0) {
          e2c = 0.f;
          gradient_chunks<E, D, K, KC, NC, NC, NC, NC, T, P, true, false>(
              a.scratch, a.scratch + Params<D, K, P>::kF32_1,
              reinterpret_cast<const uint32_t*>(a.scratch), a.p1, X, Y, sm + L::Z, G, a, false,
              chunk_terms, [&] { prof.sync(kPhContract1); }, [&] { prof.sync(kPhContract2); });
        } else if constexpr (OFF)  // the parameter matrix in the head of a.scratch
          gradient_tile<E, D, K, NC, NC, T, false, P, true, false>(
              a.scratch, a.scratch + Params<D, K, P>::kF32_1,
              reinterpret_cast<const uint32_t*>(a.scratch), sm + L::PATCH, X, Y, sm + L::Z, G, a,
              false, [&] { prof.sync(kPhContract1); });
        else
          gradient_tile<E, D, K, NC, NC, T, false, P, true, false>(
              sm + L::A1, sm + L::A2, reinterpret_cast<const uint32_t*>(sm + L::FRAG),
              sm + L::PATCH, X, Y, sm + L::Z, G, a, false, [&] { prof.sync(kPhContract1); });
        prof.sync(kPhContract2);
        // the owners' closing kick and partial sums: the energy's terms,
        // v²·M^-1, and the U-turn projections of the spans of size 2^mm
        // that end at this leaf (2^mm divides leaf + 1) against their left
        // ends stored at earlier leaves
        if (act) {
          float e1 = 0.f, e2 = 0.f;
          hv = 0.f;
MJHMC_MM_UNROLL_OWNED(NE)
          for (int k = 0; k < NE; ++k) {
            const int i = dim(k);
            gt[k] = G[i * NC + c];
            vt[k] = __fsub_rn(vt[k], __fmul_rn(he, gt[k]));
            hv = __fadd_rn(hv, __fmul_rn(__fmul_rn(vt[k], vt[k]), im(i)));
            if constexpr (E == kSparseCoding && PAD) {  // λ-term √(a²+ε), none padded
              if (i < D) e1 = __fadd_rn(e1, sqrtf(__fadd_rn(__fmul_rn(xt[k], xt[k]), a.k3)));
            } else if constexpr (E == kSparseCoding) {  // λ-term √(a²+ε)
              e1 = __fadd_rn(e1, sqrtf(__fadd_rn(__fmul_rn(xt[k], xt[k]), a.k3)));
            } else if constexpr (E == kLogreg) {  // the prior's θ²
              e1 = __fadd_rn(e1, __fmul_rn(xt[k], xt[k]));
            }
          }
          if constexpr (KC > 0) {
            e2 = e2c;
          } else {
#pragma unroll
            for (int k = 0; k < NK; ++k) {
              const float y = Y[dim(k) * NC + c];
              if constexpr (KP != K) {
                if (dim(k) >= K) continue;  // a padded row
              }
              if constexpr (E == kProductOfT)  // log1p(y²/ν)
                e2 = __fadd_rn(e2, log1pf(__fmul_rn(__fmul_rn(y, y), a.k3)));
              else if constexpr (E == kSparseCoding)  // r²
                e2 = __fadd_rn(e2, __fmul_rn(y, y));
              else  // softplus(z) = max(z, 0) + log1p(e^{−|z|})
                e2 = __fadd_rn(e2, __fadd_rn(fmaxf(y, 0.f), log1pf(expf(-fabsf(y)))));
            }
          }
          put(kE1, e1);
          put(kE2, e2);
          put(kHalf, hv);
          prof.mark(kPhEnergy);
          for (int mm = 1; mm <= jj && ((leaf + 1) & ((1 << mm) - 1)) == 0; ++mm) {
            const int row = kStack + 2 * (mm - 1);
            float d1 = 0.f, d2 = 0.f;
MJHMC_MM_UNROLL_OWNED(NE)
            for (int k = 0; k < NE; ++k) {
              const int i = dim(k);
              const float sx = stack(row, i), sv = stack(row + 1, i);
              d1 = proj(d1, xt[k], sx, sv, i);
              d2 = proj(d2, xt[k], sx, vt[k], i);
            }
            put(kSpan + 2 * (mm - 1), d1);
            put(kSpan + 2 * (mm - 1) + 1, d2);
          }
          prof.mark(kPhLeafUturn);
        }
        prof.sync(kPhLeafUturn);
        if (act) {
          // the leaf's energy, divergence and progressive multinomial sampling
          float ul;
          if constexpr (E == kProductOfT)
            ul = __fmul_rn(a.k2, col_sum(kE2));
          else if constexpr (E == kSparseCoding)
            ul = __fadd_rn(__fmul_rn(a.k0, col_sum(kE1)), __fmul_rn(a.k2, col_sum(kE2)));
          else
            ul = __fadd_rn(col_sum(kE2), __fmul_rn(a.k1, col_sum(kE1)));
          const float h = __fadd_rn(ul, __fmul_rn(0.5f, col_sum(kHalf)));
          prof.mark(kPhEnergy);
          ++nl;
          const float dh = __fsub_rn(h, h0);
          const bool div = fabsf(h) >= 1e30f || h != h || dh > kDivThreshold;
          const float lw_leaf = div ? kNegInf : -dh;
          const float lw_new = logaddexp(log_w_sub, lw_leaf);
          const float lu = logf(uniform(a, philox_word(chain, t, k0 + leaf, key, kTagNutsLeaf)));
          const bool taken = !div && lu < __fsub_rn(lw_leaf, lw_new);
          if (taken) us = ul;
          log_w_sub = lw_new;
          prof.mark(kPhMultinomial);
          bool turning = false;
          for (int mm = 1; mm <= jj && ((leaf + 1) & ((1 << mm) - 1)) == 0; ++mm)
            turning = turning || col_sum(kSpan + 2 * (mm - 1)) < 0.f ||
                      col_sum(kSpan + 2 * (mm - 1) + 1) < 0.f;
          stop = div || turning;
          prof.mark(kPhLeafUturn);
          // the taken leaf becomes the subtree's proposal; leaf i opens the
          // stack spans of size 2^mm that divide i
MJHMC_MM_UNROLL_OWNED(NE)
          for (int k = 0; k < NE; ++k) {
            const int i = dim(k);
            if (taken) {
              tree(kXS, i) = xt[k];
              tree(kGS, i) = gt[k];
            }
            for (int mm = 1; mm <= jj && (leaf & ((1 << mm) - 1)) == 0; ++mm) {
              set_stack(kStack + 2 * (mm - 1), i, xt[k]);
              set_stack(kStack + 2 * (mm - 1) + 1, i, vt[k]);
            }
          }
          prof.mark(kPhStack);
        }
      }

      // the biased merge of a completed subtree, then the tree's extension
      // (back to the trajectory frame) and the U-turn between its endpoints
      if (!done && !stop) {
        const bool merge = logf(uniform(a, merge_word)) < __fsub_rn(log_w_sub, log_w_tree);
        if (merge) u = us;
        log_w_tree = logaddexp(log_w_tree, log_w_sub);
        float dm = 0.f, dp = 0.f;
MJHMC_MM_UNROLL_OWNED(NE)
        for (int k = 0; k < NE; ++k) {
          const int i = dim(k);
          if (merge) {
            x[k] = tree(kXS, i);
            g[k] = tree(kGS, i);
          }
          float xp, vp, xm, vm;
          if (right) {
            tree(kXP, i) = xp = xt[k];
            tree(kVP, i) = vp = vt[k];
            tree(kGP, i) = gt[k];
            xm = tree(kXM, i);
            vm = tree(kVM, i);
          } else {
            tree(kXM, i) = xm = xt[k];
            tree(kVM, i) = vm = -vt[k];
            tree(kGM, i) = gt[k];
            xp = tree(kXP, i);
            vp = tree(kVP, i);
          }
          dm = proj(dm, xp, xm, vm, i);
          dp = proj(dp, xp, xm, vp, i);
        }
        put(kEndM, dm);
        put(kEndP, dp);
      }
      prof.sync(kPhRoundEnd);
      if (!done) done = stop || col_sum(kEndM) < 0.f || col_sum(kEndP) < 0.f;
      prof.mark(kPhRoundEnd);
    }

    // the post-transition x, weight 1
    const bool emit_now = EMIT && (t + 1) % a.thin == 0;
    const size_t emit_row = t / a.thin;
    if (chain_live) {
      evals += nl;
      kadd(w, wc, 1.f);
      if (emit_now && r == 0 && writer) {
        a.ws[emit_row * n + chain] = 1.f;
        a.es[emit_row * n + chain] = evals;
      }
MJHMC_MM_UNROLL_OWNED(NE)
      for (int k = 0; k < NE; ++k) {
        kadd(wx[k], wxc[k], x[k]);
        kadd(wx2[k], wx2c[k], x[k] * x[k]);
        if constexpr (PAD) {
          if (emit_now && writer && dim(k) < D) a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
        } else {
          if (emit_now && writer) a.xs[(emit_row * D + dim(k)) * n + chain] = x[k];
        }
      }
    }
    prof.mark(kPhOther);
  }

  if (chain_live && writer) {
MJHMC_MM_UNROLL_OWNED(NE)
    for (int k = 0; k < NE; ++k) {
      if constexpr (PAD) {
        if (dim(k) >= D) continue;
      }
      const size_t gi = (size_t)dim(k) * n + chain;
      a.xo[gi] = x[k];
      a.go[gi] = g[k];
      a.wx[gi] = wx[k];
      a.wx2[gi] = wx2[k];
    }
    if (r == 0) {
      a.uo[chain] = u;
      a.hbo[chain] = a.h_back[chain];
      a.valido[chain] = a.valid[chain];
      a.w[chain] = w;
      a.evals[chain] = evals;
    }
  }
  if constexpr (RING) ring.finish();
  prof.mark(kPhOther);
  prof.write(a, T);
}

// The clusters of C = 2, 4, 8 and 16 CTAs of kernel (T threads, bytes of
// shared memory a block) the card holds at once (0 where it holds none or
// refuses the size)
inline void clusters_held(void (*kernel)(Args), int T, int bytes, int* held) {
  for (int j = 0; j < 4; ++j) {
    const int c = kClusterSizes[j];
    held[j] = 0;
    if (c > 8 && cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
                     cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    cudaLaunchAttribute at{};
    at.id = cudaLaunchAttributeClusterDimension;
    at.val.clusterDim.x = c;
    at.val.clusterDim.y = at.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = bytes;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&held[j], kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      held[j] = 0;
    }
  }
}
// ... asked once for each device, kernel and shared bytes (a NUTS launch's
// bytes follow its max_depth), since NUTS and the adaptive loops launch an
// iteration at a time
inline void clusters_held_once(void (*kernel)(Args), int T, int bytes, int* held) {
  struct Seen {
    int device;
    void (*kernel)(Args);
    int bytes, held[4];
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& e : seen)
    if (e.device == device && e.kernel == kernel && e.bytes == bytes) {
      for (int j = 0; j < 4; ++j) held[j] = e.held[j];
      return;
    }
  Seen e{device, kernel, bytes, {}};
  clusters_held(kernel, T, bytes, e.held);
  seen.push_back(e);
  for (int j = 0; j < 4; ++j) held[j] = e.held[j];
}
// The chunks' fragments into the device buffer (Stream order), then kernel
// on the clusters its plan gives for the chains' tiles (ClusterPlan). A
// launch that the card refuses returns its error; there is no other route
template <int E, int D, int K, int P, int KC, int T>
cudaError_t launch_clustered(void (*kernel)(Args), Args a, int chains, int bytes, bool splits,
                             cudaStream_t stream) {
  if (!a.scratch) return cudaErrorInvalidValue;
  const int blocks = min_of(cdiv(Params<D, K, P>::kFloats, 256), 1024);
  stream_params_kernel<E, D, K, P, KC, T><<<blocks, 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int held[4] = {};
  if (splits) clusters_held_once(kernel, T, bytes, held);
  const ClusterPlan plan = cluster_plan(cdiv(a.n, chains), held, splits);
  cudaLaunchAttribute at{};
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = plan.c;
  at.val.clusterDim.y = at.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(plan.grid);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}
// The cluster entries of a tile report (tile_of, nuts_tile_at): out[8] the
// ring's stages (0: no cluster), out[9] whether a tile may split,
// out[10..13] the clusters of C = 2, 4, 8, 16 the card holds at once
template <int NS>
void cluster_report(void (*kernel)(Args), int T, int bytes, bool splits, int* out) {
  out[8] = NS;
  out[9] = NS > 0 && splits;
  for (int j = 0; j < 4; ++j) out[10 + j] = 0;
  if constexpr (NS > 0) clusters_held(kernel, T, bytes, out + 10);
}

// NUTS of energy E at (D, K) and precision P, run or stream (EMIT), without
// (BR=false) or with an inverse mass; the PROF instance writes the breakdown
// to a.prof; the DEEP instance (BR=true) takes the trees past kTileDepth,
// and only those. OFF: the parameter matrix into the head of a.scratch first
template <int E, int D, int K, int P, bool EMIT, bool BR, bool PROF = false, bool DEEP = false>
cudaError_t launch_nuts(const Args& a, cudaStream_t stream) {
  using L = NutsLayout<E, D, K, P>;
  using TL = NutsTile<E, D, K, P>;
  if ((a.m > nuts::kTileDepth) != DEEP || ((!TL::ONCHIP || TL::OFF || DEEP) && !a.scratch))
    return cudaErrorInvalidValue;
  const int bytes = L::floats(DEEP ? nuts::kTileDepth : a.m) * (int)sizeof(float);
  void (*kernel)(Args) = nuts_mm_kernel<E, D, K, EMIT, BR, P, PROF, DEEP>;
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if constexpr (L::NS > 0) {
    return launch_clustered<E, D, K, P, L::KC, L::T>(kernel, a, L::NC, bytes, L::SPLITS, stream);
  } else {
    if constexpr (TL::OFF) {
      err = launch_params<E, D, K, P>(a, stream);
      if (err != cudaSuccess) return err;
    }
    kernel<<<(a.n + L::NC - 1) / L::NC, L::T, bytes, stream>>>(a);
    return cudaGetLastError();
  }
}

// mm_kernel's body VAR of energy E at (D, K) and precision P; OFF: the
// parameter matrix into a.scratch first
template <int E, int D, int K, int VAR, bool EMIT, bool STUB, bool BR, int P, bool PROF = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = MmLayout<E, D, K, VAR, P, BR>;
  constexpr int bytes = L::kFloats * (int)sizeof(float);
  void (*kernel)(Args) = mm_kernel<E, D, K, VAR, EMIT, STUB, BR, P, PROF>;
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if constexpr (L::NS > 0) {
    return launch_clustered<E, D, K, P, L::KC, L::T>(kernel, a, L::CH, bytes, L::SPLITS, stream);
  } else {
    if constexpr (L::OFF) {
      err = launch_params<E, D, K, P>(a, stream);
      if (err != cudaSuccess) return err;
    }
    kernel<<<(a.n + L::CH - 1) / L::CH, L::T, bytes, stream>>>(a);
    return cudaGetLastError();
  }
}

// The tile of mm_kernel's run of body VAR at (D, K) and precision P (BR:
// the instance with the branches): out[0] chains and out[1] threads a
// block, out[2] shared-memory bytes, out[3] the blocks an SM holds at once
// (the card's occupancy query, which counts registers too); and the device
// buffer (a.scratch) it indexes: out[4] floats of a block's slice (X, G
// and the mass where XG, else 0), out[5] the parameter matrix's floats at
// its head (0 where on chip), out[6] 0 (NUTS's tree floats a chain), out[7]
// 0 (NUTS's span slots a block); out[8..13] cluster_report's
template <int E, int D, int K, int VAR, bool BR, int P>
cudaError_t tile_of(int* out) {
  using L = MmLayout<E, D, K, VAR, P, BR>;
  out[0] = L::CH;
  out[1] = L::T;
  out[2] = L::kFloats * (int)sizeof(float);
  out[4] = L::SLICE;
  out[5] = L::OFF ? Params<D, K, P>::kFloats : 0;
  out[6] = out[7] = 0;
  void (*kernel)(Args) = mm_kernel<E, D, K, VAR, false, false, BR, P, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  if (err != cudaSuccess) return err;
  cluster_report<L::NS>(kernel, L::T, out[2], L::SPLITS, out);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, L::T, out[2]);
}

// Step body VAR of energy E at (D, K) and precision P, run or stream (emit):
// MJHMC and NUTS without a mass and with the leapfrog take their fast-path
// instances (BR=false; NUTS takes no other integrator), the rest the BR=true
// ones; NUTS trees past nuts::kTileDepth its DEEP ones. Only VAR's kernels
// are instantiated.
template <int E, int D, int K, int P, int VAR>
cudaError_t launch_body_at(const Args& a, bool emit, cudaStream_t s) {
  const bool fast = !a.mass && !a.two_stage;
  if constexpr (VAR == kNuts) {
    if (a.m > nuts::kTileDepth)
      return emit ? launch_nuts<E, D, K, P, true, true, false, true>(a, s)
                  : launch_nuts<E, D, K, P, false, true, false, true>(a, s);
    if (fast)
      return emit ? launch_nuts<E, D, K, P, true, false>(a, s)
                  : launch_nuts<E, D, K, P, false, false>(a, s);
    return emit ? launch_nuts<E, D, K, P, true, true>(a, s)
                : launch_nuts<E, D, K, P, false, true>(a, s);
  } else {
    if constexpr (VAR == kMjhmc) {
      if (fast)
        return emit ? launch<E, D, K, VAR, true, false, false, P>(a, s)
                    : launch<E, D, K, VAR, false, false, false, P>(a, s);
    }
    return emit ? launch<E, D, K, VAR, true, false, true, P>(a, s)
                : launch<E, D, K, VAR, false, false, true, P>(a, s);
  }
}
// ... at the preset's shape (the library's)
template <int E, int P, int VAR>
cudaError_t launch_body(const Args& a, bool emit, cudaStream_t s) {
  return launch_body_at<E, Shape<E>::D, Shape<E>::K, P, VAR>(a, emit, s);
}

// The tiles of body VAR's runs at (D, K) and precision P: br picks the
// instance with the branches (control and MALT have no other); and the PROF
// instance of its run at the preset's shape (MJHMC's without the branches),
// the phases of every iteration into a.prof; nothing on the main path runs
// it
template <int E, int D, int K, int P, int VAR>
cudaError_t mm_tile_at(bool br, int* out) {
  if (br) return tile_of<E, D, K, VAR, true, P>(out);
  if constexpr (VAR == kMjhmc) return tile_of<E, D, K, VAR, false, P>(out);
  return cudaErrorInvalidValue;
}
template <int E, int P, int VAR>
cudaError_t mm_tile(bool br, int* out) {
  return mm_tile_at<E, Shape<E>::D, Shape<E>::K, P, VAR>(br, out);
}
template <int E, int P, int VAR>
cudaError_t launch_mm_prof(const Args& a, cudaStream_t s) {
  if (VAR == kMjhmc && (a.mass || a.two_stage)) return cudaErrorInvalidValue;
  return launch<E, Shape<E>::D, Shape<E>::K, VAR, false, false, VAR != kMjhmc, P, true>(a, s);
}

// The NUTS run of energy E at precision P without a mass: its PROF
// instance at the preset's shape (the per-leaf phase breakdown into a.prof;
// nothing on the main path runs it), and its tile at (D, K): chains and
// threads a block, shared-memory bytes at max_depth, and the blocks an SM
// holds at once (the card's occupancy query, which counts registers too);
// then, as tile_of's out[4..6], the device buffer it indexes: floats of a
// block's slice, the parameter matrix's floats, and the tree state's floats
// a chain where it is off chip; out[7] a block's span slots there. Past
// kTileDepth it is the DEEP instance's tile, as those launches run: the
// layout at kTileDepth, the tree rows past it where the rest are on chip,
// and the span slots past it (0 up to kTileDepth); out[8..13]
// cluster_report's
template <int E, int P>
cudaError_t launch_nuts_prof(const Args& a, cudaStream_t s) {
  return launch_nuts<E, Shape<E>::D, Shape<E>::K, P, false, false, true>(a, s);
}
template <int E, int D, int K, int P>
cudaError_t nuts_tile_at(int max_depth, int* out) {
  using L = NutsLayout<E, D, K, P>;
  const bool deep = max_depth > nuts::kTileDepth;
  out[0] = L::NC;
  out[1] = L::T;
  out[2] = L::floats(deep ? nuts::kTileDepth : max_depth) * (int)sizeof(float);
  out[4] = L::SLICE;
  out[5] = L::TL::OFF ? Params<D, K, P>::kFloats : 0;
  out[6] = (L::TL::ONCHIP ? nuts::deep_rows(max_depth) : nuts::rows(max_depth)) * L::DP;
  out[7] = nuts::deep_rows(max_depth) * L::T;
  void (*kernel)(Args) = deep ? nuts_mm_kernel<E, D, K, false, true, P, false, true>
                              : nuts_mm_kernel<E, D, K, false, false, P, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  if (err != cudaSuccess) return err;
  cluster_report<L::NS>(kernel, L::T, out[2], L::SPLITS, out);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, L::T, out[2]);
}
template <int E, int P>
cudaError_t nuts_tile(int max_depth, int* out) {
  return nuts_tile_at<E, Shape<E>::D, Shape<E>::K, P>(max_depth, out);
}
// The precision sweep's instances: the MJHMC leapfrog run without a mass
// of energy E at the preset's shape and precision P (anything else is
// refused)
template <int E, int P>
cudaError_t launch_sweep(const Args& a, bool emit, cudaStream_t s) {
  if (emit || a.mass || a.two_stage) return cudaErrorInvalidValue;
  return launch<E, Shape<E>::D, Shape<E>::K, kMjhmc, false, false, false, P>(a, s);
}
template <int E, int P>
cudaError_t sweep_tile(bool br, int* out) {
  return br ? cudaErrorInvalidValue : tile_of<E, Shape<E>::D, Shape<E>::K, kMjhmc, false, P>(out);
}

using Launch = cudaError_t(const Args&, bool, cudaStream_t);
using Tile = cudaError_t(bool, int*);
using ProfLaunch = cudaError_t(const Args&, cudaStream_t);

// A compiled run: its launch and its tile query (NUTS has none here; its
// tile depends on the depth, nuts_tile); both null where no such instance
// is compiled
struct Instance {
  Launch* launch = nullptr;
  Tile* tile = nullptr;
};
// step body VAR of energy E at precision P
template <int E, int P, int VAR>
Instance body_instance() {
  if constexpr (VAR == kNuts)
    return {launch_body<E, P, VAR>, nullptr};
  else
    return {launch_body<E, P, VAR>, mm_tile<E, P, VAR>};
}
// the precision sweep's MJHMC run of energy E at precision P
template <int E, int P>
Instance sweep_instance() {
  return {launch_sweep<E, P>, sweep_tile<E, P>};
}

// The library's instances, at the presets' shapes, each compiled in the
// source named beside it (an instance declared here and compiled nowhere
// fails the build's link): every body at kHighest and at the JAX preset's
// default precision (ProductOfTSpec and LogregSpec "default",
// SparseCodingSpec "bf16x3"), and the sweep's other two precisions of
// product of t and sparse coding (cuda_mjhmc.MM_KERNEL_PRECISIONS), and the
// PROF instances
// mjhmc_mm_engine.cu
extern template Instance body_instance<kProductOfT, kHighest, kMjhmc>();
extern template Instance body_instance<kProductOfT, kHighest, kControl>();
extern template Instance body_instance<kProductOfT, kHighest, kMalt>();
// mm_nuts_product_of_t.cu
extern template Instance body_instance<kProductOfT, kHighest, kNuts>();
extern template cudaError_t nuts_tile<kProductOfT, kHighest>(int, int*);
// mm_engine_sparse_coding.cu
extern template Instance body_instance<kSparseCoding, kHighest, kMjhmc>();
extern template Instance body_instance<kSparseCoding, kHighest, kControl>();
extern template Instance body_instance<kSparseCoding, kHighest, kMalt>();
// mm_nuts_sparse_coding.cu
extern template Instance body_instance<kSparseCoding, kHighest, kNuts>();
extern template cudaError_t nuts_tile<kSparseCoding, kHighest>(int, int*);
// mm_engine_logreg.cu
extern template Instance body_instance<kLogreg, kHighest, kMjhmc>();
extern template Instance body_instance<kLogreg, kHighest, kControl>();
extern template Instance body_instance<kLogreg, kHighest, kMalt>();
// mm_nuts_logreg.cu
extern template Instance body_instance<kLogreg, kHighest, kNuts>();
extern template cudaError_t nuts_tile<kLogreg, kHighest>(int, int*);
// mm_engine_product_of_t_default.cu
extern template Instance body_instance<kProductOfT, kDefault, kMjhmc>();
extern template Instance body_instance<kProductOfT, kDefault, kControl>();
extern template Instance body_instance<kProductOfT, kDefault, kMalt>();
// mm_nuts_product_of_t_default.cu
extern template Instance body_instance<kProductOfT, kDefault, kNuts>();
extern template ProfLaunch launch_nuts_prof<kProductOfT, kDefault>;
extern template cudaError_t nuts_tile<kProductOfT, kDefault>(int, int*);
// mm_engine_sparse_coding_bf16x3.cu
extern template Instance body_instance<kSparseCoding, kBf16x3, kMjhmc>();
extern template Instance body_instance<kSparseCoding, kBf16x3, kControl>();
extern template Instance body_instance<kSparseCoding, kBf16x3, kMalt>();
extern template ProfLaunch launch_mm_prof<kSparseCoding, kBf16x3, kMjhmc>;
extern template ProfLaunch launch_mm_prof<kSparseCoding, kBf16x3, kMalt>;
// mm_nuts_sparse_coding_bf16x3.cu
extern template Instance body_instance<kSparseCoding, kBf16x3, kNuts>();
extern template ProfLaunch launch_nuts_prof<kSparseCoding, kBf16x3>;
extern template cudaError_t nuts_tile<kSparseCoding, kBf16x3>(int, int*);
// mm_engine_logreg_default.cu
extern template Instance body_instance<kLogreg, kDefault, kMjhmc>();
extern template Instance body_instance<kLogreg, kDefault, kControl>();
extern template Instance body_instance<kLogreg, kDefault, kMalt>();
extern template ProfLaunch launch_mm_prof<kLogreg, kDefault, kMalt>;
// mm_nuts_logreg_default.cu
extern template Instance body_instance<kLogreg, kDefault, kNuts>();
extern template ProfLaunch launch_nuts_prof<kLogreg, kDefault>;
extern template cudaError_t nuts_tile<kLogreg, kDefault>(int, int*);
// mm_sweep.cu
extern template Instance sweep_instance<kProductOfT, kBf16x3>();
extern template Instance sweep_instance<kProductOfT, kBf16x2>();
extern template Instance sweep_instance<kSparseCoding, kBf16x2>();
extern template Instance sweep_instance<kSparseCoding, kDefault>();

}  // namespace mm
}  // namespace mjhmc
