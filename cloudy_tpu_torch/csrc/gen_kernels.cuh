// Shells of the kernels generated per configuration (ops/codegen.py): the
// whole SSPRK33 step (B1, replaces pallas_coalescence.py:876
// make_pallas_rainshaft_step_fn) and the fused per-level RHS (B4, replaces
// pallas_coalescence.py:771 make_pallas_rainshaft_rhs_fn) at the fast tier.
//
// A generated unit defines one compiled-in configuration `Cfg`
// (coal_body.cuh: static constexpr members, the straight-line Q/R/S
// contraction), a `__global__` kernel with its launch bounds that calls
// gen_step_body<Cfg> or gen_rhs_body<Cfg>, and then CLOUDY_GEN_ENTRY, the
// plain C interface ops/codegen.py binds with ctypes. What bounds the
// kernels and what the design does about it: see rainshaft_lanes.cuh and
// ops/codegen.py; in short, the table-driven body's local memory, its
// configuration copy and, where a column fits a warp segment, the whole
// step's shared memory and barriers are gone.
//
// No fast-math: expf/logf/division stay IEEE-accurate and denormals are kept.

#pragma once

#include "rainshaft_lanes.cuh"

// The generated kernels' launch bounds: the block size alone, which leaves
// the register count to ptxas's own target (the leanest code measured), or,
// where ptxas spilled under that target, with a minimum of one resident
// block per SM, which lifts it (ops/_build.py rebuilds such a unit with
// -DCLOUDY_GEN_MIN_BLOCKS=1).
#ifdef CLOUDY_GEN_MIN_BLOCKS
#define CLOUDY_GEN_BOUNDS(threads) __launch_bounds__(threads, CLOUDY_GEN_MIN_BLOCKS)
#else
#define CLOUDY_GEN_BOUNDS(threads) __launch_bounds__(threads)
#endif

namespace cloudy {

// One thread per lane (one level of one column); blocks of C::kThreads.
// Where C::kShfl (nz a power of two <= 32, so C::kThreads is a multiple of
// nz and a warp holds whole columns) the z-stencil is a warp shuffle;
// otherwise blocks hold C::kThreads / nz whole columns and the flux row goes
// through dynamic shared memory (C::n_tot rows of C::kThreads). The three
// RHS evaluations run as a loop over one inlined copy of the body
// (step_lane's kLoop): measured faster than three copies on every pod
// variant (PERF.md §6).
template <class C>
__device__ __forceinline__ void gen_step_body(const typename C::real* __restrict__ mom,
                                              typename C::real* __restrict__ out,
                                              long long B) {
  using T = typename C::real;
  const C c{};
  const long long lane = (long long)blockIdx.x * C::kThreads + threadIdx.x;
  const bool active = lane < B;
  const bool top = (threadIdx.x % C::nz) == (C::nz - 1);
  if constexpr (C::kShfl) {
    const ShflStencil<C::nz> st{};
    step_lane<C::kArms, false, false, true>(c, st, mom, out, B, lane, active,
                                           top, T(1));
  } else {
    extern __shared__ __align__(16) unsigned char gen_smem[];
    const SmemStencil<T> st{reinterpret_cast<T*>(gen_smem), (int)threadIdx.x,
                            C::kThreads};
    step_lane<C::kArms, false, false, true>(c, st, mom, out, B, lane, active,
                                           top, T(1));
  }
}

template <class C>
__device__ __forceinline__ void gen_rhs_body(const typename C::real* __restrict__ mom,
                                             typename C::real* __restrict__ out,
                                             long long B) {
  const C c{};
  const long long lane = (long long)blockIdx.x * C::kThreads + threadIdx.x;
  if (lane >= B) return;  // no barrier follows
  rhs_lane<C::kArms, false>(c, mom, out, B, lane);
}

// Dynamic shared memory of a generated kernel: the flux row of the
// shared-memory stencil, none otherwise.
template <class C> constexpr size_t gen_smem_bytes() {
  return (C::kKind == 0 && !C::kShfl)
             ? (size_t)C::n_tot * C::kThreads * sizeof(typename C::real)
             : 0;
}

}  // namespace cloudy

// The unit's C interface:
//   cloudy_gen_launch(mom, out, B, stream): one launch on [n_tot, B] into
//     [n_tot, B] (step) or [2 n_tot, B] (rhs); B % nz == 0 for the step;
//     returns the launch's cudaError_t;
//   cloudy_gen_blocks_per_sm(out): resident blocks per SM
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's block
//     size and shared memory);
//   cloudy_gen_info(out): kind (0 step, 1 rhs), n_tot, nz, sizeof(T),
//     threads per block, shuffle stencil; returns the count;
//   cloudy_gen_error_string(err).
#define CLOUDY_GEN_ENTRY(CFG, KERNEL)                                          \
  extern "C" {                                                                 \
  int cloudy_gen_launch(const void* mom, void* out, long long B,               \
                        void* stream) {                                        \
    using T = typename CFG::real;                                              \
    if (B <= 0 || B % CFG::nz != 0) return (int)cudaErrorInvalidValue;         \
    constexpr size_t smem = cloudy::gen_smem_bytes<CFG>();                     \
    const cudaError_t e = cloudy::allow_smem(KERNEL, smem);                    \
    if (e != cudaSuccess) return (int)e;                                       \
    const long long blocks = (B + CFG::kThreads - 1) / CFG::kThreads;          \
    KERNEL<<<(unsigned)blocks, CFG::kThreads, smem, (cudaStream_t)stream>>>(   \
        (const T*)mom, (T*)out, B);                                            \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  int cloudy_gen_blocks_per_sm(int* out) {                                     \
    constexpr size_t smem = cloudy::gen_smem_bytes<CFG>();                     \
    const cudaError_t e = cloudy::allow_smem(KERNEL, smem);                    \
    if (e != cudaSuccess) return (int)e;                                       \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
        out, KERNEL, CFG::kThreads, smem);                                     \
  }                                                                            \
  int cloudy_gen_info(int* out) {                                              \
    const int v[] = {CFG::kKind, CFG::n_tot, CFG::nz,                          \
                     (int)sizeof(typename CFG::real), CFG::kThreads,           \
                     (int)CFG::kShfl};                                         \
    for (int i = 0; i < 6; ++i) out[i] = v[i];                                 \
    return 6;                                                                  \
  }                                                                            \
  const char* cloudy_gen_error_string(int err) {                               \
    return cudaGetErrorString((cudaError_t)err);                               \
  }                                                                            \
  }
