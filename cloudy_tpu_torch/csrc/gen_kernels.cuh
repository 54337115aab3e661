// Shells of the kernels generated per configuration (ops/codegen.py): the
// whole SSPRK33 step (B1, replaces pallas_coalescence.py:876
// make_pallas_rainshaft_step_fn; with the per-lane kernel scale, B1s, its
// `fn_scaled`, pallas_coalescence.py:1022), the fused per-level RHS (B4, replaces
// pallas_coalescence.py:771 make_pallas_rainshaft_rhs_fn), at either tier
// (`C::kRef`: the reference tier's quadrature-grid F2, series/CF incomplete
// gamma, Newton inverse, Lanczos flux and monodisperse modes, its switches
// constants of the configuration), and the coalescence RHS on normalized
// moments (B3, replaces pallas_coalescence.py:662 make_pallas_coal_fn) at
// the fast tier.
//
// A generated unit defines one compiled-in configuration `Cfg`
// (coal_body.cuh: static constexpr members, the straight-line Q/R/S
// contraction), a `__global__` kernel with its launch bounds that calls
// gen_step_body<Cfg>, gen_rhs_body<Cfg> or gen_coal_body<Cfg>, and then
// CLOUDY_GEN_ENTRY, the
// plain C interface ops/codegen.py binds with ctypes. What bounds the
// kernels and what the design does about it: see rainshaft_lanes.cuh and
// ops/codegen.py; in short, the table-driven body's local memory, its
// configuration copy and, where a column fits a warp segment, the whole
// step's shared memory and barriers are gone.
//
// No fast-math: expf/logf/division stay IEEE-accurate and denormals are kept.

#pragma once

#include <type_traits>

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

// Whether a generated configuration carries the per-lane kernel scale (B1s):
// its `kScale`, which ops/codegen.py emits for scaled units only, so that an
// unscaled unit's text and code are those it had before the scale existed.
template <class C, class = void> struct Scaled : std::false_type {};
template <class C>
struct Scaled<C, std::void_t<decltype(C::kScale)>>
    : std::integral_constant<bool, C::kScale> {};

// One thread per lane (one level of one column); blocks of C::kThreads.
// Where C::kShfl (nz a power of two <= 32, so C::kThreads is a multiple of
// nz and a warp holds whole columns) the z-stencil is a warp shuffle;
// otherwise blocks hold C::kThreads / nz whole columns and the flux row goes
// through dynamic shared memory (C::n_tot rows of C::kThreads). The three
// RHS evaluations run as a loop over one inlined copy of the body
// (step_lane's kLoop): measured faster than three copies on every pod
// variant (PERF.md §6). A scaled configuration (`Scaled`) multiplies each
// lane's coalescence tendency by its entry of the [B] row `scale` in every
// RHS evaluation (step_rhs); a padding lane reads nothing (its state is zero
// and its result dropped).
template <class C>
__device__ __forceinline__ void gen_step_body(const typename C::real* __restrict__ mom,
                                              typename C::real* __restrict__ out,
                                              long long B,
                                              const typename C::real* __restrict__ scale =
                                                  nullptr) {
  using T = typename C::real;
  constexpr bool kScale = Scaled<C>::value;
  const C c{};
  const long long lane = (long long)blockIdx.x * C::kThreads + threadIdx.x;
  const bool active = lane < B;
  const bool top = (threadIdx.x % C::nz) == (C::nz - 1);
  const T s = (kScale && active) ? scale[lane] : T(1);
  if constexpr (C::kShfl) {
    const ShflStencil<C::nz> st{};
    step_lane<C::kArms, kScale, C::kRef, true>(c, st, mom, out, B, lane, active,
                                              top, s);
  } else {
    extern __shared__ __align__(16) unsigned char gen_smem[];
    const SmemStencil<T> st{reinterpret_cast<T*>(gen_smem), (int)threadIdx.x,
                            C::kThreads};
    step_lane<C::kArms, kScale, C::kRef, true>(c, st, mom, out, B, lane, active,
                                              top, s);
  }
}

template <class C>
__device__ __forceinline__ void gen_rhs_body(const typename C::real* __restrict__ mom,
                                             typename C::real* __restrict__ out,
                                             long long B) {
  const C c{};
  const long long lane = (long long)blockIdx.x * C::kThreads + threadIdx.x;
  if (lane >= B) return;  // no barrier follows
  rhs_lane<C::kArms, C::kRef>(c, mom, out, B, lane);
}

// The coalescence RHS: one thread per box, no flux and no stencil.
template <class C>
__device__ __forceinline__ void gen_coal_body(const typename C::real* __restrict__ mom,
                                              typename C::real* __restrict__ out,
                                              long long B) {
  const C c{};
  const long long lane = (long long)blockIdx.x * C::kThreads + threadIdx.x;
  if (lane >= B) return;  // no barrier follows
  coal_lane<C::kArms, false>(c, mom, out, B, lane);
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
//   cloudy_gen_launch(mom, out, B, scale, stream): one launch on [n_tot, B]
//     into [n_tot, B] (step, coal) or [2 n_tot, B] (rhs); B % nz == 0 for
//     the step (nz = 1 for the others); `scale` the [B] row of a scaled
//     step (refused if null), ignored by every other kernel;
//     returns the launch's cudaError_t;
//   cloudy_gen_blocks_per_sm(out): resident blocks per SM
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's block
//     size and shared memory);
//   cloudy_gen_info(out): kind (0 step, 1 rhs, 2 coal), n_tot, nz, sizeof(T),
//     threads per block, shuffle stencil, scaled; returns the count;
//   cloudy_gen_error_string(err).
// A unit ends with CLOUDY_GEN_ENTRY(CFG, KERNEL), a scaled step unit with
// CLOUDY_GEN_SCALED_ENTRY: the kernel takes the scale row as its last
// argument.
#define CLOUDY_GEN_ENTRY_WITH(CFG, KERNEL, ...)                                \
  extern "C" {                                                                 \
  int cloudy_gen_launch(const void* mom, void* out, long long B,               \
                        const void* scale, void* stream) {                     \
    using T = typename CFG::real;                                              \
    if (B <= 0 || B % CFG::nz != 0) return (int)cudaErrorInvalidValue;         \
    if (cloudy::Scaled<CFG>::value && scale == nullptr)                        \
      return (int)cudaErrorInvalidValue;                                       \
    constexpr size_t smem = cloudy::gen_smem_bytes<CFG>();                     \
    const cudaError_t e = cloudy::allow_smem(KERNEL, smem);                    \
    if (e != cudaSuccess) return (int)e;                                       \
    const long long blocks = (B + CFG::kThreads - 1) / CFG::kThreads;          \
    KERNEL<<<(unsigned)blocks, CFG::kThreads, smem, (cudaStream_t)stream>>>(   \
        __VA_ARGS__);                                                          \
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
                     (int)CFG::kShfl, (int)cloudy::Scaled<CFG>::value};        \
    for (int i = 0; i < 7; ++i) out[i] = v[i];                                 \
    return 7;                                                                  \
  }                                                                            \
  const char* cloudy_gen_error_string(int err) {                               \
    return cudaGetErrorString((cudaError_t)err);                               \
  }                                                                            \
  }
#define CLOUDY_GEN_ENTRY(CFG, KERNEL) \
  CLOUDY_GEN_ENTRY_WITH(CFG, KERNEL, (const T*)mom, (T*)out, B)
#define CLOUDY_GEN_SCALED_ENTRY(CFG, KERNEL) \
  CLOUDY_GEN_ENTRY_WITH(CFG, KERNEL, (const T*)mom, (T*)out, B, (const T*)scale)
