// Fused coalescence kernels for Hopper (sm_90a), bound to PyTorch by ctypes
// (ops/_build.py builds this file, ops/fused_coalescence.py launches it).
//
// Replaces three Pallas TPU kernels of cloudy_tpu/ops/pallas_coalescence.py:
//
// - cloudy_coal_*  <- make_pallas_coal_fn (:662): normalized moments
//   [n_tot, B] -> coalescence tendencies [n_tot, B] (the RHS bench.py
//   measures); cloudy_coal_warp_* the same at the reference tier with a
//   warp per box;
// - cloudy_rhs_*   <- make_pallas_rainshaft_rhs_fn (:771): the fused
//   per-level rainshaft RHS, physical moments [n_tot, B] -> [2 n_tot, B],
//   the physical coalescence tendencies (clip, normalize, empty-cell mask,
//   denormalize) over the physical sedimentation fluxes; the caller applies
//   the upwind stencil;
// - cloudy_step_*  <- make_pallas_rainshaft_step_fn (:876): one whole
//   SSPRK33 rainshaft step, three RHS evaluations (clip, normalize,
//   empty-cell mask, coalescence body, sedimentation flux, denormalize,
//   upwind stencil) and the RK combinations, state in and out;
// - cloudy_step_scaled_* <- the same function with kernel_scale=True
//   (`fn_scaled`, :1022-1059): every RHS evaluation multiplies the lane's
//   coalescence tendency by scale[lane] after the empty mask and the
//   denormalisation and before the flux divergence (:994-1001); the flux is
//   never scaled. The scale is a template flag (`kScale`), so the unscaled
//   instances carry none of it; the scaled ones are built in units of their
//   own. A null-or-row pointer tested once per row and RHS evaluation in
//   one binary cost the unscaled `fixed2gamma` step two registers and 1.4 %
//   at 2^25 lanes on an H100 80GB HBM3 at 700 W (3.3007 s per 120 steps in
//   both its runs against 3.2552 and 3.2598 s without the test, alternated
//   on one card; PERF.md).
//
// What bounds them on this card: transcendental and FP32/FP64 issue, not
// bytes (cloudy_rhs_* writes twice the rows it reads, 72 B per lane in f32,
// still far below its arithmetic). Per lane and step the whole-step kernel
// reads 6 and writes 6 values
// (48 B + 48 B in f32) but evaluates three RHS of ~20 exp/log, ~15 divides
// and a few hundred FMAs each, so it sits far to the compute side of the
// H100's bytes-to-FLOP balance; the f64 variant runs at the card's FP64 rate.
//
// What the design does about it: one thread per SoA lane (one level of one
// column); every intermediate stays in the thread (registers, or L1-resident
// local memory where a table index is only known at run time); the state
// crosses device memory once per step. The configuration tables live in
// shared memory, read as broadcasts. The z-coupling of the whole step (level
// i needs the flux of level i+1) goes through shared memory inside a block
// that holds whole columns: blocks of cols_per_block * nz threads, the flux
// row written to shared memory, one __syncthreads(), the neighbour read,
// zero influx at each column's top (rainshaft_lanes.cuh, SmemStencil).
//
// The fast tier of the whole step, the fused RHS and the coalescence RHS
// runs kernels generated per configuration instead (ops/codegen.py,
// gen_kernels.cuh: every table compiled in, no local memory, the z-stencil
// a warp shuffle where a column fits a warp segment). Their table-driven
// fast instances here stay built as the same-call yardstick only (the
// wrappers' private `_table`); the scaled whole step and the reference tier
// run here, the reference coalescence RHS at small batches with a warp per
// box (coal_warp_kernel).
// Each kernel has three instances: `kArms = false` for FixedThreshold
// gamma/exponential configurations at the fast tier, `kArms = true` with the
// MovingThreshold and lognormal arms (coal_body.cuh), and the reference tier
// (`kArms = kRef = true`: quadrature-grid F2, gamma/exponential or
// lognormal, series/CF incomplete gamma, Newton percentile inverse,
// Lanczos-pair flux, monodisperse modes) built in units of its own;
// the entry points' `arms` argument (0, 1, 2: `FusedPlan.instance`) picks
// one. The scaled whole step has the two fast instances only.

#include "rainshaft_lanes.cuh"

// Build units: ops/_build.py compiles this file once per unit, all at once,
// with -DCLOUDY_UNIT=u, and links the objects; each unit instantiates one
// kernel (the whole step: scaled or not; units 8-13: the reference tier;
// 14-15: the reference coalescence RHS with a warp per box) in
// one type. Without CLOUDY_UNIT the file builds everything.
//
// The reference whole step (units 12, 13) is compiled without FMA
// contraction: every product and sum is rounded on its own, as the plain
// twin's torch ops round them, so that the step rounds as its twin does
// wherever its arithmetic has no reduction order of its own (the
// monodisperse closed form, exact F2: bit for bit on the card). A trajectory
// whose rounding noise grows by orders of magnitude per step (monodisperse +
// gamma from an empty second mode, PERF.md) can then be held against the
// twin over many steps. Every other unit keeps nvcc's contraction.
// CLOUDY_NO_FMA_UNITS: 12 13
#ifdef CLOUDY_UNIT
#define CLOUDY_IN_UNIT(u) (CLOUDY_UNIT == (u))
#else
#define CLOUDY_IN_UNIT(u) 1
#endif

namespace cloudy {

constexpr int COAL_THREADS = 256;
// 4 boxes per block: at the smallest batches (128 boxes: a rainshaft_128
// column) the boxes spread over 32 SMs, one warp per SM sub-partition
constexpr int COAL_WARP_THREADS = 128;
constexpr int STEP_TARGET_THREADS = 256;

template <typename T, bool kArms, bool kRef>
__global__ void coal_kernel(const T* __restrict__ mom, T* __restrict__ out,
                            const unsigned char* __restrict__ cfg_g,
                            int cfg_bytes, long long B) {
  extern __shared__ __align__(16) unsigned char smem[];
  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  Config<T> c;
  c.bind(smem);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;  // no barrier follows
  coal_lane<kArms, kRef>(c, mom, out, B, lane);
}

// The reference-tier coalescence RHS with a warp per box (the layout the
// host picks at small batches: `fused_coalescence.coal_layout`). Below one
// full wave of the thread-per-box instance (33,792 boxes in f64, 67,584 in
// f32 on an H100) a launch takes one lane's serial walk over its quadrature
// grid whatever the batch (~76 Simpson nodes per mode, each a series/CF
// incomplete gamma of up to 128 iterations). Here the 32
// lanes of a warp run the body on one box together: the closure, the
// thresholds and the contraction once per lane (the same values in every
// lane), the grid F2's node loops strided across the lanes (`WarpSplit`,
// coal_body.cuh) and their partial sums added by a fixed shuffle tree, so
// two launches agree bit for bit; lane 0 writes the box.
template <typename T>
__global__ void __launch_bounds__(COAL_WARP_THREADS)
    coal_warp_kernel(const T* __restrict__ mom, T* __restrict__ out,
                     const unsigned char* __restrict__ cfg_g, int cfg_bytes,
                     long long B) {
  extern __shared__ __align__(16) unsigned char smem[];
  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  Config<T> c;
  c.bind(smem);
  const long long box = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const WarpSplit sp{(int)(threadIdx.x & 31)};
  if (box >= B) return;  // a whole warp: no barrier or shuffle follows for it

  T m[MAX_NTOT], acc[MAX_NTOT], params[MAX_MODES][3];
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot) m[o] = mom[o * B + box];  // one address per warp
  coal_body<true, true>(c, m, acc, params, sp);
  if (sp.lane == 0) {
#pragma unroll
    for (int o = 0; o < MAX_NTOT; ++o)
      if (o < c.n_tot) out[o * B + box] = acc[o];
  }
}

// The fused per-level RHS: one thread per lane, no stencil and no barrier
// after the configuration copy.
template <typename T, bool kArms, bool kRef>
__global__ void rhs_kernel(const T* __restrict__ mom, T* __restrict__ out,
                           const unsigned char* __restrict__ cfg_g,
                           int cfg_bytes, long long B) {
  extern __shared__ __align__(16) unsigned char smem[];
  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  Config<T> c;
  c.bind(smem);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;  // no barrier follows
  rhs_lane<kArms, kRef>(c, mom, out, B, lane);
}

template <typename T, bool kArms, bool kScale, bool kRef>
__global__ void step_kernel(const T* __restrict__ mom, T* __restrict__ out,
                            const unsigned char* __restrict__ cfg_g,
                            int cfg_bytes, long long B, int nz,
                            const T* __restrict__ scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  Config<T> c;
  c.bind(smem);
  const SmemStencil<T> st{reinterpret_cast<T*>(smem + cfg_bytes),
                          (int)threadIdx.x, (int)blockDim.x};

  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // B % nz == 0 and blockDim.x % nz == 0: lanes past B are whole columns of
  // zeros that keep the barriers uniform and whose results are dropped
  const bool active = lane < B;
  const bool top = (threadIdx.x % nz) == (nz - 1);
  // the kernel_scale row; a padding lane reads nothing (its state is zero
  // and its result dropped)
  const T s = (kScale && active) ? scale[lane] : T(1);
  step_lane<kArms, kScale, kRef, false>(c, st, mom, out, B, lane, active, top, s);
}


// One instance's launch (kernel sizes and the configuration check).
template <typename T, bool kArms, bool kRef>
int launch_coal_inst(const void* mom, void* out, const void* cfg, int cfg_bytes,
                     long long B, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + COAL_THREADS - 1) / COAL_THREADS;
  coal_kernel<T, kArms, kRef>
      <<<(unsigned)blocks, COAL_THREADS, cfg_bytes, (cudaStream_t)stream>>>(
          (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B);
  return (int)cudaGetLastError();
}

template <typename T, bool kArms, bool kRef>
int launch_rhs_inst(const void* mom, void* out, const void* cfg, int cfg_bytes,
                    long long B, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + COAL_THREADS - 1) / COAL_THREADS;
  rhs_kernel<T, kArms, kRef>
      <<<(unsigned)blocks, COAL_THREADS, cfg_bytes, (cudaStream_t)stream>>>(
          (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B);
  return (int)cudaGetLastError();
}

// The block size and dynamic shared memory of a table-driven whole step:
// blocks of whole columns near STEP_TARGET_THREADS, the configuration and
// then the flux row in shared memory. One definition for its launch and its
// occupancy query.
struct LaunchDims {
  int threads;
  size_t smem;
};

template <typename T> LaunchDims step_dims(int cfg_bytes, int nz) {
  const int threads = (nz >= STEP_TARGET_THREADS ? 1 : STEP_TARGET_THREADS / nz) * nz;
  return {threads, (size_t)cfg_bytes + (size_t)MAX_NTOT * threads * sizeof(T)};
}

template <typename T, bool kArms, bool kScale, bool kRef>
int launch_step_inst(const void* mom, void* out, const void* cfg, int cfg_bytes,
                     long long B, int nz, const void* scale, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0 ||
      nz < 2 || nz > 1024 || B % nz != 0 || (kScale && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto kern = step_kernel<T, kArms, kScale, kRef>;
  const LaunchDims d = step_dims<T>(cfg_bytes, nz);
  const cudaError_t e = allow_smem(kern, d.smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (B + d.threads - 1) / d.threads;
  kern<<<(unsigned)blocks, d.threads, d.smem, (cudaStream_t)stream>>>(
      (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B, nz,
      (const T*)scale);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the fast instances of the whole step (unscaled),
// the fused RHS and the coalescence RHS at their launch's block size and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), defined in the units that
// instantiate them: `cfg_bytes` the packed configuration's size.
template <typename T, bool kArms>
int step_blocks_per_sm(int cfg_bytes, int nz, int* out) {
  if (nz < 2 || nz > 1024) return (int)cudaErrorInvalidValue;
  const auto kern = step_kernel<T, kArms, false, false>;
  const LaunchDims d = step_dims<T>(cfg_bytes, nz);
  const cudaError_t e = allow_smem(kern, d.smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, d.threads, d.smem);
}

template <typename T, bool kArms, bool kRef = false>
int coal_blocks_per_sm(int cfg_bytes, int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, coal_kernel<T, kArms, kRef>, COAL_THREADS, (size_t)cfg_bytes);
}

// Resident threads per SM of the reference tier's thread-per-box instance,
// defined in its units (8, 9): what the host's choice of layout reads
// (`fused_coalescence.coal_layout`).
template <typename T> int coal_ref_threads_per_sm(int cfg_bytes, int* out) {
  const int err = coal_blocks_per_sm<T, true, true>(cfg_bytes, out);
  *out *= COAL_THREADS;
  return err;
}

template <typename T, bool kArms>
int rhs_blocks_per_sm(int cfg_bytes, int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, rhs_kernel<T, kArms, false>, COAL_THREADS, (size_t)cfg_bytes);
}

// The reference-tier instances, defined in their own build units (8-13)
// and called from the entry points' units.
template <typename T>
int launch_coal_ref(const void* mom, void* out, const void* cfg, int cfg_bytes,
                    long long B, void* stream);
template <typename T>
int launch_rhs_ref(const void* mom, void* out, const void* cfg, int cfg_bytes,
                   long long B, void* stream);
template <typename T>
int launch_step_ref(const void* mom, void* out, const void* cfg, int cfg_bytes,
                    long long B, int nz, void* stream);

#if CLOUDY_IN_UNIT(8) || CLOUDY_IN_UNIT(9)
template <typename T>
int launch_coal_ref(const void* mom, void* out, const void* cfg, int cfg_bytes,
                    long long B, void* stream) {
  return launch_coal_inst<T, true, true>(mom, out, cfg, cfg_bytes, B, stream);
}
#endif
#if CLOUDY_IN_UNIT(10) || CLOUDY_IN_UNIT(11)
template <typename T>
int launch_rhs_ref(const void* mom, void* out, const void* cfg, int cfg_bytes,
                   long long B, void* stream) {
  return launch_rhs_inst<T, true, true>(mom, out, cfg, cfg_bytes, B, stream);
}
#endif
#if CLOUDY_IN_UNIT(12) || CLOUDY_IN_UNIT(13)
template <typename T>
int launch_step_ref(const void* mom, void* out, const void* cfg, int cfg_bytes,
                    long long B, int nz, void* stream) {
  return launch_step_inst<T, true, false, true>(mom, out, cfg, cfg_bytes, B, nz,
                                                nullptr, stream);
}
#endif
#if CLOUDY_IN_UNIT(8)
template int launch_coal_ref<float>(const void*, void*, const void*, int,
                                    long long, void*);
#endif
#if CLOUDY_IN_UNIT(9)
template int launch_coal_ref<double>(const void*, void*, const void*, int,
                                     long long, void*);
#endif
#if CLOUDY_IN_UNIT(10)
template int launch_rhs_ref<float>(const void*, void*, const void*, int,
                                   long long, void*);
#endif
#if CLOUDY_IN_UNIT(11)
template int launch_rhs_ref<double>(const void*, void*, const void*, int,
                                    long long, void*);
#endif
#if CLOUDY_IN_UNIT(12)
template int launch_step_ref<float>(const void*, void*, const void*, int,
                                    long long, int, void*);
#endif
#if CLOUDY_IN_UNIT(13)
template int launch_step_ref<double>(const void*, void*, const void*, int,
                                     long long, int, void*);
#endif

// The box-per-warp launch of the reference tier, in its own build units
// (14, 15).
template <typename T>
int launch_coal_warp(const void* mom, void* out, const void* cfg, int cfg_bytes,
                     long long B, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int boxes = COAL_WARP_THREADS / 32;
  const long long blocks = (B + boxes - 1) / boxes;
  coal_warp_kernel<T><<<(unsigned)blocks, COAL_WARP_THREADS, cfg_bytes,
                        (cudaStream_t)stream>>>((const T*)mom, (T*)out,
                                                (const unsigned char*)cfg,
                                                cfg_bytes, B);
  return (int)cudaGetLastError();
}

// `arms`: the instance (FusedPlan.instance): 0 fast tier, 1 fast tier with
// the arms, 2 reference tier
template <typename T>
int launch_coal(const void* mom, void* out, const void* cfg, int cfg_bytes,
                long long B, int arms, void* stream) {
  if (arms == 2) return launch_coal_ref<T>(mom, out, cfg, cfg_bytes, B, stream);
  return arms ? launch_coal_inst<T, true, false>(mom, out, cfg, cfg_bytes, B, stream)
              : launch_coal_inst<T, false, false>(mom, out, cfg, cfg_bytes, B, stream);
}

template <typename T>
int launch_rhs(const void* mom, void* out, const void* cfg, int cfg_bytes,
               long long B, int arms, void* stream) {
  if (arms == 2) return launch_rhs_ref<T>(mom, out, cfg, cfg_bytes, B, stream);
  return arms ? launch_rhs_inst<T, true, false>(mom, out, cfg, cfg_bytes, B, stream)
              : launch_rhs_inst<T, false, false>(mom, out, cfg, cfg_bytes, B, stream);
}

template <typename T, bool kScale>
int launch_step(const void* mom, void* out, const void* cfg, int cfg_bytes,
                long long B, int nz, int arms, const void* scale,
                void* stream) {
  if (arms == 2) {
    if (kScale) return (int)cudaErrorInvalidValue;  // no scaled reference tier
    return launch_step_ref<T>(mom, out, cfg, cfg_bytes, B, nz, stream);
  }
  return arms ? launch_step_inst<T, true, kScale, false>(mom, out, cfg, cfg_bytes,
                                                         B, nz, scale, stream)
              : launch_step_inst<T, false, kScale, false>(mom, out, cfg, cfg_bytes,
                                                          B, nz, scale, stream);
}

}  // namespace cloudy

extern "C" {

#if CLOUDY_IN_UNIT(0)
int cloudy_coal_f32(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, int arms, void* stream) {
  return cloudy::launch_coal<float>(mom, out, cfg, cfg_bytes, B, arms, stream);
}

// resident blocks per SM of the fast instance `arms` (0, 1)
int cloudy_coal_blocks_per_sm_f32(int cfg_bytes, int arms, int* out) {
  return arms ? cloudy::coal_blocks_per_sm<float, true>(cfg_bytes, out)
              : cloudy::coal_blocks_per_sm<float, false>(cfg_bytes, out);
}

// The packed configuration's capacities and header size, for the host to
// check against its own (ops/fused_coalescence.py, LAYOUT).
int cloudy_layout(int* out) {
  const int v[] = {cloudy::MAX_MODES, cloudy::MAX_NTOT, cloudy::MAX_M,
                   cloudy::CFG_MAX_BYTES, cloudy::I_FAM};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 5;
}

const char* cloudy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The multiprocessors of `device` (the host's choice of the
// reference-tier coalescence layout).
int cloudy_device_sms(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device);
}
#endif

#if CLOUDY_IN_UNIT(1)
int cloudy_coal_f64(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, int arms, void* stream) {
  return cloudy::launch_coal<double>(mom, out, cfg, cfg_bytes, B, arms, stream);
}

// resident blocks per SM of the fast instance `arms` (0, 1)
int cloudy_coal_blocks_per_sm_f64(int cfg_bytes, int arms, int* out) {
  return arms ? cloudy::coal_blocks_per_sm<double, true>(cfg_bytes, out)
              : cloudy::coal_blocks_per_sm<double, false>(cfg_bytes, out);
}
#endif

#if CLOUDY_IN_UNIT(2)
int cloudy_rhs_f32(const void* mom, void* out, const void* cfg,
                   int cfg_bytes, long long B, int arms, void* stream) {
  return cloudy::launch_rhs<float>(mom, out, cfg, cfg_bytes, B, arms, stream);
}

// resident blocks per SM of the fast instance `arms` (0, 1)
int cloudy_rhs_blocks_per_sm_f32(int cfg_bytes, int arms, int* out) {
  return arms ? cloudy::rhs_blocks_per_sm<float, true>(cfg_bytes, out)
              : cloudy::rhs_blocks_per_sm<float, false>(cfg_bytes, out);
}
#endif

#if CLOUDY_IN_UNIT(3)
int cloudy_rhs_f64(const void* mom, void* out, const void* cfg,
                   int cfg_bytes, long long B, int arms, void* stream) {
  return cloudy::launch_rhs<double>(mom, out, cfg, cfg_bytes, B, arms, stream);
}

// resident blocks per SM of the fast instance `arms` (0, 1)
int cloudy_rhs_blocks_per_sm_f64(int cfg_bytes, int arms, int* out) {
  return arms ? cloudy::rhs_blocks_per_sm<double, true>(cfg_bytes, out)
              : cloudy::rhs_blocks_per_sm<double, false>(cfg_bytes, out);
}
#endif

#if CLOUDY_IN_UNIT(4)
int cloudy_step_f32(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, int nz, int arms,
                    void* stream) {
  return cloudy::launch_step<float, false>(mom, out, cfg, cfg_bytes, B, nz,
                                           arms, nullptr, stream);
}

// resident blocks per SM of the unscaled fast instance `arms` (0, 1)
int cloudy_step_blocks_per_sm_f32(int cfg_bytes, int nz, int arms, int* out) {
  return arms ? cloudy::step_blocks_per_sm<float, true>(cfg_bytes, nz, out)
              : cloudy::step_blocks_per_sm<float, false>(cfg_bytes, nz, out);
}
#endif

#if CLOUDY_IN_UNIT(5)
int cloudy_step_f64(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, int nz, int arms,
                    void* stream) {
  return cloudy::launch_step<double, false>(mom, out, cfg, cfg_bytes, B, nz,
                                            arms, nullptr, stream);
}

// resident blocks per SM of the unscaled fast instance `arms` (0, 1)
int cloudy_step_blocks_per_sm_f64(int cfg_bytes, int nz, int arms, int* out) {
  return arms ? cloudy::step_blocks_per_sm<double, true>(cfg_bytes, nz, out)
              : cloudy::step_blocks_per_sm<double, false>(cfg_bytes, nz, out);
}
#endif

// `scale`: a [B] row of the state's type
#if CLOUDY_IN_UNIT(6)
int cloudy_step_scaled_f32(const void* mom, void* out, const void* cfg,
                           int cfg_bytes, long long B, int nz, int arms,
                           const void* scale, void* stream) {
  return cloudy::launch_step<float, true>(mom, out, cfg, cfg_bytes, B, nz,
                                          arms, scale, stream);
}
#endif

#if CLOUDY_IN_UNIT(7)
int cloudy_step_scaled_f64(const void* mom, void* out, const void* cfg,
                           int cfg_bytes, long long B, int nz, int arms,
                           const void* scale, void* stream) {
  return cloudy::launch_step<double, true>(mom, out, cfg, cfg_bytes, B, nz,
                                           arms, scale, stream);
}
#endif

#if CLOUDY_IN_UNIT(8)
int cloudy_coal_ref_threads_per_sm_f32(int cfg_bytes, int* out) {
  return cloudy::coal_ref_threads_per_sm<float>(cfg_bytes, out);
}
#endif

#if CLOUDY_IN_UNIT(9)
int cloudy_coal_ref_threads_per_sm_f64(int cfg_bytes, int* out) {
  return cloudy::coal_ref_threads_per_sm<double>(cfg_bytes, out);
}
#endif

// The reference tier of the coalescence RHS with a warp per box
#if CLOUDY_IN_UNIT(14)
int cloudy_coal_warp_f32(const void* mom, void* out, const void* cfg,
                         int cfg_bytes, long long B, void* stream) {
  return cloudy::launch_coal_warp<float>(mom, out, cfg, cfg_bytes, B, stream);
}
#endif

#if CLOUDY_IN_UNIT(15)
int cloudy_coal_warp_f64(const void* mom, void* out, const void* cfg,
                         int cfg_bytes, long long B, void* stream) {
  return cloudy::launch_coal_warp<double>(mom, out, cfg, cfg_bytes, B, stream);
}
#endif

}  // extern "C"
