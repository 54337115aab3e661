// Fused coalescence kernels for Hopper (sm_90a), bound to PyTorch by ctypes
// (ops/_build.py builds this file, ops/fused_coalescence.py launches it).
//
// Replaces two Pallas TPU kernels of cloudy_tpu/ops/pallas_coalescence.py:
//
// - cloudy_coal_*  <- make_pallas_coal_fn (:662): normalized moments
//   [n_tot, B] -> coalescence tendencies [n_tot, B] (the RHS bench.py
//   measures);
// - cloudy_step_*  <- make_pallas_rainshaft_step_fn (:876, without
//   kernel_scale): one whole SSPRK33 rainshaft step, three RHS evaluations
//   (clip, normalize, empty-cell mask, coalescence body, sedimentation flux,
//   denormalize, upwind stencil) and the RK combinations, state in and out.
//
// What bounds them on this card: transcendental and FP32/FP64 issue, not
// bytes. Per lane and step the whole-step kernel reads 6 and writes 6 values
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
// zero influx at each column's top. Loops over the tables are not unrolled
// per configuration: generating the kernel per configuration is later work.

#include "coal_body.cuh"

namespace cloudy {

template <typename T>
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

  T m[MAX_NTOT], acc[MAX_NTOT], params[MAX_MODES][3];
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot) m[o] = mom[o * B + lane];
  coal_body(c, m, acc, params);
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot) out[o * B + lane] = acc[o];
}

// One RHS evaluation of the whole step on this lane's state y -> rows.
// Every thread of the block calls it (the two barriers are block-wide).
template <typename T>
__device__ __forceinline__ void step_rhs(const Config<T>& c, const T* y,
                                         T* rows, T* sh_flux, bool top) {
  const T eps = Lim<T>::eps();
  T r[MAX_NTOT], acc[MAX_NTOT], flux[MAX_NTOT], params[MAX_MODES][3];
  bool empty = true;
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o) {
    if (o < c.n_tot) {
      r[o] = vmax(y[o], T(0)) * c.inv_norm[o];  // clip negatives, normalize
      empty = empty && (r[o] < eps);
    }
  }
  coal_body(c, r, acc, params);
  sedi_flux(c, params, flux);
  const int t = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o) {
    if (o < c.n_tot) {
      flux[o] = flux[o] * c.norm[o];
      sh_flux[o * nt + t] = flux[o];
    }
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o) {
    if (o < c.n_tot) {
      const T coal = (empty ? T(0) : acc[o]) * c.norm[o];
      const T f_up = top ? T(0) : sh_flux[o * nt + t + 1];
      rows[o] = coal - (f_up - flux[o]) * c.inv_dz;
    }
  }
  __syncthreads();  // sh_flux is rewritten by the next evaluation
}

template <typename T>
__global__ void step_kernel(const T* __restrict__ mom, T* __restrict__ out,
                            const unsigned char* __restrict__ cfg_g,
                            int cfg_bytes, long long B, int nz) {
  extern __shared__ __align__(16) unsigned char smem[];
  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  Config<T> c;
  c.bind(smem);
  T* sh_flux = reinterpret_cast<T*>(smem + cfg_bytes);

  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // B % nz == 0 and blockDim.x % nz == 0: lanes past B are whole columns of
  // zeros that keep the barriers uniform and whose results are dropped
  const bool active = lane < B;
  const bool top = (threadIdx.x % nz) == (nz - 1);
  const T dt = c.dt;

  T y[MAX_NTOT], u1[MAX_NTOT], u2[MAX_NTOT], f[MAX_NTOT];
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot) y[o] = active ? mom[o * B + lane] : T(0);

  step_rhs(c, y, f, sh_flux, top);
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot) u1[o] = y[o] + dt * f[o];
  step_rhs(c, u1, f, sh_flux, top);
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot) u2[o] = T(0.75) * y[o] + T(0.25) * (u1[o] + dt * f[o]);
  step_rhs(c, u2, f, sh_flux, top);
  if (!active) return;
#pragma unroll
  for (int o = 0; o < MAX_NTOT; ++o)
    if (o < c.n_tot)
      out[o * B + lane] = y[o] / T(3) + c.two_thirds * (u2[o] + dt * f[o]);
}

constexpr int COAL_THREADS = 256;
constexpr int STEP_TARGET_THREADS = 256;

template <typename T>
int launch_coal(const void* mom, void* out, const void* cfg, int cfg_bytes,
                long long B, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + COAL_THREADS - 1) / COAL_THREADS;
  coal_kernel<T><<<(unsigned)blocks, COAL_THREADS, cfg_bytes,
                   (cudaStream_t)stream>>>(
      (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_step(const void* mom, void* out, const void* cfg, int cfg_bytes,
                long long B, int nz, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0 ||
      nz < 2 || nz > 1024 || B % nz != 0)
    return (int)cudaErrorInvalidValue;
  const int cols = nz >= STEP_TARGET_THREADS ? 1 : STEP_TARGET_THREADS / nz;
  const int threads = cols * nz;
  const long long blocks = (B + threads - 1) / threads;
  const size_t smem = (size_t)cfg_bytes + (size_t)MAX_NTOT * threads * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  step_kernel<T><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B, nz);
  return (int)cudaGetLastError();
}

}  // namespace cloudy

extern "C" {

int cloudy_coal_f32(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, void* stream) {
  return cloudy::launch_coal<float>(mom, out, cfg, cfg_bytes, B, stream);
}

int cloudy_coal_f64(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, void* stream) {
  return cloudy::launch_coal<double>(mom, out, cfg, cfg_bytes, B, stream);
}

int cloudy_step_f32(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, int nz, void* stream) {
  return cloudy::launch_step<float>(mom, out, cfg, cfg_bytes, B, nz, stream);
}

int cloudy_step_f64(const void* mom, void* out, const void* cfg,
                    int cfg_bytes, long long B, int nz, void* stream) {
  return cloudy::launch_step<double>(mom, out, cfg, cfg_bytes, B, nz, stream);
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

}  // extern "C"
