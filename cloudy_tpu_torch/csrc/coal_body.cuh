// Shared device physics of the two fused kernels (fused_coalescence.cu).
//
// Counterpart of cloudy_tpu/ops/pallas_coalescence.py::_make_coal_body
// (:145-622; its fixed-threshold gamma/exponential exact-F2 branch), of
// pallas_numerical.py::_invert_rows (:79-118) and of
// pallas_coalescence.py::_sedi_flux_rows (:718-768), for ONE lane: one level
// of one column, all n_tot moments in registers.
//
// The configuration is table-driven: the host (ops/fused_coalescence.py,
// `pack_config`) packs families, offsets, thresholds, the nonzeros of the
// Q/R/S weight tensors wb and wf, the moment norms, the velocity terms, the
// Gauss-Legendre nodes and dt / inv_dz into one byte buffer; each block
// copies it to shared memory and every thread reads it from there (uniform
// addresses: broadcasts). Real constants are computed in double on the host
// and rounded once to T, as JAX folds Python floats into weakly typed
// constants. Operation order follows the Pallas body term for term; nvcc's
// default FMA contraction differs from XLA's fusion, so results agree with
// the plain twin to rounding (compared row-scaled, never elementwise).
//
// No fast-math: expf/logf/division stay IEEE-accurate and denormals are kept.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace cloudy {

// capacities; the library exports them with the header size
// (`cloudy_layout`) and the host checks its own copy against them on load
constexpr int MAX_MODES = 3;
constexpr int MAX_NTOT = 9;
constexpr int MAX_M = 5;
constexpr int MAX_S = 2 * MAX_M - 1;  // orders s of P(2k + s, T/theta)
constexpr int MAX_NPROG = 3;
constexpr int CFG_MAX_BYTES = 12288;

constexpr int FAM_EXPONENTIAL = 0;
constexpr int FAM_GAMMA = 1;

// int32 layout of the packed configuration: an 8-slot header, then
// per-mode ints and the wb/wf index tables; the reals start at the byte
// offset in slot H_REAL_OFF
constexpr int H_NMODES = 0, H_NTOT = 1, H_M = 2, H_NGL = 3, H_NWB = 4,
              H_NWF = 5, H_NVEL = 6, H_REAL_OFF = 7;
constexpr int I_FAM = 8;
constexpr int I_OFF = I_FAM + MAX_MODES;
constexpr int I_NPROG = I_OFF + MAX_MODES;
constexpr int I_THR = I_NPROG + MAX_MODES;
constexpr int I_TABLES = I_THR + MAX_MODES;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// jnp.maximum / jnp.minimum / jnp.clip semantics: NaN propagates
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T vmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T vclip(T x, T lo, T hi) {
  return vmin(vmax(x, lo), hi);
}

// The configuration, bound to the block's shared-memory copy.
template <typename T> struct Config {
  int n_modes, n_tot, M, n_gl, n_wb, n_wf, n_vel;
  const int* fam;
  const int* off;
  const int* nprog;
  const int* thr_flag;
  const int* wb_idx;  // n_wb x (o, i, j)
  const int* wf_idx;  // n_wf x (o, k, a, b), a <= b
  const T* thr;       // [MAX_MODES] normalized thresholds
  const T* norm;      // [MAX_NTOT] moment norms
  const T* inv_norm;  // [MAX_NTOT] 1 / norm (host double)
  const T* wb_c;
  const T* wf_c;
  const T* vel_c;  // normalized velocity coefficients
  const T* vel_e;  // exponents
  const T* vel_g;  // Gamma(1 + e)
  const T* vel_me; // n_vel x 3: m + e, m = 0..2 (host double)
  const T* gl_y1;  // GL node + 1
  const T* gl_w;   // GL weight
  T dt, inv_dz, two_thirds;

  __device__ __forceinline__ void bind(const unsigned char* buf) {
    const int* ip = reinterpret_cast<const int*>(buf);
    n_modes = ip[H_NMODES];
    n_tot = ip[H_NTOT];
    M = ip[H_M];
    n_gl = ip[H_NGL];
    n_wb = ip[H_NWB];
    n_wf = ip[H_NWF];
    n_vel = ip[H_NVEL];
    fam = ip + I_FAM;
    off = ip + I_OFF;
    nprog = ip + I_NPROG;
    thr_flag = ip + I_THR;
    wb_idx = ip + I_TABLES;
    wf_idx = wb_idx + 3 * n_wb;
    const T* rp = reinterpret_cast<const T*>(buf + ip[H_REAL_OFF]);
    thr = rp;
    norm = thr + MAX_MODES;
    inv_norm = norm + MAX_NTOT;
    wb_c = inv_norm + MAX_NTOT;
    wf_c = wb_c + n_wb;
    vel_c = wf_c + n_wf;
    vel_e = vel_c + n_vel;
    vel_g = vel_e + n_vel;
    vel_me = vel_g + n_vel;
    gl_y1 = vel_me + 3 * n_vel;
    gl_w = gl_y1 + n_gl;
    dt = gl_w[n_gl];
    inv_dz = gl_w[n_gl + 1];
    two_thirds = gl_w[n_gl + 2];
  }
};

// Copy the packed configuration (16-byte padded) into shared memory.
__device__ __forceinline__ void load_config(unsigned char* smem,
                                            const unsigned char* cfg,
                                            int cfg_bytes) {
  const int4* src = reinterpret_cast<const int4*>(cfg);
  int4* dst = reinterpret_cast<int4*>(smem);
  for (int w = threadIdx.x; w < cfg_bytes / 16; w += blockDim.x) dst[w] = src[w];
}

// special.lgamma_stirling: Stirling at z = x + 4, shift removed exactly
template <typename T> __device__ __forceinline__ T lgamma_stirling(T x) {
  const T z = x + T(4);
  const T log_z = dlog(z);
  const T iz = T(1) / z;
  const T iz2 = iz * iz;
  const T iz3 = iz * iz2;
  const T tail = iz * T(1.0 / 12.0) - iz3 * T(1.0 / 360.0) +
                 iz3 * iz2 * T(1.0 / 1260.0) -
                 iz3 * iz2 * iz2 * T(1.0 / 1680.0);
  const T lg_z = T(0.9189385332046727) + (z - T(0.5)) * log_z - z + tail;
  const T shift =
      vmax(x * (x + T(1)) * (x + T(2)) * (x + T(3)), Lim<T>::tiny());
  return lg_z - dlog(shift);
}

// special.gamma_ratio: Gamma(k + e) / Gamma(k)
template <typename T> __device__ __forceinline__ T gamma_ratio(T k, T e) {
  const T z = k + T(3);
  const T ze = z + e;
  const T log_z = dlog(z);
  const T log_ze = dlog(ze);
  const T iz = T(1) / z, ize = T(1) / ze;
  const T iz2 = iz * iz, ize2 = ize * ize;
  const T tail = (ize - iz) * T(1.0 / 12.0) -
                 (ize * ize2 - iz * iz2) * T(1.0 / 360.0) +
                 (ize * ize2 * ize2 - iz * iz2 * iz2) * T(1.0 / 1260.0);
  const T d = (ze - T(0.5)) * log_ze - (z - T(0.5)) * log_z - e + tail;
  const T front = (k * (k + T(1)) * (k + T(2))) /
                  ((k + e) * ((k + T(1)) + e) * ((k + T(2)) + e));
  return dexp(d) * front;
}

// special.gammainc_gl: P(a, x) by fixed Gauss-Legendre integration of the
// gamma density towards the far tail; gln = lgamma(a)
template <typename T>
__device__ __forceinline__ T gammainc_gl(const Config<T>& c, T a, T x, T gln) {
  const T tiny = Lim<T>::tiny();
  x = vmin(x, T(1e6));
  const T a1 = a - T(1);
  const T sqa = dsqrt(vmax(a1, tiny));
  const T xu_hi = vmax(a1 + T(11.5) * sqa, x + T(6) * sqa);
  const T xu_lo = vmax(vmin(a1 - T(7.5) * sqa, x - T(5) * sqa), T(0));
  const bool above = x > a1;
  const T xu = above ? xu_hi : xu_lo;
  const T half = T(0.5) * (xu - x);
  T s = T(0);
  for (int j = 0; j < c.n_gl; ++j) {
    const T t = vmax(x + half * c.gl_y1[j], tiny);
    const T f = dexp(a1 * dlog(t) - t - gln);
    s = (j == 0) ? c.gl_w[j] * f : s + c.gl_w[j] * f;
  }
  s = s * half;
  const T out = vclip(above ? T(1) - s : -s, T(0), T(1));
  return (x > T(0)) ? out : T(0);
}

// _f2_gamma_exact: gis[s] = P(2k + s, T/theta), s = 0..2M-2
template <typename T>
__device__ __forceinline__ void gis_exact(const Config<T>& c, T thr, T theta,
                                          T k, T* gis) {
  const T tiny = Lim<T>::tiny();
  const int M = c.M;
  const T x = vmin(thr / theta, T(1e6));
  const T log_x = dlog(vmax(x, tiny));
  const T a0 = T(2) * k;
  const T lga01 = lgamma_stirling(a0 + T(1));
  T d = dexp(a0 * log_x - x - lga01);
  d = (x > T(0)) ? d : T(0);
  T ds[MAX_S];
  ds[0] = d;
  T prod = T(1);
#pragma unroll
  for (int j = 1; j < MAX_S - 1; ++j) {
    if (j < 2 * M - 2) {
      ds[j] = ds[j - 1] * x / (a0 + T(j));
      prod = (j == 1) ? (a0 + T(j)) : prod * (a0 + T(j));
    }
  }
  T gi = gammainc_gl(c, a0 + T(2 * M - 2), x, lga01 + dlog(prod));
  gis[2 * M - 2] = gi;
#pragma unroll
  for (int j = MAX_S - 2; j >= 0; --j) {
    if (j <= 2 * M - 3) {
      gi = vclip(gi + ds[j], T(0), T(1));
      gis[j] = gi;
    }
  }
}

// Closure inversion (_invert_rows) for mode i of normalized moments `mom`.
template <typename T>
__device__ __forceinline__ void invert_mode(int fam, const T* m, T& n, T& p1,
                                            T& p2) {
  const T eps = Lim<T>::eps();
  const T m0 = m[0], m1 = m[1];
  const bool valid = (m0 > eps) && (m1 > eps);
  const T m0s = valid ? m0 : T(1);
  const T m1s = valid ? m1 : T(1);
  if (fam == FAM_EXPONENTIAL) {
    n = valid ? m0 : T(0);
    p1 = valid ? m1s / m0s : T(1);
    p2 = T(0);
    return;
  }
  const T m2s = valid ? m[2] : T(2);
  const T mean = m1s / m0s;
  T denom = m2s / m1s - mean;
  denom = (dabs(denom) > T(0)) ? denom : eps;
  const T kk = vclip(mean / denom, eps, T(10));
  const T theta = mean / kk;
  n = valid ? m0 : T(0);
  p1 = valid ? theta : T(1);
  p2 = valid ? kk : T(1);
}

// The coalescence body on one lane: normalized moments `mom` [n_tot] ->
// tendencies `acc` [n_tot] and the closure parameters per mode.
template <typename T>
__device__ __forceinline__ void coal_body(const Config<T>& c, const T* mom,
                                          T* acc, T (*params)[3]) {
  const T eps = Lim<T>::eps();
  const int M = c.M;
  T mf[MAX_MODES * MAX_M];
  T gis[MAX_MODES][MAX_S];
#pragma unroll
  for (int i = 0; i < MAX_MODES; ++i) {
    if (i >= c.n_modes) continue;
    const int fam = c.fam[i];
    T n, p1, p2;
    invert_mode(fam, mom + c.off[i], n, p1, p2);
    params[i][0] = n;
    params[i][1] = p1;
    params[i][2] = p2;
    // diagnostic moment recurrence M_{o+1} = M_o * theta * (k + o) | (o + 1)
    T m = n;
    mf[i * M] = n;
    for (int o = 0; o < M - 1; ++o) {
      m = (fam == FAM_EXPONENTIAL) ? m * p1 * T(o + 1) : m * p1 * (p2 + T(o));
      mf[i * M + o + 1] = m;
    }
    if (c.thr_flag[i]) {
      const T kk = (fam == FAM_GAMMA) ? p2 : T(1);
      gis_exact(c, c.thr[i], p1, kk, gis[i]);
    }
  }
  // Q/R/S: sparse FMAs over the static nonzeros of wb, then wf
  for (int o = 0; o < c.n_tot; ++o) acc[o] = T(0);
  for (int e = 0; e < c.n_wb; ++e) {
    const int* ix = c.wb_idx + 3 * e;
    acc[ix[0]] = acc[ix[0]] + c.wb_c[e] * mf[ix[1]] * mf[ix[2]];
  }
  for (int e = 0; e < c.n_wf; ++e) {
    const int* ix = c.wf_idx + 4 * e;
    const int k = ix[1], a = ix[2], b = ix[3];
    const T mm = mf[k * M + a] * mf[k * M + b];
    // clamp against M_a * M_b, reference zero-structure (mm < eps)
    T v = c.thr_flag[k] ? vmin(mm, mm * gis[k][a + b]) : mm;
    v = (mm < eps) ? T(0) : v;
    acc[ix[0]] = acc[ix[0]] + c.wf_c[e] * v;
  }
}

// _sedi_flux_rows (fast_ratio): normalized flux -sum_k c_k M_{m+e_k}
template <typename T>
__device__ __forceinline__ void sedi_flux(const Config<T>& c,
                                          const T (*params)[3], T* flux) {
  const T tiny = Lim<T>::tiny();
#pragma unroll
  for (int i = 0; i < MAX_MODES; ++i) {
    if (i >= c.n_modes) continue;
    const int fam = c.fam[i];
    const int np = c.nprog[i];
    const T n = params[i][0], p1 = params[i][1], p2 = params[i][2];
    const T logp1 = dlog(vmax(p1, tiny));
    T fl[MAX_NPROG];
#pragma unroll
    for (int m = 0; m < MAX_NPROG; ++m) fl[m] = T(0);
    for (int v = 0; v < c.n_vel; ++v) {
      const T cv = c.vel_c[v], e = c.vel_e[v];
      T t = (fam == FAM_GAMMA) ? n * dexp(e * logp1) * gamma_ratio(p2, e)
                               : n * c.vel_g[v] * dexp(e * logp1);
#pragma unroll
      for (int m = 0; m < MAX_NPROG; ++m) {
        if (m >= np) continue;
        if (m > 0) {
          t = (fam == FAM_GAMMA) ? t * p1 * ((p2 + T(m - 1)) + e)
                                 : t * p1 * c.vel_me[3 * v + m];
        }
        fl[m] = fl[m] + cv * t;
      }
    }
#pragma unroll
    for (int m = 0; m < MAX_NPROG; ++m) {
      if (m >= np) continue;
      flux[c.off[i] + m] = -fl[m];
    }
  }
}

}  // namespace cloudy
