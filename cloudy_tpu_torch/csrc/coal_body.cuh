// Shared device physics of the three fused kernels (fused_coalescence.cu).
//
// Counterpart of cloudy_tpu/ops/pallas_coalescence.py::_make_coal_body
// (:145-622; all four families: gamma/exponential F2, exact or on a
// quadrature grid, lognormal F2 by the window rule or on the Phi grid, the
// monodisperse closed form, under FixedThreshold and MovingThreshold) and of
// pallas_coalescence.py::_sedi_flux_rows (:718-768), for ONE lane:
// one level of one column, all n_tot moments in registers. Special functions
// follow cloudy_tpu/ops/special.py term for term (Acklam `ndtri`, the fast
// GL percentile inverse and the damped-Newton one, the A&S rational `erf`
// and the series erf through P(1/2, z^2));
// the closure inversion (pallas_numerical.py::_invert_rows), the Lanczos
// `lgamma` and the series/CF incomplete gamma are in common.cuh.
//
// The configuration reaches the body in one of two forms, a type `C` the
// functions below are templated on:
//
// - table-driven, `Config<T>`: the host (ops/fused_coalescence.py,
//   `pack_config`) packs families, offsets, thresholds, the nonzeros of the
//   Q/R/S weight tensors wb and wf, the moment norms, the velocity terms,
//   the Gauss-Legendre nodes and dt / inv_dz into one byte buffer; each
//   block copies it to shared memory and every thread reads it from there
//   (uniform addresses: broadcasts). Indices read at run time keep the
//   body's per-lane arrays (mf, ftab, acc) in local memory. B1s, B3 and the
//   reference tier run it;
// - compiled in (`C::kStatic`): a type generated per configuration and type
//   by ops/codegen.py, whose members are `static constexpr` scalars and
//   constant tables indexed like the packed ones. Every loop over them
//   (`each`) has a compile-time bound and is fully unrolled, every index
//   folds to a constant, so the per-lane arrays live in registers, and a
//   branch the configuration rules out compiles to nothing. The Q/R/S
//   contraction is the generated straight-line `C::contract`. Both tiers of
//   B1, B1s and B4 and the fast tier of B3 run it (csrc/gen_kernels.cuh); a
//   reference-tier configuration also carries its rule, iteration counts,
//   grid sizes and F2 kinds as constants, and its fixed grids and Gauss base
//   nodes, which the node loops index at run time, as `__constant__` tables
//   of its unit (read at one address per warp: broadcasts).
//
// Real constants are computed in double on the host and rounded once to T,
// as JAX folds Python floats into weakly typed constants. Operation order
// follows the Pallas body term for term; nvcc's
// default FMA contraction differs from XLA's fusion, so results agree with
// the plain twin to rounding (compared row-scaled, never elementwise); the
// reference whole step is built without contraction
// (fused_coalescence.cu), so its gridless arms match the twin bit for bit.
//
// The MovingThreshold and lognormal arms are compiled only into the
// kernels' `kArms = true` instances: the host launches the `false` instance
// for a FixedThreshold gamma/exponential configuration (`FusedPlan.arms`),
// which then carries neither arm's registers nor its stack. The reference
// tier (`kRef = true`, always with kArms) adds the gamma/exponential and the
// lognormal (Phi) F2 on a quadrature grid (fixed grids packed by the host,
// moving Simpson and Gauss grids built per lane, QuadGrid), the
// series/continued-fraction incomplete gamma and erf, the damped-Newton
// percentile inverse, the Lanczos-pair flux and monodisperse modes (the
// recurrence M theta, the moving threshold theta, the closed-form F2 where
// theta < T/2, the flux n theta^e); in the table-driven configuration the
// rule, the grid, GL or series/CF, the erf and the F2 kind are runtime
// switches, in a compiled-in one constants. The fast instances compile to
// the code they had without it.
//
// Logs, exps, divides and square roots go through the domain of the
// configuration (`Sfu`, common.cuh `Dom`): the IEEE routines in every unit
// but the generated fast-tier f32 ones without a monodisperse mode
// (`kSfu`), which take the same operations in the same order in base 2 on
// the SFU, with log2(e) folded into their constants in double and rounded
// once. The table-driven configuration, the reference tier, f64 and the
// monodisperse plans (built without FMA contraction, held to the twin bit for
// bit) keep the IEEE expressions, operation for operation. No fast-math flag;
// denormals are kept.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace cloudy {

// Whether a configuration ends the series incomplete gamma's loop where a
// term no longer changes the sum (gammainc_sc's kExit): a generated
// reference-tier configuration's `kSeriesExit`; the table-driven
// configuration, which has none, runs the fixed loop.
template <class C, class = void> struct SeriesExit : std::false_type {};
template <class C>
struct SeriesExit<C, std::void_t<decltype(C::kSeriesExit)>>
    : std::integral_constant<bool, C::kSeriesExit> {};

// Whether a configuration takes the SFU forms (common.cuh `Dom<float,
// true>`): a generated configuration's `kSfu` (ops/codegen.py: fast tier,
// float, no monodisperse mode), in f32 only; the table-driven configuration,
// which has none, keeps the IEEE routines.
template <class C, class = void> struct Sfu : std::false_type {};
template <class C>
struct Sfu<C, std::void_t<decltype(C::kSfu)>>
    : std::integral_constant<bool, C::kSfu &&
                                       std::is_same<typename C::real, float>::value> {};

// Capacities. A configuration type `C` carries its own as `C::kModes`,
// `C::kNtot` and `C::kM` (modes, moments, moment orders M: the size of every
// per-lane array of the body), with `C::kS` = 2 kM - 1 orders s of
// P(2k + s, T/theta) and `C::kFtab` = kM (kM + 1) / 2 entries of an F2 row.
// The table-driven `Config<T>` takes them from CLOUDY_CAP_MODES,
// CLOUDY_CAP_NTOT and CLOUDY_CAP_M: the prebuilt library's (3, 9, 5), or a
// unit's own, defined before this header by a unit built at first use for a
// plan past them (ops/codegen.py `ref_unit`). A generated configuration's
// are its own n_modes and n_tot, and M but at least MAX_M (the F2 rows'
// stride). The library exports its capacities with the header size
// (`cloudy_layout`, a unit `cloudy_ref_layout`) and the host checks its own
// copy against them on load.
#ifndef CLOUDY_CAP_MODES
#define CLOUDY_CAP_MODES 3
#define CLOUDY_CAP_NTOT 9
#define CLOUDY_CAP_M 5
#endif
constexpr int CAP_MODES = CLOUDY_CAP_MODES;
constexpr int CAP_NTOT = CLOUDY_CAP_NTOT;
constexpr int CAP_M = CLOUDY_CAP_M;
// the least F2 row stride (the prebuilt capacity of M)
constexpr int MAX_M = 5;
constexpr int MAX_NPROG = 3;

// int32 layout of the packed configuration: a 10-slot header, then
// per-mode ints and the wb/wf index tables; the reals start at the byte
// offset in slot H_REAL_OFF
constexpr int H_NMODES = 0, H_NTOT = 1, H_M = 2, H_NGL = 3, H_NWB = 4,
              H_NWF = 5, H_NVEL = 6, H_REAL_OFF = 7, H_MOVING = 8, H_NWIN = 9;
// reference tier: quadrature rule (1 Gauss), series/CF iterations of the F2
// incomplete gamma, Newton steps and their series/CF iterations, points of
// a moving Simpson grid, GL base nodes of a moving Gauss grid, then per
// mode (kModes slots each: `Config`) the F2 kind and the length of its fixed
// grid
constexpr int H_QUAD = 10, H_GI_ITERS = 11, H_NEWTON = 12, H_THR_ITERS = 13,
              H_NPTS = 14, H_NGAUSS = 15;
constexpr int I_F2KIND = 16;

// jnp.sign: -1, 0 or 1, and NaN for NaN
template <typename T> __device__ __forceinline__ T vsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// per-mode F2 (ops/fused_coalescence.py F2_*)
constexpr int F2_NONE = 0, F2_EXACT = 1, F2_WINDOW = 2, F2_GRID = 3,
              F2_MONO = 4;

// index of (p, q), p <= q < kM, in an F2 row of stride kM
template <int kM> __host__ __device__ constexpr int tri(int p, int q) {
  return p * (2 * kM - p - 1) / 2 + q;
}

// The configuration, bound to the block's shared-memory copy.
template <typename T> struct Config {
  using real = T;
  static constexpr bool kStatic = false;
  static constexpr int kModes = CAP_MODES, kNtot = CAP_NTOT, kM = CAP_M;
  static constexpr int kS = 2 * kM - 1, kFtab = kM * (kM + 1) / 2;
  // per-mode int slots and the header's size
  static constexpr int I_GRIDN = I_F2KIND + kModes;
  static constexpr int I_FAM = I_GRIDN + kModes;
  static constexpr int I_OFF = I_FAM + kModes;
  static constexpr int I_NPROG = I_OFF + kModes;
  static constexpr int I_THR = I_NPROG + kModes;
  static constexpr int I_TABLES = I_THR + kModes;
  int n_modes, n_tot, M, n_gl, n_wb, n_wf, n_vel, moving, n_win;
  int quad, gi_iters, newton_iters, thr_gi_iters, n_pts, n_gauss;
  const int* f2kind;
  const int* grid_n;
  const int* fam;
  const int* off;
  const int* nprog;
  const int* thr_flag;  // mode carries an F2 integral
  const int* wb_idx;    // n_wb x (o, i, j)
  const int* wf_idx;    // n_wf x (o, k, a, b), a <= b
  // [kModes] fixed: normalized thresholds; moving: gamma the percentile
  // p, exponential -log1p(-p), lognormal ndtri(p) (host double)
  const T* thr;
  const T* norm;      // [kNtot] moment norms
  const T* inv_norm;  // [kNtot] 1 / norm (host double)
  const T* wb_c;
  const T* wf_c;
  const T* vel_c;  // normalized velocity coefficients
  const T* vel_e;  // exponents
  const T* vel_g;  // Gamma(1 + e)
  const T* vel_me; // n_vel x 3: q = m + e, m = 0..2 (host double)
  const T* vel_hq2;  // n_vel x 3: 0.5 q q (host double)
  const T* gl_y1;  // GL node + 1
  const T* gl_w;   // GL weight
  const T* win_v;  // lognormal window GL nodes
  const T* win_w;  // and weights
  T dt, inv_dz, two_thirds;
  const T* grid_dx;  // [kModes] dx of each fixed grid
  const T* gauss_u;  // n_gauss GL base nodes of a moving Gauss grid
  const T* gauss_w;  // and weights
  const T* grids;    // per fixed-grid mode: x[grid_n], w[grid_n]

  __device__ __forceinline__ void bind(const unsigned char* buf) {
    const int* ip = reinterpret_cast<const int*>(buf);
    n_modes = ip[H_NMODES];
    n_tot = ip[H_NTOT];
    M = ip[H_M];
    n_gl = ip[H_NGL];
    n_wb = ip[H_NWB];
    n_wf = ip[H_NWF];
    n_vel = ip[H_NVEL];
    moving = ip[H_MOVING];
    n_win = ip[H_NWIN];
    quad = ip[H_QUAD];
    gi_iters = ip[H_GI_ITERS];
    newton_iters = ip[H_NEWTON];
    thr_gi_iters = ip[H_THR_ITERS];
    n_pts = ip[H_NPTS];
    n_gauss = ip[H_NGAUSS];
    f2kind = ip + I_F2KIND;
    grid_n = ip + I_GRIDN;
    fam = ip + I_FAM;
    off = ip + I_OFF;
    nprog = ip + I_NPROG;
    thr_flag = ip + I_THR;
    wb_idx = ip + I_TABLES;
    wf_idx = wb_idx + 3 * n_wb;
    const T* rp = reinterpret_cast<const T*>(buf + ip[H_REAL_OFF]);
    thr = rp;
    norm = thr + kModes;
    inv_norm = norm + kNtot;
    wb_c = inv_norm + kNtot;
    wf_c = wb_c + n_wb;
    vel_c = wf_c + n_wf;
    vel_e = vel_c + n_vel;
    vel_g = vel_e + n_vel;
    vel_me = vel_g + n_vel;
    vel_hq2 = vel_me + 3 * n_vel;
    gl_y1 = vel_hq2 + 3 * n_vel;
    gl_w = gl_y1 + n_gl;
    win_v = gl_w + n_gl;
    win_w = win_v + n_win;
    dt = win_w[n_win];
    inv_dz = win_w[n_win + 1];
    two_thirds = win_w[n_win + 2];
    grid_dx = win_w + n_win + 3;
    gauss_u = grid_dx + kModes;
    gauss_w = gauss_u + n_gauss;
    grids = gauss_w + n_gauss;
  }

  // the fixed grid of mode i: x[grid_n[i]], then w[grid_n[i]]
  __device__ __forceinline__ const T* grid(int i) const {
    const T* g = grids;
    for (int m = 0; m < i; ++m) g += 2 * grid_n[m];
    return g;
  }
};

// f(j) for j = 0 .. n-1: fully unrolled for a compiled-in configuration
// (n is then a compile-time constant once inlined), the plain loop the
// table-driven configuration always ran otherwise.
template <class C, class F>
__device__ __forceinline__ void each(int n, F&& f) {
  if constexpr (C::kStatic) {
#pragma unroll
    for (int j = 0; j < n; ++j) f(j);
  } else {
    for (int j = 0; j < n; ++j) f(j);
  }
}

// special.lgamma_stirling: Stirling at z = x + 4, shift removed exactly;
// kSfu: in the domain of Dom<T, kSfu> (times log2(e) in base 2), for x >= 0
// (every such caller's: z >= 4, a normal reciprocal)
template <bool kSfu = false, typename T> __device__ __forceinline__ T lgamma_stirling(T x) {
  using D = Dom<T, kSfu>;
  const T z = x + T(4);
  const T log_z = D::lg(z);
  const T iz = D::rcp(z);
  const T iz2 = iz * iz;
  const T iz3 = iz * iz2;
  const T tail = iz * T(D::kFromLnD / 12.0) - iz3 * T(D::kFromLnD / 360.0) +
                 iz3 * iz2 * T(D::kFromLnD / 1260.0) -
                 iz3 * iz2 * iz2 * T(D::kFromLnD / 1680.0);
  const T lg_z =
      T(0.9189385332046727 * D::kFromLnD) + (z - T(0.5)) * log_z - D::from_ln(z) + tail;
  const T shift =
      vmax(x * (x + T(1)) * (x + T(2)) * (x + T(3)), Lim<T>::tiny());
  return lg_z - D::lg(shift);
}

// special.gamma_ratio: Gamma(k + e) / Gamma(k); e_dom is e in the domain of
// Dom<T, kSfu> (e itself, or e log2(e) rounded once: the configuration's
// `vel_e2`). z >= 3 and, for k > 0 and e >= 0 (every caller's), ze and the
// front's denominator are normal: reciprocals.
template <bool kSfu = false, typename T>
__device__ __forceinline__ T gamma_ratio(T k, T e, T e_dom) {
  using D = Dom<T, kSfu>;
  const T z = k + T(3);
  const T ze = z + e;
  const T log_z = D::lg(z);
  const T log_ze = D::lg(ze);
  const T iz = D::rcp(z), ize = D::rcp(ze);
  const T iz2 = iz * iz, ize2 = ize * ize;
  const T tail = (ize - iz) * T(D::kFromLnD / 12.0) -
                 (ize * ize2 - iz * iz2) * T(D::kFromLnD / 360.0) +
                 (ize * ize2 * ize2 - iz * iz2 * iz2) * T(D::kFromLnD / 1260.0);
  const T d = (ze - T(0.5)) * log_ze - (z - T(0.5)) * log_z - e_dom + tail;
  const T front = D::quo(k * (k + T(1)) * (k + T(2)),
                         (k + e) * ((k + T(1)) + e) * ((k + T(2)) + e));
  return D::ex(d) * front;
}

// special.gammainc_gl: P(a, x) by fixed Gauss-Legendre integration of the
// gamma density towards the far tail; gln = lgamma(a), in the domain of the
// configuration (`Sfu`: times log2(e)), so that each node is one log, two
// FMAs and one exp
template <class C, typename T>
__device__ __forceinline__ T gammainc_gl(const C& c, T a, T x, T gln) {
  using D = Dom<T, Sfu<C>::value>;
  const T tiny = Lim<T>::tiny();
  x = vmin(x, T(1e6));
  const T a1 = a - T(1);
  const T sqa = D::sqrt(vmax(a1, tiny));  // tiny or more
  const T xu_hi = vmax(a1 + T(11.5) * sqa, x + T(6) * sqa);
  const T xu_lo = vmax(vmin(a1 - T(7.5) * sqa, x - T(5) * sqa), T(0));
  const bool above = x > a1;
  const T xu = above ? xu_hi : xu_lo;
  const T half = T(0.5) * (xu - x);
  T s = T(0);
  each<C>(c.n_gl, [&](int j) {
    const T t = vmax(x + half * c.gl_y1[j], tiny);
    const T f = D::ex(a1 * D::lg(t) - D::from_ln(t) - gln);
    s = (j == 0) ? c.gl_w[j] * f : s + c.gl_w[j] * f;
  });
  s = s * half;
  const T out = vclip(above ? T(1) - s : -s, T(0), T(1));
  return (x > T(0)) ? out : T(0);
}

// special.ndtri: Acklam's inverse normal CDF, branch-free; kSfu: the SFU
// forms of Dom<T, true> (the tail's p is tiny or more, its denominator 1 or
// more)
template <bool kSfu = false, typename T> __device__ __forceinline__ T ndtri_tail(T p) {
  using D = Dom<T, kSfu>;
  const T q = D::sqrt(T(-2.0 * D::kToLnD) * D::lg(p));
  const T num = ((((T(-7.784894002430293e-03) * q + T(-3.223964580411365e-01)) *
                       q + T(-2.400758277161838e+00)) * q +
                  T(-2.549732539343734e+00)) * q + T(4.374664141464968e+00)) *
                    q + T(2.938163982698783e+00);
  const T den = (((T(7.784695709041462e-03) * q + T(3.224671290700398e-01)) * q +
                  T(2.445134137142996e+00)) * q + T(3.754408661907416e+00)) *
                    q + T(1);
  return D::quo(num, den);
}

template <bool kSfu = false, typename T> __device__ __forceinline__ T ndtri(T p) {
  using D = Dom<T, kSfu>;
  const T p_low = T(0.02425), p_high = T(1.0 - 0.02425);
  p = vclip(p, Lim<T>::tiny(), T(1.0 - 1e-16));
  const T q = vclip(p, p_low, p_high) - T(0.5);
  const T r = q * q;
  const T num = ((((T(-3.969683028665376e+01) * r + T(2.209460984245205e+02)) *
                       r + T(-2.759285104469687e+02)) * r +
                  T(1.383577518672690e+02)) * r + T(-3.066479806614716e+01)) *
                    r + T(2.506628277459239e+00);
  const T den = ((((T(-5.447609879822406e+01) * r + T(1.615858368580409e+02)) *
                       r + T(-1.556989798598866e+02)) * r +
                  T(6.680131188771972e+01)) * r + T(-1.328068155288572e+01)) *
                    r + T(1);
  const T x_central = D::div(num * q, den);
  const T x_low = ndtri_tail<kSfu>(vmin(p, p_low));
  const T x_up = -ndtri_tail<kSfu>(vmin(T(1) - p, p_low));
  return p < p_low ? x_low : (p > p_high ? x_up : x_central);
}

template <typename T> struct Eps;
template <> struct Eps<float> {
  static __device__ __forceinline__ float neg() { return 5.9604645e-08f; }
};
template <> struct Eps<double> {
  static __device__ __forceinline__ double neg() { return 1.1102230246251565e-16; }
};

// special.gammaincinv_gl_impl: x with P(a, x) = p; max(Wilson-Hilferty,
// small-x) start, n_iter = 3 Halley steps on the shift-4 GL P(a, x). The
// logs in the domain of the configuration (`Sfu`); a > 0, and xs_t is tiny
// or more and 1e6 or less: normal denominators
template <class C, typename T>
__device__ __forceinline__ T gammaincinv_gl(const C& c, T a, T p) {
  constexpr bool kSfu = Sfu<C>::value;
  using D = Dom<T, kSfu>;
  const T tiny = Lim<T>::tiny();
  p = vclip(p, tiny, T(1) - Eps<T>::neg());
  const T z = ndtri<kSfu>(p);
  const T t = T(1) - D::rcp(T(9) * a) + z * D::sqrt(D::rcp(T(9) * a));
  const T x_wh = (t > T(0)) ? a * t * t * t : T(0);
  const T lga1 = lgamma_lanczos<kSfu>(a + T(1));
  const T x_small = D::ex(D::quo(D::lg(p) + lga1, a));
  T x = vmax(vmax(x_wh, x_small), tiny);
  const T gln4 = lga1 + D::lg((a + T(1)) * (a + T(2)) * (a + T(3)));
#pragma unroll 1
  for (int it = 0; it < 3; ++it) {
    const T xs = vmin(x, T(1e6));
    const T xs_t = vmax(xs, tiny);
    T d = D::ex(a * D::lg(xs_t) - D::from_ln(xs) - lga1);
    d = (xs > T(0)) ? d : T(0);
    const T deriv = D::quo(d * a, xs_t);
    T total = d;
    d = D::quo(d * xs, a + T(1));
    total = total + d;
    d = D::quo(d * xs, a + T(2));
    total = total + d;
    d = D::quo(d * xs, a + T(3));
    total = total + d;
    const T p4 = gammainc_gl(c, a + T(4), xs, gln4);
    const T f = vclip(p4 + total, T(0), T(1)) - p;
    // deriv may overflow to inf: rcp(inf) is 0, as f / inf
    const T step_n = D::quo(f, vmax(deriv, tiny));
    const T h = T(0.5) * (D::quo(a - T(1), xs_t) - T(1));
    const T denom = vclip(T(1) - step_n * h, T(0.5), T(2));
    T step = D::quo(step_n, denom);
    step = vclip(step, T(-9) * x, T(0.9) * x);
    x = x - step;
  }
  return x;
}

// special.gammaincinv_impl: x with P(a, x) = p; Wilson-Hilferty start with
// the small-a fallback, n_newton damped Newton steps on the series/CF
// P(a, x) of n_iters iterations (kExit: gammainc_sc's)
template <bool kExit, typename T>
__device__ __forceinline__ T gammaincinv_newton(T a, T p, int n_newton,
                                                int n_iters) {
  const T tiny = Lim<T>::tiny();
  p = vclip(p, tiny, T(1) - Eps<T>::neg());
  const T z = ndtri(p);
  const T t = T(1) - T(1) / (T(9) * a) + z * dsqrt(T(1) / (T(9) * a));
  const T x0 = a * t * t * t;
  const T x_small = dexp((dlog(p) + lgamma_lanczos(a + T(1))) / a);
  T x = vmax((t > T(0) && x0 > T(1e3) * tiny) ? x0 : x_small, tiny);
  const T lg = lgamma_lanczos(a);
#pragma unroll 1
  for (int it = 0; it < n_newton; ++it) {
    const T lx = dlog(vmax(x, tiny));
    // gammainc_impl's own log, of x clamped at 1e6
    const T lxc = (x > T(1e6)) ? dlog(T(1e6)) : lx;
    const T f = gammainc_sc<kExit>(a, x, n_iters, lg, lxc) - p;
    const T logdf = (a - T(1)) * lx - x - lg;
    T step = f * dexp(-logdf);
    step = vclip(step, T(-9) * x, T(0.9) * x);
    x = x - step;
  }
  return x;
}

// special.erf_approx: A&S 7.1.26, sign(x) * y (0 at x = 0, as jnp.sign);
// kSfu: the SFU forms of Dom<T, true> (the denominator is 1 or more)
template <bool kSfu = false, typename T> __device__ __forceinline__ T erf_approx(T x) {
  using D = Dom<T, kSfu>;
  const T ax = dabs(x);
  const T t = D::rcp(T(1) + T(0.3275911) * ax);
  const T poly = ((((T(1.061405429) * t + T(-1.453152027)) * t +
                    T(1.421413741)) * t + T(-0.284496736)) * t +
                  T(0.254829592)) * t;
  const T y = T(1) - poly * D::ex(D::from_ln(-ax * ax));
  return vsign(x) * y;
}

// special.erf_impl: sign(z) * P(1/2, z^2) by the series/CF incomplete gamma
// at n_iters (its log of z^2 taken after the clamp at 1e6, as gammainc_impl
// takes it); lg_half = lgamma(1/2), hoisted by the caller
template <bool kExit, typename T>
__device__ __forceinline__ T erf_series(T z, int n_iters, T lg_half) {
  const T x = z * z;
  const T log_x = dlog(vmax(vmin(x, T(1e6)), Lim<T>::tiny()));
  return vsign(z) * gammainc_sc<kExit>(T(0.5), x, n_iters, lg_half, log_x);
}

// _f2_gamma_exact: gis[s] = P(2k + s, T/theta), s = 0..2M-2; the top order
// by GL with the Stirling lgamma, or (reference tier, n_gl = 0) by series/CF
// with the Lanczos one. The logs in the domain of the configuration (`Sfu`);
// theta may be any positive f32 (a full-range divide), a0 + j >= 1 (a
// reciprocal).
template <bool kRef, class C, typename T>
__device__ __forceinline__ void gis_exact(const C& c, T thr, T theta, T k,
                                          T* gis) {
  constexpr bool kSfu = Sfu<C>::value;
  using D = Dom<T, kSfu>;
  const T tiny = Lim<T>::tiny();
  const int M = c.M;
  const bool sc = kRef && c.n_gl == 0;
  const T x = vmin(D::div(thr, theta), T(1e6));
  const T log_x = D::lg(vmax(x, tiny));
  const T a0 = T(2) * k;
  const T lga01 = sc ? lgamma_lanczos(a0 + T(1)) : lgamma_stirling<kSfu>(a0 + T(1));
  T d = D::ex(a0 * log_x - D::from_ln(x) - lga01);
  d = (x > T(0)) ? d : T(0);
  T ds[C::kS];
  ds[0] = d;
  T prod = T(1);
#pragma unroll
  for (int j = 1; j < C::kS - 1; ++j) {
    if (j < 2 * M - 2) {
      ds[j] = D::quo(ds[j - 1] * x, a0 + T(j));
      prod = (j == 1) ? (a0 + T(j)) : prod * (a0 + T(j));
    }
  }
  T gi;
  if constexpr (kRef) {
    if (sc) {
      const T a_top = a0 + T(2 * M - 2);
      gi = gammainc_sc<SeriesExit<C>::value>(a_top, x, c.gi_iters,
                                             lgamma_lanczos(a_top), log_x);
    } else {
      gi = gammainc_gl(c, a0 + T(2 * M - 2), x, lga01 + dlog(prod));
    }
  } else {
    gi = gammainc_gl(c, a0 + T(2 * M - 2), x, lga01 + D::lg(prod));
  }
  gis[2 * M - 2] = gi;
#pragma unroll
  for (int j = C::kS - 2; j >= 0; --j) {
    if (j <= 2 * M - 3) {
      gi = vclip(gi + ds[j], T(0), T(1));
      gis[j] = gi;
    }
  }
}

// _f2_lognormal_window: the lognormal F2 entries p <= q < M (before the
// clamp) by the density-recentred GL window rule, written to f2[tri(p, q)]
// (`tri` of stride C::kM, as every F2 row below).
// The nodes are streamed: each node adds ypow_p * pm_q to p <= q
// accumulators (the Pallas body sums its [G, TB] tile with jnp.sum), and
// exp(q mu + q^2 sigma^2 / 2) is hoisted out of the node loop.
template <class C, typename T>
__device__ __forceinline__ void f2_lognormal_window(const C& c, T thr, T n,
                                                    T mu, T sig, T* f2) {
  // the domain of the configuration (`Sfu`); mu, sig and the nodes u stay
  // natural; two_s2, sig_c and sig_r2 are normal (sig >= eps): reciprocals
  constexpr bool kSfu = Sfu<C>::value;
  using D = Dom<T, kSfu>;
  const T tiny = Lim<T>::tiny();
  const int M = c.M;
  const T W = T(6);  // coalescence.LOGNORM_WINDOW_SIGMA
  const T s2 = sig * sig;
  const T lo = mu - W * sig;
  const T hi = vmin(D::to_ln(D::lg(vmax(thr, tiny))), mu + T(M) * s2 + W * sig);
  const T half = vmax(hi - lo, T(0)) * T(0.5);
  const T center = lo + half;
  const T two_s2 = T(2) * s2;
  const T sig_c = sig * T(2.5066282746310002);  // sqrt(2 pi)
  const T sig_r2 = sig * T(1.4142135623730951);  // sqrt(2)
  T eq[C::kM], qs2[C::kM], acc[C::kFtab];
#pragma unroll
  for (int q = 0; q < C::kM; ++q) {
    eq[q] = D::ex(D::from_ln(T(q) * mu + T(0.5 * q * q) * s2));
    qs2[q] = T(q) * s2;
  }
#pragma unroll
  for (int e = 0; e < C::kFtab; ++e) acc[e] = T(0);
  each<C>(c.n_win, [&](int g) {
    const T u = center + half * c.win_v[g];
    const T x = D::ex(D::from_ln(u));
    const T du = u - mu;
    const T g0 =
        D::quo(half * c.win_w[g] * D::ex(D::from_ln(D::quo(-(du * du), two_s2))), sig_c);
    const T rem = vmax(thr - x, T(0));
    const T logrem = D::to_ln(D::lg(vmax(rem, tiny)));
    T pm[C::kM];
#pragma unroll
    for (int q = 0; q < C::kM; ++q) {
      if (q < M) {
        const T z = D::quo(logrem - mu - qs2[q], sig_r2);
        const T v = eq[q] * T(0.5) * (T(1) + erf_approx<kSfu>(z));
        pm[q] = (rem > T(0)) ? v : T(0);
      }
    }
    T ypow = g0;
#pragma unroll
    for (int p = 0; p < C::kM; ++p) {
      if (p < M) {
        if (p > 0) ypow = ypow * x;
#pragma unroll
        for (int q = p; q < C::kM; ++q)
          if (q < M) acc[tri<C::kM>(p, q)] = acc[tri<C::kM>(p, q)] + ypow * pm[q];
      }
    }
  });
  const T n2 = n * n;
#pragma unroll
  for (int e = 0; e < C::kFtab; ++e) f2[e] = acc[e] * n2;
}

// How a lane takes its part of a quadrature grid's nodes (the grid F2 loops
// below) and adds the parts up:
// - Serial: a box per lane, every node in turn (every kernel but one);
// - WarpSplit: a box per warp (the reference-tier coalescence kernel at
//   small batches, fused_coalescence.cu): lane l takes nodes l, l + 32, ...
//   and the warp's partial sums are added by a fixed xor-shuffle tree, which
//   leaves the same total, bit for bit, in every lane (each step adds two
//   partial sums that the two lanes hold in swapped order, and IEEE addition
//   commutes), so every lane goes on as the serial lane would, and two
//   launches agree bit for bit.
struct Serial {
  static constexpr int kStep = 1;
  __device__ __forceinline__ int first() const { return 0; }
  template <typename T> __device__ __forceinline__ T total(T v) const { return v; }
};

struct WarpSplit {
  static constexpr int kStep = 32;
  int lane;
  __device__ __forceinline__ int first() const { return lane; }
  template <typename T> __device__ __forceinline__ T total(T v) const {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, d);
    return v;
  }
};

// simpson_even_fast_weights_dynamic at the 1-based node j of a grid of nb
// bins, the terms added in the reference's order (j <= nb: the mask is the
// caller's loop bound)
template <typename T> __device__ __forceinline__ T simpson_weight(T j, T nb) {
  T w = (j >= T(5) && j <= nb - T(3)) ? T(1) : T(0);
  w = w + ((j == T(1)) ? T(17.0 / 48.0) : T(0));
  w = w + ((j == T(2)) ? T(59.0 / 48.0) : T(0));
  w = w + ((j == T(3)) ? T(43.0 / 48.0) : T(0));
  w = w + ((j == T(4)) ? T(49.0 / 48.0) : T(0));
  const T e = nb + T(1);
  w = w + ((j == e) ? T(17.0 / 48.0) : T(0));
  w = w + ((j == e - T(1)) ? T(59.0 / 48.0) : T(0));
  w = w + ((j == e - T(2)) ? T(43.0 / 48.0) : T(0));
  w = w + ((j == e - T(3)) ? T(49.0 / 48.0) : T(0));
  return w;
}

// The F2 quadrature grid of thresholded mode i: the mode's fixed one
// (host-built, packed), or per lane from the threshold (_moving_grid,
// :332-366): Gauss-Legendre base nodes mapped onto [log(1e-5 min(T, 1)),
// log T], or the masked Simpson grid of n_pts points over [log min(1e-5,
// 1e-5 T), log T] with nb = min(floor(15 log10(T / x_lo)), n_pts - 1) bins
// (log10 as jnp.log10: log times 1/ln 10 in T; the division, the log, the
// product by 15 and the floor in the twin's order). Shared by the gamma and
// the lognormal grid F2. A compiled-in configuration's fixed grids and
// Gauss base nodes are `__constant__` tables of its unit (`grid`,
// `gauss_u`, `gauss_w`), its rule, sizes and dx constants.
template <class C, typename T> struct QuadGrid {
  int G;
  T dx = T(1), ga = T(0), ghalf = T(0), x_min = T(0), nb = T(0);
  const T* gx = nullptr;
  bool gauss;

  __device__ __forceinline__ QuadGrid(const C& c, int i, T thr) {
    gauss = c.quad != 0;
    if (!c.moving) {
      G = c.grid_n[i];
      gx = c.grid(i);
      dx = c.grid_dx[i];
    } else if (gauss) {
      G = c.n_gauss;
      const T x_lo = T(1e-5) * vmin(thr, T(1));
      ga = dlog(x_lo);
      ghalf = T(0.5) * (dlog(thr) - ga);
    } else {
      G = c.n_pts;
      const T x_lo = vmin(T(1e-5), T(1e-5) * thr);
      const T ratio = dlog(thr / x_lo) * T(0.4342944819032518);
      nb = vmin(dfloor(T(15) * ratio), T(G - 1));
      x_min = dlog(x_lo);
      dx = (dlog(thr) - x_min) / nb;
    }
  }

  // node g's abscissa and weight; false past the moving Simpson mask (every
  // later node has weight zero)
  __device__ __forceinline__ bool node(const C& c, int g, T& x,
                                       T& w) const {
    if (!c.moving) {
      x = gx[g];
      w = gx[G + g];
    } else if (gauss) {
      x = dexp(ga + ghalf * (c.gauss_u[g] + T(1)));
      w = ghalf * c.gauss_w[g];
    } else {
      const T j = T(g + 1);
      if (!(j <= nb)) return false;
      x = dexp(x_min + (j - T(1)) * dx);
      w = simpson_weight(j, nb);
    }
    return true;
  }
};

// _f2_gamma (:369-411): the gamma/exponential F2 entries p <= q < M (before
// the clamp) on a quadrature grid (QuadGrid), written to f2[tri(p, q)].
// Per node: the Poisson deltas from the Lanczos lgamma(k + 1), the top-order
// incomplete gamma (GL, or series/CF at gi_iters), the clipped downward
// recurrence and the integrand rows exp(k log x - x (1/theta)) w x^p, summed
// node by node (the Pallas body sums its [G, TB] tile with jnp.sum); nodes
// past the mask or at rem = 0 add exact zeros and are skipped. Then times dx
// and the multiplicative prefactors n^2 theta^(q-k) Gamma(q+k) / Gamma(k)^2.
// The lane's nodes and the sum of the parts follow `sp` (Serial, WarpSplit).
template <class C, typename T, class Sp>
__device__ __forceinline__ void f2_gamma_grid(const C& c, int i, T thr, T n,
                                              T theta, T k, T* f2,
                                              const Sp& sp) {
  const T tiny = Lim<T>::tiny();
  const int M = c.M;
  const T inv_theta = T(1) / theta;
  const T lgk1 = lgamma_lanczos(k + T(1));
  const T a_top = k + T(M - 1);
  const T lg_top = lgamma_lanczos(a_top);
  const T lgk = lgamma_lanczos(k);
  const T logth = dlog(theta);
  T prefs[C::kM];
  prefs[0] = (n * n) * dexp(-k * logth - lgk);
#pragma unroll
  for (int q = 1; q < C::kM; ++q)
    if (q < M) prefs[q] = prefs[q - 1] * theta * ((k + T(q)) - T(1));

  const QuadGrid<C, T> grid(c, i, thr);
  T acc[C::kFtab];
#pragma unroll
  for (int e = 0; e < C::kFtab; ++e) acc[e] = T(0);
  for (int g = sp.first(); g < grid.G; g += Sp::kStep) {
    T x, w;
    if (!grid.node(c, g, x, w)) break;  // masked: weight zero from here on
    const T rem = vmax(thr - x, T(0)) * inv_theta;
    if (!(rem > T(0))) continue;  // every gis is zero
    const T logx = dlog(x);
    const T log_rem = dlog(vmax(rem, tiny));
    T deltas[C::kM];
    deltas[0] = dexp(k * log_rem - rem - lgk1);
#pragma unroll
    for (int q = 1; q < C::kM - 1; ++q)
      if (q < M - 1) deltas[q] = deltas[q - 1] * rem / (k + T(q));
    T gi = (c.n_gl > 0) ? gammainc_gl(c, a_top, rem, lg_top)
                        : gammainc_sc<SeriesExit<C>::value>(a_top, rem, c.gi_iters,
                                                            lg_top, log_rem);
    T gis[C::kM];  // the top order, then downward (unrolled: registers)
#pragma unroll
    for (int q = C::kM - 1; q >= 0; --q) {
      if (q == M - 1) {
        gis[q] = gi;
      } else if (q < M - 1) {
        gi = vclip(gi + deltas[q], T(0), T(1));
        gis[q] = gi;
      }
    }
    const T base = dexp(k * logx - x * inv_theta) * w;
    T ypow = base;
#pragma unroll
    for (int p = 0; p < C::kM; ++p) {
      if (p < M) {
        if (p > 0) ypow = ypow * x;
#pragma unroll
        for (int q = p; q < C::kM; ++q)
          if (q < M) acc[tri<C::kM>(p, q)] = acc[tri<C::kM>(p, q)] + ypow * gis[q];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < C::kM; ++p)
#pragma unroll
    for (int q = p; q < C::kM; ++q)
      if (q < M)
        f2[tri<C::kM>(p, q)] = sp.total(acc[tri<C::kM>(p, q)]) * grid.dx * prefs[q];
}

// _f2_lognormal (:458-496): the lognormal F2 entries p <= q < M (before the
// clamp) on a quadrature grid (QuadGrid) by the exact Phi partial moments,
// written to f2[tri(p, q)]. Per node: the density fx = exp(-(log x - mu)^2 /
// (2 sigma^2)) / (x sigma sqrt(2 pi)), the partial moments exp(q mu + q^2
// sigma^2 / 2) (1 + erf(z)) / 2 at z = (log(T - x) - mu - q sigma^2) /
// (sigma sqrt 2), erf by the series/CF P(1/2, z^2) at gi_iters (n_gl = 0) or
// erf_approx, and the integrand x fx w x^p, summed node by node; nodes at
// rem = 0 add exact zeros and are skipped. Then times dx and n^2.
// exp(q mu + q^2 sigma^2 / 2) is hoisted out of the node loop. The lane's
// nodes and the sum of the parts follow `sp` (Serial, WarpSplit).
template <class C, typename T, class Sp>
__device__ __forceinline__ void f2_lognormal_grid(const C& c, int i, T thr, T n,
                                                  T mu, T sig, T* f2,
                                                  const Sp& sp) {
  const T tiny = Lim<T>::tiny();
  const int M = c.M;
  const T s2 = sig * sig;
  const T two_s2 = T(2) * s2;
  const T sig_r2 = sig * T(1.4142135623730951);  // sqrt(2)
  const T lg_half = lgamma_lanczos(T(0.5));
  const bool approx = c.n_gl > 0;
  T eq[C::kM], acc[C::kFtab];
#pragma unroll
  for (int q = 0; q < C::kM; ++q) eq[q] = dexp(T(q) * mu + T(0.5 * q * q) * s2);
#pragma unroll
  for (int e = 0; e < C::kFtab; ++e) acc[e] = T(0);
  const QuadGrid<C, T> grid(c, i, thr);
  for (int g = sp.first(); g < grid.G; g += Sp::kStep) {
    T x, w;
    if (!grid.node(c, g, x, w)) break;  // masked: weight zero from here on
    const T rem = vmax(thr - x, T(0));
    if (!(rem > T(0))) continue;  // every partial moment is zero
    const T du = dlog(vmax(x, tiny)) - mu;
    const T fx = dexp(-(du * du) / two_s2) / (x * sig * T(2.5066282746310002));
    const T logrem = dlog(vmax(rem, tiny));
    T pm[C::kM];
#pragma unroll
    for (int q = 0; q < C::kM; ++q) {
      if (q < M) {
        const T z = (logrem - mu - T(q) * s2) / sig_r2;
        const T erf_z = approx ? erf_approx(z)
                               : erf_series<SeriesExit<C>::value>(z, c.gi_iters, lg_half);
        pm[q] = eq[q] * T(0.5) * (T(1) + erf_z);
      }
    }
    T ypow = x * fx * w;
#pragma unroll
    for (int p = 0; p < C::kM; ++p) {
      if (p < M) {
        if (p > 0) ypow = ypow * x;
#pragma unroll
        for (int q = p; q < C::kM; ++q)
          if (q < M) acc[tri<C::kM>(p, q)] = acc[tri<C::kM>(p, q)] + ypow * pm[q];
      }
    }
  }
  const T n2 = n * n;
#pragma unroll
  for (int p = 0; p < C::kM; ++p)
#pragma unroll
    for (int q = p; q < C::kM; ++q)
      if (q < M) f2[tri<C::kM>(p, q)] = sp.total(acc[tri<C::kM>(p, q)]) * grid.dx * n2;
}

// The per-lane threshold of thresholded mode i: the packed constant under
// FixedThreshold; under MovingThreshold the Pallas body's thr_rows (gamma
// theta * P^-1(k, p), exponential theta * (-log1p(-p)), lognormal
// exp(mu + sigma * ndtri(p)), monodisperse theta: reference tier only),
// clamped below at 1e-18. The gamma inverse is the GL Halley one, or Newton
// on series/CF in the reference tier at n_gl = 0.
template <bool kArms, bool kRef, class C, typename T>
__device__ __forceinline__ T mode_threshold(const C& c, int i, int fam, T p1,
                                            T p2) {
  if (!kArms || !c.moving) return c.thr[i];
  T thr;
  if (kRef && fam == FAM_MONODISPERSE) {
    thr = p1;
  } else if (fam == FAM_GAMMA) {
    if constexpr (kRef) {
      thr = (c.n_gl == 0)
                ? p1 * gammaincinv_newton<SeriesExit<C>::value>(
                           p2, c.thr[i], c.newton_iters, c.thr_gi_iters)
                : p1 * gammaincinv_gl(c, p2, c.thr[i]);
    } else {
      thr = p1 * gammaincinv_gl(c, p2, c.thr[i]);
    }
  } else if (fam == FAM_EXPONENTIAL) {
    thr = p1 * c.thr[i];
  } else {
    using D = Dom<T, Sfu<C>::value>;
    thr = D::ex(D::from_ln(p1 + p2 * c.thr[i]));
  }
  return vmax(thr, T(1e-18));
}

// The coalescence body on one lane: normalized moments `mom` [n_tot] ->
// tendencies `acc` [n_tot] and the closure parameters per mode. `sp`: how
// the grid F2's nodes are shared out (Serial: this lane takes them all;
// WarpSplit: the lanes of a warp that all run this body on one box).
template <bool kArms, bool kRef, class C, typename T, class Sp = Serial>
__device__ __forceinline__ void coal_body(const C& c, const T* mom, T* acc,
                                          T (*params)[3], const Sp& sp = Sp{}) {
  constexpr bool kSfu = Sfu<C>::value;
  using D = Dom<T, kSfu>;
  const T eps = Lim<T>::eps();
  const int M = c.M;
  T mf[C::kModes * C::kM];
  T ftab[C::kModes][kArms ? C::kFtab : C::kS];
#pragma unroll
  for (int i = 0; i < C::kModes; ++i) {
    if (i >= c.n_modes) continue;
    const int fam = c.fam[i];
    const bool logn = kArms && fam == FAM_LOGNORMAL;
    T n, p1, p2;
    invert_mode<T, kArms, kSfu>(fam, mom + c.off[i], n, p1, p2);
    params[i][0] = n;
    params[i][1] = p1;
    params[i][2] = p2;
    // diagnostic moment recurrence M_{o+1} = M_o * theta * (k + o) | (o + 1)
    // | exp(mu + (2o + 1) sigma^2 / 2) | theta (monodisperse: reference tier)
    T m = n;
    mf[i * M] = n;
    each<C>(M - 1, [&](int o) {
      if (logn)
        m = m * D::ex(D::from_ln(p1 + T((2.0 * o + 1.0) * 0.5) * (p2 * p2)));
      else if (fam == FAM_EXPONENTIAL)
        m = m * p1 * T(o + 1);
      else if (kRef && fam == FAM_MONODISPERSE)
        m = m * p1;
      else
        m = m * p1 * (p2 + T(o));
      mf[i * M + o + 1] = m;
    });
    if (c.thr_flag[i]) {
      const T thr = mode_threshold<kArms, kRef>(c, i, fam, p1, p2);
      bool done = false;
      if constexpr (kRef) {
        if (c.f2kind[i] == F2_MONO) {
          // closed form (:556-568): M_p M_q where theta < T/2, else 0
          ftab[i][0] = (p1 < thr / T(2)) ? T(1) : T(0);
          done = true;
        } else if (c.f2kind[i] == F2_GRID) {
          if (logn)
            f2_lognormal_grid(c, i, thr, n, p1, p2, ftab[i], sp);
          else
            f2_gamma_grid(c, i, thr, n, p1, (fam == FAM_GAMMA) ? p2 : T(1),
                          ftab[i], sp);
          done = true;
        }
      }
      if (!done) {
        if (logn)
          f2_lognormal_window(c, thr, n, p1, p2, ftab[i]);
        else
          gis_exact<kRef>(c, thr, p1, (fam == FAM_GAMMA) ? p2 : T(1), ftab[i]);
      }
    }
  }
  if constexpr (C::kStatic) {
    // the configuration's Q/R/S terms, generated straight-line
    C::contract(mf, ftab, acc);
  } else {
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
      T v = mm;
      if (kRef && c.thr_flag[k] && c.f2kind[k] == F2_MONO)
        v = vmin(mm, (ftab[k][0] != T(0)) ? mm : T(0));
      else if (c.thr_flag[k])
        v = (kArms && (c.fam[k] == FAM_LOGNORMAL ||
                       (kRef && c.f2kind[k] == F2_GRID)))
                ? vmin(mm, ftab[k][tri<C::kM>(a, b)])
                : vmin(mm, mm * ftab[k][a + b]);
      v = (mm < eps) ? T(0) : v;
      acc[ix[0]] = acc[ix[0]] + c.wf_c[e] * v;
    }
  }
}

// _sedi_flux_rows: normalized flux -sum_k c_k M_{m+e_k}; the gamma base by
// gamma_ratio (fast_ratio), or in the reference tier at n_gl = 0 by the
// Lanczos-lgamma pair; the monodisperse ladder n theta^e, t theta (reference
// tier)
template <bool kArms, bool kRef, class C, typename T>
__device__ __forceinline__ void sedi_flux(const C& c, const T (*params)[3],
                                          T* flux) {
  // logp1 in the domain of the configuration (`Sfu`): p1^e = ex(e logp1)
  constexpr bool kSfu = Sfu<C>::value;
  using D = Dom<T, kSfu>;
  const T tiny = Lim<T>::tiny();
#pragma unroll
  for (int i = 0; i < C::kModes; ++i) {
    if (i >= c.n_modes) continue;
    const int fam = c.fam[i];
    const bool logn = kArms && fam == FAM_LOGNORMAL;
    const int np = c.nprog[i];
    const T n = params[i][0], p1 = params[i][1], p2 = params[i][2];
    const T logp1 = D::lg(vmax(p1, tiny));
    T fl[MAX_NPROG];
#pragma unroll
    for (int m = 0; m < MAX_NPROG; ++m) fl[m] = T(0);
    each<C>(c.n_vel, [&](int v) {
      const T cv = c.vel_c[v], e = c.vel_e[v];
      T e_dom = e;  // e log2(e), rounded once on the host, with kSfu
      if constexpr (kSfu) e_dom = c.vel_e2[v];
      T t = T(0);
      if (kRef && fam == FAM_GAMMA && c.n_gl == 0)
        t = n * dexp(e * logp1 + lgamma_lanczos(p2 + e) - lgamma_lanczos(p2));
      else if (fam == FAM_GAMMA)
        t = n * D::ex(e * logp1) * gamma_ratio<kSfu>(p2, e, e_dom);
      else if (fam == FAM_EXPONENTIAL)
        t = n * c.vel_g[v] * D::ex(e * logp1);
      else if (kRef && fam == FAM_MONODISPERSE)
        t = n * dexp(e * logp1);
#pragma unroll
      for (int m = 0; m < MAX_NPROG; ++m) {
        if (m >= np) continue;
        const T q = c.vel_me[3 * v + m];
        if (logn) {
          // direct closed form n exp(q mu + q^2 sigma^2 / 2)
          t = n * D::ex(D::from_ln(q * p1 + c.vel_hq2[3 * v + m] * p2 * p2));
        } else if (kRef && fam == FAM_MONODISPERSE && m > 0) {
          t = t * p1;
        } else if (m > 0) {
          t = (fam == FAM_GAMMA) ? t * p1 * ((p2 + T(m - 1)) + e) : t * p1 * q;
        }
        fl[m] = fl[m] + cv * t;
      }
    });
#pragma unroll
    for (int m = 0; m < MAX_NPROG; ++m) {
      if (m >= np) continue;
      flux[c.off[i] + m] = -fl[m];
    }
  }
}

}  // namespace cloudy
