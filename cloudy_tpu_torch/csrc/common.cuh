// What every kernel of this package shares: numeric limits, the math
// wrappers that pick the float or double routine, jnp's min/max/clip
// semantics, the Lanczos lgamma and the series/continued-fraction
// incomplete gamma of cloudy_tpu/ops/special.py, the closure inversion, the
// family tags and the copy of a packed configuration into shared memory.
//
// No fast-math: expf/logf/division stay IEEE-accurate and denormals are kept.

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace cloudy {

// The dynamic shared memory a launch takes without opting in (a kernel that
// may take more opts in per launch: `allow_smem` below).
constexpr int SMEM_NO_OPTIN = 48 * 1024;

// spec.Family
constexpr int FAM_EXPONENTIAL = 0;
constexpr int FAM_GAMMA = 1;
constexpr int FAM_LOGNORMAL = 2;
constexpr int FAM_MONODISPERSE = 3;

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
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ float dfloor(float x) { return floorf(x); }
__device__ __forceinline__ double dfloor(double x) { return ::floor(x); }
__device__ __forceinline__ double dpow(double x, double y) { return pow(x, y); }

// The elementwise functions a traced kernel function may call
// (ops/kernel_expr.py), each in the unit's type and with torch's semantics
// where it differs from C's: round is rint (half to even), sign is 0 at NaN
// and +0 at -0, remainder takes the divisor's sign, floor_divide is the
// divmod-corrected quotient (c10 div_floor_floating), sigmoid its closed
// form. IEEE routines, no approximate intrinsics: these also compile as host
// C++ in the tests (tests/test_torch_kernel_expr.py).
#define CLOUDY_MATH1(name, f32, f64)                                          \
  __device__ __forceinline__ float name(float x) { return f32(x); }          \
  __device__ __forceinline__ double name(double x) { return f64(x); }
#define CLOUDY_MATH2(name, f32, f64)                                          \
  __device__ __forceinline__ float name(float x, float y) { return f32(x, y); } \
  __device__ __forceinline__ double name(double x, double y) { return f64(x, y); }
CLOUDY_MATH1(dsin, sinf, sin)
CLOUDY_MATH1(dcos, cosf, cos)
CLOUDY_MATH1(dtan, tanf, tan)
CLOUDY_MATH1(dasin, asinf, asin)
CLOUDY_MATH1(dacos, acosf, acos)
CLOUDY_MATH1(datan, atanf, atan)
CLOUDY_MATH1(dsinh, sinhf, sinh)
CLOUDY_MATH1(dcosh, coshf, cosh)
CLOUDY_MATH1(dtanh, tanhf, tanh)
CLOUDY_MATH1(dasinh, asinhf, asinh)
CLOUDY_MATH1(dacosh, acoshf, acosh)
CLOUDY_MATH1(datanh, atanhf, atanh)
CLOUDY_MATH1(derf, erff, erf)
CLOUDY_MATH1(derfc, erfcf, erfc)
CLOUDY_MATH1(dlgamma, lgammaf, lgamma)
CLOUDY_MATH1(dexpm1, expm1f, expm1)
CLOUDY_MATH1(dlog1p, log1pf, log1p)
CLOUDY_MATH1(dexp2, exp2f, exp2)
CLOUDY_MATH1(dlog2, log2f, log2)
CLOUDY_MATH1(dlog10, log10f, log10)
CLOUDY_MATH1(dceil, ceilf, ::ceil)
CLOUDY_MATH1(dtrunc, truncf, ::trunc)
CLOUDY_MATH1(drint, rintf, ::rint)
CLOUDY_MATH2(datan2, atan2f, atan2)
CLOUDY_MATH2(dhypot, hypotf, hypot)
CLOUDY_MATH2(dcopysign, copysignf, ::copysign)
CLOUDY_MATH2(dfmod, fmodf, ::fmod)
CLOUDY_MATH2(dfmin, fminf, ::fmin)
CLOUDY_MATH2(dfmax, fmaxf, ::fmax)
CLOUDY_MATH2(dnextafter, nextafterf, ::nextafter)
#undef CLOUDY_MATH1
#undef CLOUDY_MATH2
// a template, so that a host build of this header needs an erfinv (glibc
// has none) only where a kernel function calls it
template <typename T> __device__ __forceinline__ T derfinv(T x) {
  if constexpr (sizeof(T) == sizeof(float)) return erfinvf(x);
  else return erfinv(x);
}
template <typename T> __device__ __forceinline__ T drsqrt(T x) { return T(1) / dsqrt(x); }
template <typename T> __device__ __forceinline__ T dsign(T x) {
  return T((x > T(0)) - (x < T(0)));
}
template <typename T> __device__ __forceinline__ T dsigmoid(T x) {
  return T(1) / (T(1) + dexp(-x));
}
template <typename T> __device__ __forceinline__ T dremainder(T a, T b) {
  T mod = dfmod(a, b);
  if (mod != T(0) && (b < T(0)) != (mod < T(0))) mod += b;
  return mod;
}
template <typename T> __device__ __forceinline__ T dfloordiv(T a, T b) {
  if (b == T(0)) return a / b;
  const T mod = dfmod(a, b);
  T div = (a - mod) / b;
  if (mod != T(0) && (b < T(0)) != (mod < T(0))) div -= T(1);
  if (div == T(0)) return dcopysign(T(0), a / b);
  T floordiv = dfloor(div);
  if (div - floordiv > T(0.5)) floordiv += T(1);
  return floordiv;
}

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

// More of a traced kernel function's forms, closed forms over the routines
// above with torch's semantics at 0, +-inf, NaN and the poles (its CPU
// kernels': heaviside is 0 at NaN, relu keeps -0 and NaN, angle of a real is
// pi below 0 and NaN at NaN, xlogy is NaN where y is and 0 where x is 0).
// The masks return bool, as the comparisons do. The special functions with
// series and tables (digamma, zeta, the incomplete gammas, the Bessel
// functions, log_ndtr) are in special_functions.cuh, which a unit includes
// only where its trace calls one.
template <typename T> __device__ __forceinline__ bool disnan(T x) { return x != x; }
template <typename T> __device__ __forceinline__ bool disinf(T x) {
  return dabs(x) == T(INFINITY);
}
template <typename T> __device__ __forceinline__ bool disfinite(T x) {
  return dabs(x) < T(INFINITY);
}
template <typename T> __device__ __forceinline__ bool disposinf(T x) { return x == T(INFINITY); }
template <typename T> __device__ __forceinline__ bool disneginf(T x) { return x == -T(INFINITY); }
template <typename T> __device__ __forceinline__ bool dsignbit(T x) {
  return dcopysign(T(1), x) < T(0);
}
template <typename T>
__device__ __forceinline__ T dnan_to_num(T x, T nan, T posinf, T neginf) {
  return x != x ? nan : (x == T(INFINITY) ? posinf : (x == -T(INFINITY) ? neginf : x));
}
template <typename T> __device__ __forceinline__ T dheaviside(T x, T v) {
  return x == T(0) ? v : T(x > T(0));
}
template <typename T> __device__ __forceinline__ T dfrac(T x) { return x - dtrunc(x); }
// torch.ldexp is x * 2**e
template <typename T> __device__ __forceinline__ T dldexp(T x, T e) {
  return x * dpow(T(2), e);
}
template <typename T> __device__ __forceinline__ T dangle(T x) {
  return x != x ? x : (x < T(0) ? T(3.14159265358979323846) : T(0));
}
template <typename T> __device__ __forceinline__ T drelu(T x) { return x < T(0) ? T(0) : x; }
// torch's elu kernel: (expm1(x * input_scale)) * alpha * scale at x <= 0,
// x * scale above; selu and celu are two of its settings
template <typename T>
__device__ __forceinline__ T delu(T x, T negcoef, T negiptcoef, T poscoef) {
  return x <= T(0) ? dexpm1(x * negiptcoef) * negcoef : x * poscoef;
}
template <typename T> __device__ __forceinline__ T dselu(T x) {
  const T alpha = T(1.6732632423543772848170429916717);
  const T scale = T(1.0507009873554804934193349852946);
  return delu(x, alpha * scale, T(1), scale);
}
template <typename T> __device__ __forceinline__ T dcelu(T x, T alpha, T inv_alpha) {
  return delu(x, alpha, inv_alpha, T(1));
}
template <typename T> __device__ __forceinline__ T dxlogy(T x, T y) {
  return y != y ? y : (x == T(0) ? T(0) : x * dlog(y));
}
template <typename T> __device__ __forceinline__ T dxlog1py(T x, T y) {
  return y != y ? y : (x == T(0) ? T(0) : x * dlog1p(y));
}
template <typename T> __device__ __forceinline__ T dentr(T x) {
  if (x != x) return x;
  if (x > T(0)) return -x * dlog(x);
  return x == T(0) ? T(0) : -T(INFINITY);
}
template <typename T> __device__ __forceinline__ T dlogit(T x) { return dlog(x / (T(1) - x)); }
// logit with eps: x clamped to [eps, 1 - eps] first (NaN stays)
template <typename T> __device__ __forceinline__ T dlogit(T x, T eps) {
  const T hi = T(1) - eps;
  const T z = x < eps ? eps : (x > hi ? hi : x);
  return dlog(z / (T(1) - z));
}
template <typename T> __device__ __forceinline__ T dsinc(T x) {
  if (x == T(0)) return T(1);
  const T p = T(3.14159265358979323846) * x;
  return dsin(p) / p;
}
template <typename T> __device__ __forceinline__ T dlogaddexp(T a, T b) {
  if (dabs(a) == T(INFINITY) && a == b) return a;
  const T m = vmax(a, b);
  return m + dlog1p(dexp(-dabs(a - b)));
}
template <typename T> __device__ __forceinline__ T dlogaddexp2(T a, T b) {
  if (dabs(a) == T(INFINITY) && a == b) return a;
  const T m = vmax(a, b);
  return m + dlog1p(dexp2(-dabs(a - b))) * T(1.4426950408889634074);
}
// torch.special.ndtr: (1 + erf(x / sqrt 2)) / 2
template <typename T> __device__ __forceinline__ T dndtr(T x) {
  return (T(1) + derf(x * T(0.70710678118654752440))) * T(0.5);
}

// torch.nn.functional's activations with a jax.nn counterpart, each with
// torch's own formula (its CPU kernels', not JAX's where the two differ:
// softplus switches to x past beta x > threshold, mish has no threshold,
// log_sigmoid is min(x, 0) - log1p(exp(-|x|))); the clamps keep x on a tie
// (-0 stays -0) and NaN, as torch's clamp does. A parameter is a constant
// of the emitted text, rounded to T.
template <typename T> __device__ __forceinline__ T dclamp_keep(T x, T lo, T hi) {
  const T r = x < lo ? lo : x;
  return r > hi ? hi : r;
}
template <typename T> __device__ __forceinline__ T dsoftplus(T x, T beta, T threshold) {
  return x * beta > threshold ? x : dlog1p(dexp(x * beta)) / beta;
}
template <typename T> __device__ __forceinline__ T dgelu(T x) {
  return x * T(0.5) * (T(1) + derf(x * T(0.70710678118654752440)));
}
// kBeta = M_SQRT2 * M_2_SQRTPI * 0.5, taken in double, then rounded to T
template <typename T> __device__ __forceinline__ T dgelu_tanh(T x) {
  const T beta = T(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  const T kappa = T(0.044715);
  return T(0.5) * x * (T(1) + dtanh(beta * (x + kappa * (x * x * x))));
}
template <typename T> __device__ __forceinline__ T dsilu(T x) {
  return x / (T(1) + dexp(-x));
}
template <typename T> __device__ __forceinline__ T dmish(T x) {
  return x * dtanh(dlog1p(dexp(x)));
}
// F.elu(alpha) (torch._C._nn.elu also takes scale and input_scale)
template <typename T>
__device__ __forceinline__ T delu_alpha(T x, T alpha, T scale, T input_scale) {
  return delu(x, alpha * scale, input_scale, scale);
}
template <typename T> __device__ __forceinline__ T dleaky_relu(T x, T slope) {
  return x > T(0) ? x : x * slope;
}
template <typename T> __device__ __forceinline__ T dhardtanh(T x, T lo, T hi) {
  return dclamp_keep(x, lo, hi);
}
template <typename T> __device__ __forceinline__ T drelu6(T x) {
  return dclamp_keep(x, T(0), T(6));
}
// hardsigmoid and hardswish divide by 6, as torch's CPU kernels and
// jax.nn.hard_sigmoid do, on the card as on the host (torch's CUDA kernels
// multiply by one sixth taken in float, 3e-8 off in f64)
template <typename T> __device__ __forceinline__ T dhardsigmoid(T x) {
  return dclamp_keep(x + T(3), T(0), T(6)) / T(6);
}
template <typename T> __device__ __forceinline__ T dhardswish(T x) {
  return x * dclamp_keep(x + T(3), T(0), T(6)) / T(6);
}
template <typename T> __device__ __forceinline__ T dlog_sigmoid(T x) {
  return vmin(x, T(0)) - dlog1p(dexp(-dabs(x)));
}
template <typename T> __device__ __forceinline__ T dsoftsign(T x) {
  return x / (dabs(x) + T(1));
}

// Opts a kernel into more than SMEM_NO_OPTIN bytes of dynamic shared memory
// where its launch asks for that much (host code: before the launch and
// before an occupancy query at the same size). Past the card's opt-in limit
// the attribute, and so the launch, is refused.
template <class K> inline cudaError_t allow_smem(K kern, size_t smem) {
  return smem > (size_t)SMEM_NO_OPTIN
             ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)
             : cudaSuccess;
}

// Copy the packed configuration (16-byte padded) into shared memory.
__device__ __forceinline__ void load_config(unsigned char* smem,
                                            const unsigned char* cfg,
                                            int cfg_bytes) {
  const int4* src = reinterpret_cast<const int4*>(cfg);
  int4* dst = reinterpret_cast<int4*>(smem);
  for (int w = threadIdx.x; w < cfg_bytes / 16; w += blockDim.x) dst[w] = src[w];
}

// special.lgamma: Lanczos (g = 7, n = 9), lgamma(z) = lgamma(z+1) - log z
// below 1
template <typename T> __device__ __forceinline__ T lgamma_lanczos(T x) {
  const bool shift = x < T(1);
  const T z = shift ? x + T(1) : x;
  const T zm1 = z - T(1);
  T series = T(0.99999999999980993);
  series = series + T(676.5203681218851) / (zm1 + T(1));
  series = series + T(-1259.1392167224028) / (zm1 + T(2));
  series = series + T(771.32342877765313) / (zm1 + T(3));
  series = series + T(-176.61502916214059) / (zm1 + T(4));
  series = series + T(12.507343278686905) / (zm1 + T(5));
  series = series + T(-0.13857109526572012) / (zm1 + T(6));
  series = series + T(9.9843695780195716e-6) / (zm1 + T(7));
  series = series + T(1.5056327351493116e-7) / (zm1 + T(8));
  const T t = zm1 + T(7) + T(0.5);
  const T out =
      T(0.9189385332046727) + (zm1 + T(0.5)) * dlog(t) - t + dlog(series);
  return shift ? out - dlog(vmax(x, Lim<T>::tiny())) : out;
}

// special.gammainc_impl (cloudy_tpu/ops/special.py:200-291): P(a, x) by the
// lower series below a + 1 and by the modified-Lentz continued fraction
// above it, n_iters terms each, clipped to [0, 1], zero at x <= 0. Only the
// branch the lane selects is evaluated (gammainc_impl evaluates both at safe
// arguments and keeps one). lga = lgamma(a); log_x is the caller's log of x
// (the prefactor's), x itself is clamped at 1e6.
//
// kExit: the lower series stops at the first term that leaves the sum as it
// was (total + term == total under round-to-nearest). Below a + 1 every term
// is positive and smaller than the one before (x / ap < 1), so no later term
// can change the sum either: the result is the fixed loop's, bit for bit,
// and a lane leaves the loop (a TPU lane cannot: JAX runs all n_iters,
// special.py:209-216) before its terms go subnormal. The continued fraction
// keeps its fixed count.
template <bool kExit = false, typename T>
__device__ __forceinline__ T gammainc_sc(T a, T x, int n_iters, T lga,
                                         T log_x) {
  x = vmin(x, T(1e6));
  if (!(x > T(0))) return T(0);
  T out;
  if (x < a + T(1)) {
    const T term0 = T(1) / a;
    T total = term0, term = term0, ap = a;
    for (int i = 0; i < n_iters; ++i) {
      ap = ap + T(1);
      term = term * x / ap;
      const T next = total + term;
      if (kExit && next == total) break;
      total = next;
    }
    out = total * dexp(a * log_x - x - lga);
  } else {
    const T tiny = Lim<T>::tiny() * T(1e10);
    T b = x + T(1) - a;
    T c = T(1) / tiny;
    T d = T(1) / ((dabs(b) < tiny) ? tiny : b);
    T h = d;
    for (int i = 0; i < n_iters; ++i) {
      const T fi = T(i) + T(1);
      const T an = -fi * (fi - a);
      b = b + T(2);
      d = an * d + b;
      d = (dabs(d) < tiny) ? tiny : d;
      c = b + an / c;
      c = (dabs(c) < tiny) ? tiny : c;
      d = T(1) / d;
      h = h * d * c;
    }
    out = T(1) - h * dexp(a * log_x - x - lga);
  }
  return vclip(out, T(0), T(1));
}

// Closure inversion (pallas_numerical.py::_invert_rows, :79-118) of one mode
// from its normalized moments `m`; a monodisperse mode inverts as an
// exponential one. The lognormal branch exists only with kArms.
template <typename T, bool kArms>
__device__ __forceinline__ void invert_mode(int fam, const T* m, T& n, T& p1,
                                            T& p2) {
  const T eps = Lim<T>::eps();
  const T m0 = m[0], m1 = m[1];
  if (kArms && fam == FAM_LOGNORMAL) {
    const bool valid = (m0 > eps) && (m1 > eps) && (m[2] > eps);
    const T m0s = valid ? m0 : T(1);
    const T m1s = valid ? m1 : T(1);
    const T m2s = valid ? m[2] : T(2);
    const T mu = dlog(m1s * m1s / (dpow(m0s, T(1.5)) * dpow(m2s, T(0.5))));
    const T sig2 = dlog(vmax(m0s * m2s / (m1s * m1s), T(1)));
    const T sigma = vmax(dsqrt(sig2), eps);
    const T nn = m1s / dexp(mu + T(0.5) * (sigma * sigma));
    n = valid ? nn : T(0);
    p1 = valid ? mu : T(1);
    p2 = valid ? sigma : T(1);
    return;
  }
  const bool valid = (m0 > eps) && (m1 > eps);
  const T m0s = valid ? m0 : T(1);
  const T m1s = valid ? m1 : T(1);
  if (fam == FAM_EXPONENTIAL || fam == FAM_MONODISPERSE) {
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

}  // namespace cloudy
