// Direct-quadrature coalescence kernel for Hopper (sm_90a), bound to PyTorch
// by ctypes (ops/_build.py builds this file, ops/numerical_coalescence.py
// launches it).
//
// Replaces the Pallas TPU kernel of cloudy_tpu/ops/pallas_numerical.py,
// make_pallas_numerical_fn (:166, body :216-372): normalized moments
// [n_tot, B] -> coalescence tendencies [n_tot, B] by fixed-node
// Gauss-Legendre quadrature of the Smoluchowski equation for a kernel
// *function* K(x, y): closure inversion, per-box support bounds, a
// kink-aware outer log grid of G nodes, the densities there, R by a G x G
// inner sum, the triangular Q/S integrals over per-x inner panels, and the
// gated assembly.
//
// What bounds it on this card: operations, not bytes. A box reads n_tot
// values and writes n_tot, and between them evaluates G^2 kernel values for
// R and, at each of G outer nodes, n_pi * g_inner inner nodes with two logs,
// 2 n_modes densities (an exp and a divide each) and one kernel value: at
// the bench shape (G = 96, 48 inner nodes, two gamma modes) the plain twin
// counts 3.6e5 operations per box for 48 bytes moved.
//
// What the design does about it: one thread block per box, one thread per
// outer node. Every thread inverts the closure (a few dozen operations, the
// same in each thread) and hoists the per-mode constant
// k log(theta) + lgamma(k) out of the density. Thread g builds its node
// X[g], its weight and its densities, and publishes X[g] and WX[g] F_j[g]
// in shared memory; after one barrier it runs the R sum over all G nodes
// from shared memory and the Q/S sums over its own inner nodes in
// registers. The sums over g are block reductions (warp shuffles, one
// shared-memory pass across warps) taken in a fixed order, so two launches
// agree bit for bit; the order differs from the plain twin's torch.sum, so
// the two agree to rounding and are compared row-scaled. The kernel function
// is a tag and up to three parameters (constant, linear, hydrodynamic,
// Long), compiled in as a template argument like the number of modes, so
// the inner loops carry no dispatch: read at run time instead, though
// uniform over the launch, the tag cost 14.9 % at the bench shape and 25.3 %
// with the hydrodynamic kernel on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/dispatch_compare.py). Threads past G in the last warp skip the
// loops and add exact zeros to every reduction.

#include <cmath>

#include "common.cuh"

// Build units: ops/_build.py compiles this file once per unit, all at once,
// with -DCLOUDY_UNIT=u, and links the objects; each unit instantiates one
// type at one number of modes. Without CLOUDY_UNIT the file builds
// everything.
#ifdef CLOUDY_UNIT
#define CLOUDY_IN_UNIT(u) (CLOUDY_UNIT == (u))
#else
#define CLOUDY_IN_UNIT(u) 1
#endif

namespace cloudy {

// capacities; the library exports them with the header size
// (`cloudy_numerical_layout`) and the host checks its own copy on load
constexpr int NUM_MAX_G = 256;   // outer nodes, one thread each
constexpr int NUM_MAX_NMOM = 3;  // moment orders 0..2

// kernel-function tags (ops/numerical_coalescence.py, KERNEL_TAGS)
constexpr int KT_CONSTANT = 0, KT_LINEAR = 1, KT_HYDRO = 2, KT_LONG = 3;
// Template value for "read the tag from the configuration": instantiated only
// with -DCLOUDY_RUNTIME_KTAG, by which tools/dispatch_compare.py times what
// compiling the kernel function in buys.
constexpr int KT_RUNTIME = -1;

// int32 layout of the packed configuration: a 10-slot header, then per-mode
// ints; the reals start at the byte offset in slot NH_REAL_OFF
constexpr int NH_NMODES = 0, NH_NTOT = 1, NH_NMOM = 2, NH_NPO = 3,
              NH_GOUTER = 4, NH_NPI = 5, NH_GINNER = 6, NH_KTAG = 7,
              NH_REAL_OFF = 8;
constexpr int NI_FAM = 10;
constexpr int NI_OFF = NI_FAM + MAX_MODES;
constexpr int NI_NPROG = NI_OFF + MAX_MODES;

template <typename T> struct NumConfig {
  int n_tot, n_mom, n_po, g_outer, n_pi, g_inner;
  const int* fam;
  const int* off;
  const int* nprog;
  const T* kpar;    // [3] kernel-function parameters
  const T* kink;    // [1] the kink's mass (read only when n_pi == 3)
  const T* logcut;  // [2] log of the outer cuts t and 2t (host double)
  const T* xu;      // [g_outer] GL nodes on [-1, 1]
  const T* wu;      // [g_outer] GL weights
  const T* s01;     // [g_inner] GL nodes mapped to (0, 1) (host double)
  const T* w01;     // [g_inner] halved GL weights (host double)

  __device__ __forceinline__ void bind(const unsigned char* buf) {
    const int* ip = reinterpret_cast<const int*>(buf);
    n_tot = ip[NH_NTOT];
    n_mom = ip[NH_NMOM];
    n_po = ip[NH_NPO];
    g_outer = ip[NH_GOUTER];
    n_pi = ip[NH_NPI];
    g_inner = ip[NH_GINNER];
    fam = ip + NI_FAM;
    off = ip + NI_OFF;
    nprog = ip + NI_NPROG;
    const T* rp = reinterpret_cast<const T*>(buf + ip[NH_REAL_OFF]);
    kpar = rp;
    kink = kpar + 3;
    logcut = kink + 1;
    xu = logcut + 2;
    wu = xu + g_outer;
    s01 = wu + g_outer;
    w01 = s01 + g_inner;
  }
};

// K(x, y) of kernels.py's four kernel functions; k0..k2 are the dataclass
// fields after `.normalized(norms)`
template <typename T, int KT>
__device__ __forceinline__ T kernel_value(int ktag, T k0, T k1, T k2, T x, T y) {
  const int kt = (KT == KT_RUNTIME) ? ktag : KT;
  if (kt == KT_CONSTANT) return k0;
  if (kt == KT_LINEAR) return k0 * (x + y);
  if (kt == KT_HYDRO) {
    // r = (3 x / 4 pi)^(1/3) by pow, as the reference; A = pi r^2
    const T c = T(3.0 / 4.0 / 3.141592653589793);
    const T pi = T(3.141592653589793);
    const T r1 = dpow(c * x, T(1.0 / 3.0));
    const T r2 = dpow(c * y, T(1.0 / 3.0));
    const T a1 = pi * (r1 * r1);
    const T a2 = pi * (r2 * r2);
    const T s = r1 + r2;
    return k0 * (s * s) * dabs(a1 - a2);
  }
  // Long: k0 the mass threshold, k1 the rate below it, k2 the rate above
  const bool below = (x < k0) && (y < k0);
  return below ? k1 * (x * x + y * y) : k2 * (x + y);
}

// _density_rows: the mass density of one mode at x (log x given), with the
// gamma constant cst = k log(theta) + lgamma(k) hoisted by the caller
template <typename T>
__device__ __forceinline__ T density(int fam, T amp, T p1, T p2, T cst, T x,
                                     T logx) {
  if (fam == FAM_GAMMA) {
    const T logf = (p2 - T(1)) * logx - cst - x / p1;
    return amp * dexp(logf);
  }
  if (fam == FAM_EXPONENTIAL) return amp / p1 * dexp(-x / p1);
  if (fam == FAM_LOGNORMAL) {
    const T d = logx - p1;
    return amp * dexp(-(d * d) / (T(2) * (p2 * p2))) /
           (vmax(x, Lim<T>::tiny()) * p2 * T(2.5066282746310002));
  }
  // monodisperse: the rectangular pulse of width 2 theta / 10
  return (dabs(x - p1) < p1 / T(10)) ? amp / (T(2) * p1 / T(10)) : T(0);
}

// _bounds_rows: the support bounds of one mode, (inf, 0) for an empty one
template <typename T>
__device__ __forceinline__ void mode_bounds(int fam, T n, T p1, T p2, T& lo,
                                            T& hi) {
  if (fam == FAM_EXPONENTIAL) {
    lo = p1 * T(1e-8);
    hi = p1 * T(40);
  } else if (fam == FAM_GAMMA) {
    lo = p1 * dexp(dlog(T(1e-12)) / vmax(p2, T(0.05)));
    lo = vmax(lo, p1 * T(1e-12));
    hi = p1 * (p2 + T(30) * dsqrt(p2) + T(40));
  } else if (fam == FAM_LOGNORMAL) {
    lo = dexp(p1 - T(8) * p2);
    hi = dexp(p1 + T(8) * p2);
  } else {
    lo = p1 * T(0.5);
    hi = p1 * T(2.5);
  }
  const bool active = n > T(0);
  lo = active ? lo : T(INFINITY);
  hi = active ? hi : T(0);
}

// Sum `val` over the warp in a fixed tree; lane 0 holds the total.
template <typename T> __device__ __forceinline__ T warp_sum(T val) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) val += __shfl_down_sync(0xffffffffu, val, d);
  return val;
}

template <typename T, int N, int KT>
__global__ void __launch_bounds__(NUM_MAX_G)
    numerical_kernel(const T* __restrict__ mom, T* __restrict__ out,
                     const unsigned char* __restrict__ cfg_g, int cfg_bytes,
                     long long B) {
  constexpr int NP = N * (N - 1) / 2;  // mode pairs j < k
  // reduced terms per moment order: R[j][k], S1[k], Stot[k], Q[pair]
  constexpr int PER_M = N * N + 2 * N + NP;
  constexpr int V = NUM_MAX_NMOM * PER_M;
  constexpr int MAX_WARPS = NUM_MAX_G / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T shX[NUM_MAX_G];
  __shared__ T shWF[N][NUM_MAX_G];  // WX[y] * F_j[y]
  __shared__ T shRed[V][MAX_WARPS];
  __shared__ T shTot[V];

  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  NumConfig<T> c;
  c.bind(smem);
  const T tiny = Lim<T>::tiny();
  const long long box = blockIdx.x;
  const int g = threadIdx.x;
  const int G = c.n_po * c.g_outer;
  const bool active = g < G;
  const T k0 = c.kpar[0], k1 = c.kpar[1], k2 = c.kpar[2];
  const int ktag = reinterpret_cast<const int*>(smem)[NH_KTAG];

  // ---- closure inversion and support bounds (the same in every thread) ----
  int fam[N];
  T pn[N], p1[N], p2[N], cst[N];
  T x_lo = T(INFINITY), x_hi = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    fam[j] = c.fam[j];
    T m[NUM_MAX_NMOM];
#pragma unroll
    for (int q = 0; q < NUM_MAX_NMOM; ++q)
      m[q] = (q < c.nprog[j]) ? mom[(c.off[j] + q) * B + box] : T(0);
    invert_mode<T, true>(fam[j], m, pn[j], p1[j], p2[j]);
    cst[j] = (fam[j] == FAM_GAMMA) ? p2[j] * dlog(p1[j]) + lgamma_lanczos(p2[j])
                                   : T(0);
    T lo, hi;
    mode_bounds(fam[j], pn[j], p1[j], p2[j], lo, hi);
    x_lo = vmin(x_lo, lo);
    x_hi = vmax(x_hi, hi);
  }
  x_lo = vmin(x_lo, T(1e30));
  x_hi = vmax(x_hi, T(1e-30));
  x_lo = vmax(vmin(x_lo, x_hi * T(1e-12)), tiny);
  x_hi = vmax(T(2) * x_hi, T(4) * tiny);

  // ---- this thread's outer node: x = exp(u), GL in u, one panel per smooth
  // piece of the kernel (an empty panel collapses to zero weight) -----------
  const T lo_l = dlog(x_lo), hi_l = dlog(x_hi);
  T X = T(1), WX = T(0);
  if (active) {
    const int p = g / c.g_outer;
    const int i = g - p * c.g_outer;
    const bool cut = c.n_po > 1;
    const T e1 = cut ? vclip(c.logcut[0], lo_l, hi_l) : hi_l;
    const T e2 = cut ? vclip(c.logcut[1], lo_l, hi_l) : hi_l;
    const T a = (p == 0) ? lo_l : ((p == 1) ? e1 : e2);
    const T b = (p == 0) ? e1 : ((p == 1) ? e2 : hi_l);
    const T h = T(0.5) * (b - a);
    X = dexp(a + h * (c.xu[i] + T(1)));
    WX = h * c.wu[i] * X;
  }
  const T logX = dlog(vmax(X, tiny));

  // ---- densities at the outer node, and the weighting fractions -----------
  T F[N], wfrac[N];
  {
    T NF[N], denom = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      F[j] = density(fam[j], pn[j], p1[j], p2[j], cst[j], X, logX);
      NF[j] = density(fam[j], T(1), p1[j], p2[j], cst[j], X, logX);
      denom = (j == 0) ? NF[0] : denom + NF[j];
    }
    T run = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      run = run + NF[j];
      wfrac[j] = (denom == T(0)) ? T(0) : run / denom;
    }
  }
  shX[g] = X;
#pragma unroll
  for (int j = 0; j < N; ++j) shWF[j][g] = WX * F[j];
  __syncthreads();

  T A[N], Gkk[N], Gq[NP > 0 ? NP : 1];
#pragma unroll
  for (int j = 0; j < N; ++j) A[j] = Gkk[j] = T(0);
#pragma unroll
  for (int q = 0; q < NP; ++q) Gq[q] = T(0);

  if (active) {
    // ---- R: the inner integral of K(x, y) f_j(y) on the same grid ---------
    for (int y = 0; y < G; ++y) {
      const T K = kernel_value<T, KT>(ktag, k0, k1, k2, X, shX[y]);
#pragma unroll
      for (int j = 0; j < N; ++j) A[j] = A[j] + shWF[j][y] * K;
    }

    // ---- Q and S: the triangular inner integrals, y = s x; with a kink t
    // the inner panels split at s = t / x and 1 - t / x ----------------------
    T c1 = T(1), c2 = T(1);  // no kink: one panel [0, 1]
    if (c.n_pi == 3) {
      const T t = c.kink[0];
      const T b1 = vclip(t / X, T(0), T(1));
      const T b2 = vclip(T(1) - t / X, T(0), T(1));
      c1 = vmin(b1, b2);
      c2 = vmax(b1, b2);
    }
#pragma unroll 1
    for (int p = 0; p < c.n_pi; ++p) {
      const T a = (p == 0) ? T(0) : ((p == 1) ? c1 : c2);
      const T b = (p == 0) ? c1 : ((p == 1) ? c2 : T(1));
      const T ba = b - a;
      for (int i = 0; i < c.g_inner; ++i) {
        const T s = a + ba * c.s01[i];
        const T w = ba * c.w01[i];
        const T XR = X * (T(1) - s), XS = X * s;
        const T lr = dlog(vmax(XR, tiny));
        const T ls = dlog(vmax(XS, tiny));
        T D[N], E[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          D[j] = density(fam[j], pn[j], p1[j], p2[j], cst[j], XR, lr);
          E[j] = density(fam[j], pn[j], p1[j], p2[j], cst[j], XS, ls);
        }
        const T KW = T(0.5) * w * kernel_value<T, KT>(ktag, k0, k1, k2, XR, XS);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          Gkk[j] = Gkk[j] + KW * D[j] * E[j];
#pragma unroll
          for (int k = j + 1; k < N; ++k)
            Gq[j + k - 1] = Gq[j + k - 1] + KW * (D[j] * E[k] + D[k] * E[j]);
        }
      }
    }
  }

  // ---- the sums over the outer nodes: each term reduced over the warp,
  // then across the warps in index order --------------------------------
  const int lane = g & 31, warp = g >> 5;
  const int n_warps = blockDim.x >> 5;
  {
    T Bm = WX;  // B_m = WX x^m; C_m = B_m x (the inner Jacobian)
#pragma unroll
    for (int m = 0; m < NUM_MAX_NMOM; ++m) {
      if (m < c.n_mom) {
        if (m == 1) Bm = WX * X;
        if (m == 2) Bm = WX * (X * X);
        const T Cm = Bm * X;
        const int v0 = m * PER_M;
#pragma unroll
        for (int j = 0; j < N; ++j) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const T r = warp_sum(active ? Bm * F[k] * A[j] : T(0));
            if (lane == 0) shRed[v0 + j * N + k][warp] = r;
          }
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const T s1 = warp_sum(active ? Cm * wfrac[k] * Gkk[k] : T(0));
          const T st = warp_sum(active ? Cm * Gkk[k] : T(0));
          if (lane == 0) {
            shRed[v0 + N * N + k][warp] = s1;
            shRed[v0 + N * N + N + k][warp] = st;
          }
        }
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const T qq = warp_sum(active ? Cm * Gq[q] : T(0));
          if (lane == 0) shRed[v0 + N * N + 2 * N + q][warp] = qq;
        }
      }
    }
  }
  __syncthreads();
  for (int v = g; v < c.n_mom * PER_M; v += blockDim.x) {
    T tot = shRed[v][0];
    for (int w = 1; w < n_warps; ++w) tot = tot + shRed[v][w];
    shTot[v] = tot;
  }
  __syncthreads();

  // ---- gated assembly: thread o writes prognostic moment o ---------------
  if (g < c.n_tot) {
    int k = 0;
#pragma unroll
    for (int j = 1; j < N; ++j)
      if (g >= c.off[j]) k = j;
    const int m = g - c.off[k];
    const T* t = shTot + m * PER_M;
    T acc = t[N * N + k];  // S1[m][k]
    for (int j = 0; j < N; ++j) acc = acc - t[j * N + k];  // R[m][j][k]
    for (int j = 0; j < k; ++j) acc = acc + t[N * N + 2 * N + j + k - 1];  // Q
    if (k > 0)  // S2[m][k-1] = Stot - S1
      acc = acc + (t[N * N + N + k - 1] - t[N * N + k - 1]);
    out[g * B + box] = acc;
  }
}

template <typename T, int N>
int launch_numerical(const void* mom, void* out, const void* cfg,
                     int cfg_bytes, long long B, int g_total, int ktag,
                     void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes > CFG_MAX_BYTES || cfg_bytes % 16 != 0 ||
      g_total < 1 || g_total > NUM_MAX_G || B < 1 || B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int threads = (g_total + 31) / 32 * 32;
  void (*kern)(const T*, T*, const unsigned char*, int, long long);
#ifdef CLOUDY_RUNTIME_KTAG
  if (ktag < KT_CONSTANT || ktag > KT_LONG) return (int)cudaErrorInvalidValue;
  kern = numerical_kernel<T, N, KT_RUNTIME>;
#else
  switch (ktag) {
    case KT_CONSTANT: kern = numerical_kernel<T, N, KT_CONSTANT>; break;
    case KT_LINEAR: kern = numerical_kernel<T, N, KT_LINEAR>; break;
    case KT_HYDRO: kern = numerical_kernel<T, N, KT_HYDRO>; break;
    case KT_LONG: kern = numerical_kernel<T, N, KT_LONG>; break;
    default: return (int)cudaErrorInvalidValue;
  }
#endif
  kern<<<(unsigned)B, threads, cfg_bytes, (cudaStream_t)stream>>>(
      (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B);
  return (int)cudaGetLastError();
}

}  // namespace cloudy

#define CLOUDY_NUMERICAL_ENTRY(name, T, N)                                   \
  int name(const void* mom, void* out, const void* cfg, int cfg_bytes,       \
           long long B, int g_total, int ktag, void* stream) {               \
    return cloudy::launch_numerical<T, N>(mom, out, cfg, cfg_bytes, B,       \
                                          g_total, ktag, stream);            \
  }

extern "C" {

#if CLOUDY_IN_UNIT(0)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f32_n1, float, 1)

// The packed configuration's capacities and header size, for the host to
// check against its own (ops/numerical_coalescence.py, LAYOUT).
int cloudy_numerical_layout(int* out) {
  const int v[] = {cloudy::MAX_MODES, cloudy::NUM_MAX_G, cloudy::NUM_MAX_NMOM,
                   cloudy::CFG_MAX_BYTES, cloudy::NI_FAM};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 5;
}
#endif

#if CLOUDY_IN_UNIT(1)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f32_n2, float, 2)
#endif

#if CLOUDY_IN_UNIT(2)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f32_n3, float, 3)
#endif

#if CLOUDY_IN_UNIT(3)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f64_n1, double, 1)
#endif

#if CLOUDY_IN_UNIT(4)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f64_n2, double, 2)
#endif

#if CLOUDY_IN_UNIT(5)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f64_n3, double, 3)
#endif

}  // extern "C"
