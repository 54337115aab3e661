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
// outer node (numerical_kernel; quad_kernel below strides the nodes over its
// block). Every thread inverts the closure (a few dozen operations, the
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
// Long; any other kernel function is traced on the host into the device
// function cloudy_kernel_gen and built with CLOUDY_KERNEL_GEN into a unit
// of its own, tag KT_GEN), compiled in as a template argument like the
// number of modes, so
// the inner loops carry no dispatch: read at run time instead, though
// uniform over the launch, the tag cost 14.9 % at the bench shape and 25.3 %
// with the hydrodynamic kernel on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/dispatch_compare.py). Threads past G in the last warp skip the
// loops and add exact zeros to every reduction.
//
// That is numerical_kernel, kept as the same-call yardstick. The kernel the
// wrapper launches, quad_kernel, keeps its layout and sums and takes each
// inner node off the divide and log paths, which held most of its time:
// the densities run in base 2 on the SFU in f32 (ex2/lg2, IEEE exp/log in
// f64) with every per-mode divide and constant log hoisted per box, in f64
// the logs of s and 1 - s come from host tables where a panel starts at 0
// or ends at 1, and for the constant, linear and Long kernels R is a few
// block sums of WX F_j y^m instead of the G x G loop (the hydrodynamic
// kernel keeps the loop, each node's radius computed once). Its outer nodes
// are strided over a block of at most NUM_BLOCK threads, so the node count
// is bounded by the configuration alone: thread g takes nodes g,
// g + blockDim, ... in passes, each pass's terms summed over the warp by the
// fixed tree and added to the warp's column in that order (one node per
// thread: the sums numerical_kernel takes). The passes cost the bench's
// one-pass launch 12 % (64 registers against 48 before them, on an NVIDIA
// H100 80GB HBM3 at 700 W; a one-pass instance known at compile time took
// 61 and no less time: PERF.md).
//
// The library holds both bodies at 1-3 modes with the four tags. A
// configuration of more modes, or a traced kernel function, runs quad_kernel
// from a unit built at first use (ops/codegen.py `numerical_unit`): this
// file included with CLOUDY_UNIT -1 (every template, no prebuilt instance or
// entry point), then CLOUDY_NUMERICAL_UNIT_ENTRY; a traced unit includes its
// cfg.cuh first and holds the KT_GEN arm alone. Its cfg.cuh holds the traced
// K, cloudy_kernel_gen, and K's factored form (ops/kernel_expr.py `factor`):
// K(x, y) = sum_i f_i(x) g_i(y) + r(x, y), the separable terms split off
// through +, -, and products with (quotients by) constants and one-variable
// factors, never a product of sums expanded. R takes the separable terms as
// block sums, as the tagged arms do: the node pass adds each node's
// g_i(y) WX F_j(y) to the warp's sums (cloudy_gen_y) and A_j(X) = sum_i
// f_i(X) S_ij (cloudy_gen_x); only the remainder r keeps a G x G loop, over
// a node table of the y values it reads (tabled once per node) and WX F_j,
// its x values in registers (cloudy_gen_pair). A separable K (a kernel
// tensor) has no G x G loop (quad_node_bytes 0). Q/S calls the whole K at
// (XR, XS): no node is shared across its pairs.

#include <cmath>
#include <type_traits>

#include "common.cuh"

// Build units: ops/_build.py compiles this file once per unit, all at once,
// with -DCLOUDY_UNIT=u, and links the objects; each unit instantiates one
// body in one type at one number of modes (units 0-5 quad_kernel, 6-11
// numerical_kernel). Without CLOUDY_UNIT the file builds everything; with
// CLOUDY_UNIT -1, no instance and no entry point.
#ifdef CLOUDY_UNIT
#define CLOUDY_IN_UNIT(u) (CLOUDY_UNIT == (u))
#else
#define CLOUDY_IN_UNIT(u) 1
#endif

namespace cloudy {

// The prebuilt library's modes (and the least per-mode stride of the packed
// configuration: `num_stride`), the moment orders of a mode, the threads of
// a quad_kernel block and the outer nodes of a numerical_kernel block (one
// thread each); the library exports the layout's with the header size
// (`cloudy_numerical_layout`, a unit `cloudy_numerical_unit_layout`) and the
// host checks its own copy on load
constexpr int NUM_MAX_MODES = 3;
constexpr int NUM_MAX_NMOM = 3;  // moment orders 0..2
constexpr int NUM_BLOCK = 256;
constexpr int NUM_MAX_G = NUM_BLOCK;
constexpr int NUM_MAX_WARPS = NUM_BLOCK / 32;

// kernel-function tags (ops/numerical_coalescence.py, KERNEL_TAGS); KT_GEN
// is any other kernel function, traced on the host into cloudy_kernel_gen
// (ops/kernel_expr.py) and built into a unit of its own with
// CLOUDY_KERNEL_GEN defined (codegen.numerical_unit): the library and the
// other units have no KT_GEN arm.
constexpr int KT_CONSTANT = 0, KT_LINEAR = 1, KT_HYDRO = 2, KT_LONG = 3, KT_GEN = 4;
// A traced unit's factored form (its cfg.cuh, ops/kernel_expr.py `factor`):
// K(x, y) = sum_i f_i(x) g_i(y) + r(x, y), with GEN_TERMS separable terms
// and a remainder r (GEN_REM) that reads GEN_XV values of x and GEN_YV
// tabled values of y; none outside a traced unit.
#ifdef CLOUDY_KERNEL_GEN
constexpr int GEN_TERMS = kGenTerms, GEN_XV = kGenXValues, GEN_YV = kGenYValues;
constexpr bool GEN_REM = kGenRemainder;
#else
constexpr int GEN_TERMS = 0, GEN_XV = 0, GEN_YV = 0;
constexpr bool GEN_REM = false;
#endif
// Template value for "read the tag from the configuration": instantiated only
// with -DCLOUDY_RUNTIME_KTAG, by which tools/dispatch_compare.py times what
// compiling the kernel function in buys.
constexpr int KT_RUNTIME = -1;

// int32 layout of the packed configuration: a 10-slot header, then per-mode
// ints (`kStride` slots each: NUM_MAX_MODES, or the number of modes past
// it); the reals start at the byte offset in slot NH_REAL_OFF
constexpr int NH_NMODES = 0, NH_NTOT = 1, NH_NMOM = 2, NH_NPO = 3,
              NH_GOUTER = 4, NH_NPI = 5, NH_GINNER = 6, NH_KTAG = 7,
              NH_REAL_OFF = 8;
constexpr int NI_FAM = 10;

template <int N> __host__ __device__ constexpr int num_stride() {
  return N > NUM_MAX_MODES ? N : NUM_MAX_MODES;
}

template <typename T, int kStride = NUM_MAX_MODES> struct NumConfig {
  static constexpr int NI_OFF = NI_FAM + kStride;
  static constexpr int NI_NPROG = NI_OFF + kStride;
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
  // [g_inner] log s01 and log(1 - s01) of the rounded s01 (host double,
  // rounded once): packed, and read by quad_kernel, in f64 only
  const T* ls01;
  const T* l1m01;

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
    ls01 = w01 + g_inner;
    l1m01 = ls01 + g_inner;
  }
};

// The hydrodynamic kernel from the radii r = (3 x / 4 pi)^(1/3) (by pow, as
// the reference) of its two masses: k0 (r1 + r2)^2 |pi r1^2 - pi r2^2|
constexpr double HYDRO_C = 3.0 / 4.0 / 3.141592653589793;
template <typename T> __device__ __forceinline__ T hydro_radius(T x) {
  return dpow(T(HYDRO_C) * x, T(1.0 / 3.0));
}
template <typename T> __device__ __forceinline__ T hydro_value(T k0, T r1, T r2) {
  const T pi = T(3.141592653589793);
  const T a1 = pi * (r1 * r1);
  const T a2 = pi * (r2 * r2);
  const T s = r1 + r2;
  return k0 * (s * s) * dabs(a1 - a2);
}

// K(x, y) of kernels.py's four kernel functions; k0..k2 are the dataclass
// fields after `.normalized(norms)`
template <typename T, int KT>
__device__ __forceinline__ T kernel_value(int ktag, T k0, T k1, T k2, T x, T y) {
#ifdef CLOUDY_KERNEL_GEN
  if constexpr (KT == KT_GEN) return cloudy_kernel_gen<T>(x, y);
#endif
  const int kt = (KT == KT_RUNTIME) ? ktag : KT;
  if (kt == KT_CONSTANT) return k0;
  if (kt == KT_LINEAR) return k0 * (x + y);
  if (kt == KT_HYDRO) return hydro_value(k0, hydro_radius(x), hydro_radius(y));
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

// The slot of mode pair j < k among the N (N - 1) / 2 pairs, in the order
// (0, 1), (0, 2), ..., (1, 2), ...: for N <= 3 it is j + k - 1.
template <int N> __host__ __device__ constexpr int pair_index(int j, int k) {
  return j * (2 * N - j - 1) / 2 + (k - j - 1);
}

// The terms the gated assembly reduces over the outer nodes, per moment
// order: R[j][k], S1[k], Stot[k], Q[pair].
template <int N> struct Terms {
  static constexpr int NP = N * (N - 1) / 2;  // mode pairs j < k
  static constexpr int PER_M = N * N + 2 * N + NP;
  static constexpr int V = NUM_MAX_NMOM * PER_M;
};

// Adds one outer node's terms, each summed over the warp in a fixed tree, to
// the warp's column of `red` (lane 0 adds; it zeroed the column at the
// kernel's start). Every thread of the warp calls it.
template <typename T, int N, class Cf>
__device__ __forceinline__ void add_warp_terms(const Cf& c, int lane, int warp,
                                               bool active, T X, T WX, const T* F,
                                               const T* wfrac, const T* A,
                                               const T* Gkk, const T* Gq,
                                               T (*red)[NUM_MAX_WARPS]) {
  using Tm = Terms<N>;
  T Bm = WX;  // B_m = WX x^m; C_m = B_m x (the inner Jacobian)
#pragma unroll
  for (int m = 0; m < NUM_MAX_NMOM; ++m) {
    if (m < c.n_mom) {
      if (m == 1) Bm = WX * X;
      if (m == 2) Bm = WX * (X * X);
      const T Cm = Bm * X;
      T (*r)[NUM_MAX_WARPS] = red + m * Tm::PER_M;
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const T v = warp_sum(active ? Bm * F[k] * A[j] : T(0));
          if (lane == 0) r[j * N + k][warp] = r[j * N + k][warp] + v;
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const T s1 = warp_sum(active ? Cm * wfrac[k] * Gkk[k] : T(0));
        const T st = warp_sum(active ? Cm * Gkk[k] : T(0));
        if (lane == 0) {
          r[N * N + k][warp] = r[N * N + k][warp] + s1;
          r[N * N + N + k][warp] = r[N * N + N + k][warp] + st;
        }
      }
#pragma unroll
      for (int q = 0; q < Tm::NP; ++q) {
        const T qq = warp_sum(active ? Cm * Gq[q] : T(0));
        if (lane == 0) r[N * N + 2 * N + q][warp] = r[N * N + 2 * N + q][warp] + qq;
      }
    }
  }
}

// The warps' columns of `red` summed in index order (a fixed order: two
// launches agree bit for bit), then the gated assembly: thread o writes
// prognostic moment o. Every thread of the block calls it.
template <typename T, int N, class Cf>
__device__ __forceinline__ void assemble(const Cf& c, int g, T (*red)[NUM_MAX_WARPS],
                                         T* tot, T* __restrict__ out, long long B,
                                         long long box) {
  using Tm = Terms<N>;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();
  for (int v = g; v < c.n_mom * Tm::PER_M; v += blockDim.x) {
    T t = red[v][0];
    for (int w = 1; w < n_warps; ++w) t = t + red[v][w];
    tot[v] = t;
  }
  __syncthreads();
  for (int o = g; o < c.n_tot; o += blockDim.x) {
    int k = 0;
#pragma unroll
    for (int j = 1; j < N; ++j)
      if (o >= c.off[j]) k = j;
    const int m = o - c.off[k];
    const T* t = tot + m * Tm::PER_M;
    T acc = t[N * N + k];  // S1[m][k]
    for (int j = 0; j < N; ++j) acc = acc - t[j * N + k];  // R[m][j][k]
    for (int j = 0; j < k; ++j) acc = acc + t[N * N + 2 * N + pair_index<N>(j, k)];  // Q
    if (k > 0)  // S2[m][k-1] = Stot - S1
      acc = acc + (t[N * N + N + k - 1] - t[N * N + k - 1]);
    out[o * B + box] = acc;
  }
}

// Zeroes this warp's column of `red` (lane 0, which alone adds to it).
template <typename T, int N>
__device__ __forceinline__ void zero_terms(int lane, int warp, T (*red)[NUM_MAX_WARPS]) {
  if (lane == 0) {
    for (int v = 0; v < Terms<N>::V; ++v) red[v][warp] = T(0);
  }
}

template <typename T, int N, int KT>
__global__ void __launch_bounds__(NUM_MAX_G)
    numerical_kernel(const T* __restrict__ mom, T* __restrict__ out,
                     const unsigned char* __restrict__ cfg_g, int cfg_bytes,
                     long long B) {
  constexpr int NP = N * (N - 1) / 2;  // mode pairs j < k
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T shX[NUM_MAX_G];
  __shared__ T shWF[N][NUM_MAX_G];  // WX[y] * F_j[y]
  __shared__ T red[Terms<N>::V][NUM_MAX_WARPS];
  __shared__ T tot[Terms<N>::V];

  load_config(smem, cfg_g, cfg_bytes);
  zero_terms<T, N>(threadIdx.x & 31, threadIdx.x >> 5, red);
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
            Gq[pair_index<N>(j, k)] =
                Gq[pair_index<N>(j, k)] + KW * (D[j] * E[k] + D[k] * E[j]);
        }
      }
    }
  }

  add_warp_terms<T, N>(c, g & 31, g >> 5, active, X, WX, F, wfrac, A, Gkk, Gq, red);
  assemble<T, N>(c, g, red, tot, out, B, box);
}

// ---------------------------------------------------------------------------
// quad_kernel: the kernel the wrapper launches (the file's header says what
// it changes against numerical_kernel above, the wrapper's `_direct`).
// ---------------------------------------------------------------------------

// The exp/log domain of quad_kernel's densities: Dom<T, true> of
// common.cuh, base 2 on the SFU in f32 (lg2.approx / ex2.approx, subnormals
// kept: no .ftz; a relative error near 2^-22, far inside the f32 tolerance
// against the twin), natural IEEE log/exp in f64. `kFromLn` turns a natural
// log, or a constant that multiplies one, into the domain; `kToLn` turns the
// domain's log back.

// One mode's density (`_density_rows`) in the domain `D` (Dom), its
// divides and constant logs hoisted per box: at x, with L the domain log of
// max(x, tiny), the density is s ex(e):
//   gamma         e = (k - 1) L - (k log theta + lgamma k) kFromLn
//                     - x kFromLn / theta,                           s = n
//   exponential   e = -x kFromLn / theta,                            s = n / theta
//   lognormal     e = -d^2 kFromLn / (2 sigma^2) - L,
//                 d = L kToLn - mu (the 1 / x is the - L),           s = n / (sigma sqrt(2 pi))
//   monodisperse  s where |x - theta| < theta / 10, else 0,          s = n / (2 theta / 10)
// `unit` is s at n = 1 (the weighting fractions' normed density).
template <typename T, class D> struct ModeDensity {
  int fam;
  T a, c, r, mu, q, h, s, unit;

  __device__ __forceinline__ void init(int fam_, T n, T p1, T p2) {
    fam = fam_;
    a = p2 - T(1);
    c = r = q = h = T(0);
    mu = p1;
    if (fam == FAM_GAMMA) {
      c = (p2 * dlog(p1) + lgamma_lanczos(p2)) * D::kFromLn;
      r = D::kFromLn / p1;
      unit = T(1);
    } else if (fam == FAM_EXPONENTIAL) {
      r = D::kFromLn / p1;
      unit = T(1) / p1;
    } else if (fam == FAM_LOGNORMAL) {
      q = D::kFromLn / (T(2) * (p2 * p2));
      unit = T(1) / (p2 * T(2.5066282746310002));
    } else {
      h = p1 / T(10);
      unit = T(1) / (T(2) * p1 / T(10));
    }
    s = n * unit;
  }

  // ex(e) at x (1 or 0 for the monodisperse pulse)
  __device__ __forceinline__ T shape(T x, T L) const {
    if (fam == FAM_GAMMA) return D::ex(a * L - c - x * r);
    if (fam == FAM_EXPONENTIAL) return D::ex(-x * r);
    if (fam == FAM_LOGNORMAL) {
      const T d = L * D::kToLn - mu;
      return D::ex(-(d * d) * q - L);
    }
    return (dabs(x - mu) < h) ? T(1) : T(0);
  }
};

// Sums of V per-thread values over the block, in a fixed order: each
// warp's shuffle tree into `part` (block_partials, which every thread of the
// block calls), then the warps in index order (block_total, read where a sum
// is needed, so that no thread holds the V totals in registers across the
// node loop).
template <typename T, int V>
__device__ __forceinline__ void block_partials(const T* v, int lane, int warp,
                                               T (*part)[NUM_MAX_WARPS]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const T r = warp_sum(v[k]);
    if (lane == 0) part[k][warp] = r;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T block_total(const T (*part)[NUM_MAX_WARPS], int k,
                                         int n_warps) {
  T t = part[k][0];
  for (int w = 1; w < n_warps; ++w) t = t + part[k][w];
  return t;
}

// Whether R runs the G x G loop over a node table in shared memory (the
// hydrodynamic kernel) instead of block sums alone.
__host__ __device__ constexpr bool node_table(int kt) { return kt == KT_HYDRO; }

// The dynamic shared memory of a quad_kernel launch past its configuration:
// the hydrodynamic kernel's node table, each outer node's radius and WX F_j
// (the G x G loop reads them all); a traced kernel's with a remainder, each
// node's GEN_YV tabled y values and WX F_j; none otherwise.
template <typename T, int N>
constexpr size_t quad_node_bytes(int ktag, int g_total) {
  if (ktag == KT_HYDRO) return (size_t)(N + 1) * g_total * sizeof(T);
  if (ktag == KT_GEN && GEN_REM) return (size_t)(N + GEN_YV) * g_total * sizeof(T);
  return 0;
}

template <typename T, int N, int KT>
__global__ void __launch_bounds__(NUM_BLOCK)
    quad_kernel(const T* __restrict__ mom, T* __restrict__ out,
                const unsigned char* __restrict__ cfg_g, int cfg_bytes,
                long long B) {
  constexpr int NP = N * (N - 1) / 2;  // mode pairs j < k
  using D = Dom<T, true>;
  // the inner nodes' log tables, in f64 only: in f32 an inner node's
  // lg2.approx is quicker than the table read and its offset (measured on
  // an H100 80GB HBM3 at 700 W, PERF.md)
  constexpr bool kTables = std::is_same<T, double>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[Terms<N>::V][NUM_MAX_WARPS];
  __shared__ T tot[Terms<N>::V];

  load_config(smem, cfg_g, cfg_bytes);
  const int g = threadIdx.x;
  const int lane = g & 31, warp = g >> 5;
  const int n_warps = blockDim.x >> 5;
  zero_terms<T, N>(lane, warp, red);
  __syncthreads();
  NumConfig<T, num_stride<N>()> c;
  c.bind(smem);
  const T tiny = Lim<T>::tiny();
  const long long box = blockIdx.x;
  const int G = c.n_po * c.g_outer;
  // passes over the outer nodes: thread g takes node g + p blockDim.x
  const int n_pass = (G + blockDim.x - 1) / blockDim.x;
  const T k0 = c.kpar[0], k1 = c.kpar[1], k2 = c.kpar[2];
  const int kt = (KT == KT_RUNTIME) ? reinterpret_cast<const int*>(smem)[NH_KTAG] : KT;
  // node table (hydrodynamic: each node's radius; traced: its GEN_YV
  // tabled y values, value k at k G + node), then WX F_j, after the
  // configuration (quad_node_bytes)
  T* shR = reinterpret_cast<T*>(smem + cfg_bytes);
  T* shWF = shR + (KT == KT_GEN ? GEN_YV : 1) * G;

  // ---- closure inversion, per-mode constants and support bounds (the same
  // in every thread) --------------------------------------------------------
  ModeDensity<T, D> md[N];
  T x_lo = T(INFINITY), x_hi = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int fam = c.fam[j];
    T m[NUM_MAX_NMOM], n, p1, p2;
#pragma unroll
    for (int q = 0; q < NUM_MAX_NMOM; ++q)
      m[q] = (q < c.nprog[j]) ? mom[(c.off[j] + q) * B + box] : T(0);
    invert_mode<T, true>(fam, m, n, p1, p2);
    md[j].init(fam, n, p1, p2);
    T lo, hi;
    mode_bounds(fam, n, p1, p2, lo, hi);
    x_lo = vmin(x_lo, lo);
    x_hi = vmax(x_hi, hi);
  }
  x_lo = vmin(x_lo, T(1e30));
  x_hi = vmax(x_hi, T(1e-30));
  x_lo = vmax(vmin(x_lo, x_hi * T(1e-12)), tiny);
  x_hi = vmax(T(2) * x_hi, T(4) * tiny);
  const T lo_l = dlog(x_lo), hi_l = dlog(x_hi);
  const T L_tiny = D::lg(tiny);

  // outer node gg: x = exp(u), GL in u, one panel per smooth piece of the
  // kernel (an empty panel collapses to zero weight), as numerical_kernel;
  // (1, 0) past G
  const auto node = [&](int gg, T& X, T& WX) {
    X = T(1);
    WX = T(0);
    if (gg < G) {
      const int p = gg / c.g_outer;
      const int i = gg - p * c.g_outer;
      const bool cut = c.n_po > 1;
      const T e1 = cut ? vclip(c.logcut[0], lo_l, hi_l) : hi_l;
      const T e2 = cut ? vclip(c.logcut[1], lo_l, hi_l) : hi_l;
      const T a = (p == 0) ? lo_l : ((p == 1) ? e1 : e2);
      const T b = (p == 0) ? e1 : ((p == 1) ? e2 : hi_l);
      const T h = T(0.5) * (b - a);
      X = dexp(a + h * (c.xu[i] + T(1)));
      WX = h * c.wu[i] * X;
    }
  };

  // ---- R's sums over the nodes: A_j(X) = sum_y K(X, y) WX[y] F_j[y] --------
  // piecewise polynomial K: the sum over y is a few block sums of
  // WX F_j y^m, per mode j:
  //   constant  k0 S0;  linear  k0 (X S0 + S1);
  //   Long      X < t: k1 (X^2 Sb0 + Sb2) + k2 (X Sa0 + Sa1),
  //             else:  k2 (X (Sb0 + Sa0) + (Sb1 + Sa1)),
  //   Sb over the nodes below the threshold t = k0, Sa over the rest; each
  //   thread adds its nodes' values in pass order first.
  // The hydrodynamic kernel keeps the G x G loop over every node's radius
  // and WX F_j, published here. A traced kernel function (KT_GEN) takes its
  // separable terms as block sums of g_i(y) WX F_j(y), A_j(X) = sum_i
  // f_i(X) S_ij, and loops over the pairs for its remainder alone, from
  // each node's tabled y values and WX F_j, published here (no loop where
  // K is separable).
  // sums per mode (a run-time tag takes the most)
  constexpr int NS =
      (KT == KT_CONSTANT) ? 1
                          : ((KT == KT_LINEAR) ? 2
                                               : ((KT == KT_GEN) ? (GEN_TERMS > 0 ? GEN_TERMS : 1)
                                                                 : 5));
  __shared__ T part[N * NS][NUM_MAX_WARPS];
  T v[N * NS];
#pragma unroll
  for (int k = 0; k < N * NS; ++k) v[k] = T(0);
#pragma unroll 1
  for (int pass = 0; pass < n_pass; ++pass) {
    const int gg = g + pass * blockDim.x;
    const bool active = gg < G;
    T X, WX;
    node(gg, X, WX);
    const T LX = D::lg(vmax(X, tiny));
#ifdef CLOUDY_KERNEL_GEN
    if constexpr (KT == KT_GEN) {
      T gy[GEN_TERMS > 0 ? GEN_TERMS : 1], yv[GEN_YV > 0 ? GEN_YV : 1];
      cloudy_gen_y<T>(X, gy, yv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T wf = active ? WX * (md[j].s * md[j].shape(X, LX)) : T(0);
#pragma unroll
        for (int i = 0; i < GEN_TERMS; ++i)
          v[j * NS + i] = v[j * NS + i] + (active ? gy[i] * wf : T(0));
        if (GEN_REM && active) shWF[j * G + gg] = wf;
      }
      if (GEN_REM && active) {
#pragma unroll
        for (int k = 0; k < GEN_YV; ++k) shR[k * G + gg] = yv[k];
      }
      continue;
    }
#endif
    if (node_table(kt)) {
      if (active) {
        shR[gg] = hydro_radius(X);
#pragma unroll
        for (int j = 0; j < N; ++j) shWF[j * G + gg] = WX * (md[j].s * md[j].shape(X, LX));
      }
      continue;
    }
    const bool below = X < k0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T* t = v + j * NS;
      const T wf = active ? WX * (md[j].s * md[j].shape(X, LX)) : T(0);
      if (kt == KT_CONSTANT) {
        t[0] = t[0] + wf;
      } else if (NS >= 2 && kt == KT_LINEAR) {
        t[0] = t[0] + wf;
        t[1] = t[1] + wf * X;
      } else if (NS == 5) {
        t[0] = t[0] + (below ? wf : T(0));
        t[1] = t[1] + (below ? wf * X : T(0));
        t[2] = t[2] + (below ? wf * X * X : T(0));
        t[3] = t[3] + (below ? T(0) : wf);
        t[4] = t[4] + (below ? T(0) : wf * X);
      }
    }
  }
  if (node_table(kt) || (KT == KT_GEN && GEN_TERMS == 0))
    __syncthreads();
  else
    block_partials<T, N * NS>(v, lane, warp, part);

  // ---- per node: densities, weighting fractions, A, the inner integrals,
  // and its terms added to the warp's sums ----------------------------------
  const T lc = D::lg(T(HYDRO_C));
#pragma unroll 1
  for (int pass = 0; pass < n_pass; ++pass) {
    const int gg = g + pass * blockDim.x;
    const bool active = gg < G;
    T X, WX;
    node(gg, X, WX);
    const T LX = D::lg(vmax(X, tiny));

    T F[N], wfrac[N];
    {
      T NF[N], denom = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T e = md[j].shape(X, LX);
        F[j] = md[j].s * e;
        NF[j] = md[j].unit * e;
        denom = (j == 0) ? NF[0] : denom + NF[j];
      }
      // divided per mode, as the twin: the reciprocal of a denominator in the
      // subnormal range (a node far in a tail) overflows
      T run = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        run = run + NF[j];
        wfrac[j] = (denom == T(0)) ? T(0) : run / denom;
      }
    }

    T A[N];
#pragma unroll
    for (int j = 0; j < N; ++j) A[j] = T(0);
    if (kt == KT_HYDRO) {
      if (active) {
        const T r1 = hydro_radius(X);
        for (int y = 0; y < G; ++y) {
          const T K = hydro_value(k0, r1, shR[y]);
#pragma unroll
          for (int j = 0; j < N; ++j) A[j] = A[j] + shWF[j * G + y] * K;
        }
      }
    } else if (kt == KT_GEN) {
#ifdef CLOUDY_KERNEL_GEN
      T fx[GEN_TERMS > 0 ? GEN_TERMS : 1], xv[GEN_XV > 0 ? GEN_XV : 1];
      cloudy_gen_x<T>(X, fx, xv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int i = 0; i < GEN_TERMS; ++i)
          A[j] = A[j] + fx[i] * block_total(part, j * NS + i, n_warps);
      }
      if (GEN_REM && active) {
        for (int y = 0; y < G; ++y) {
          const T K = cloudy_gen_pair<T>(xv, shR + y, G);
#pragma unroll
          for (int j = 0; j < N; ++j) A[j] = A[j] + shWF[j * G + y] * K;
        }
      }
#endif
    } else {
      const bool below = X < k0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T t[NS];
#pragma unroll
        for (int k = 0; k < NS; ++k) t[k] = block_total(part, j * NS + k, n_warps);
        if (kt == KT_CONSTANT)
          A[j] = k0 * t[0];
        else if (NS >= 2 && kt == KT_LINEAR)
          A[j] = k0 * (X * t[0] + t[1]);
        else if (NS == 5 && below)
          A[j] = k1 * (X * X * t[0] + t[2]) + k2 * (X * t[3] + t[4]);
        else if (NS == 5)
          A[j] = k2 * (X * (t[0] + t[3]) + (t[1] + t[4]));
      }
    }

    T Gkk[N], Gq[NP > 0 ? NP : 1];
#pragma unroll
    for (int j = 0; j < N; ++j) Gkk[j] = T(0);
#pragma unroll
    for (int q = 0; q < NP; ++q) Gq[q] = T(0);

    if (active) {
      // ---- Q and S: the triangular inner integrals, y = s x; with a kink t
      // the inner panels split at s = t / x and 1 - t / x --------------------
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
        // a panel from 0 has s = ba s01, one to 1 has 1 - s = ba (1 - s01):
        // their logs are a table entry plus LX + log(ba) (log(ba) = 0 for the
        // one panel [0, 1]); any other log is taken at the node
        const bool from0 = kTables && p == 0, to1 = kTables && p == c.n_pi - 1;
        const T off = LX + ((c.n_pi == 1) ? T(0) : D::lg(ba));
        for (int i = 0; i < c.g_inner; ++i) {
          const T s = a + ba * c.s01[i];
          const T w = ba * c.w01[i];
          const T XR = X * (T(1) - s), XS = X * s;
          const T lr = to1 ? vmax(off + c.l1m01[i], L_tiny) : D::lg(vmax(XR, tiny));
          const T ls = from0 ? vmax(off + c.ls01[i], L_tiny) : D::lg(vmax(XS, tiny));
          T D[N], E[N];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            D[j] = md[j].s * md[j].shape(XR, lr);
            E[j] = md[j].s * md[j].shape(XS, ls);
          }
          T K;
          if (kt == KT_HYDRO) {
            // radius (c x)^(1/3) from the logs already taken
            const T r1 = D::ex((lr + lc) * T(1.0 / 3.0));
            const T r2 = D::ex((ls + lc) * T(1.0 / 3.0));
            K = hydro_value(k0, r1, r2);
          } else {
            K = kernel_value<T, KT>(kt, k0, k1, k2, XR, XS);
          }
          const T KW = T(0.5) * w * K;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            Gkk[j] = Gkk[j] + KW * D[j] * E[j];
#pragma unroll
            for (int k = j + 1; k < N; ++k)
              Gq[pair_index<N>(j, k)] =
                  Gq[pair_index<N>(j, k)] + KW * (D[j] * E[k] + D[k] * E[j]);
          }
        }
      }
    }
    add_warp_terms<T, N>(c, lane, warp, active, X, WX, F, wfrac, A, Gkk, Gq, red);
  }

  assemble<T, N>(c, g, red, tot, out, B, box);
}

// The kernel of one tag: quad_kernel, or with kDirect numerical_kernel
template <typename T, int N, int KT, bool kDirect>
constexpr auto numerical_instance() {
  if constexpr (kDirect)
    return numerical_kernel<T, N, KT>;
  else
    return quad_kernel<T, N, KT>;
}

template <typename T>
using NumKernel = void (*)(const T*, T*, const unsigned char*, int, long long);

// One launch: a block per box; numerical_kernel a thread per outer node
// (at most NUM_MAX_G), quad_kernel up to NUM_BLOCK threads striding them
// with `node_bytes` of dynamic shared memory past the configuration.
template <typename T>
int launch_num_kernel(NumKernel<T> kern, bool direct, const void* mom, void* out,
                      const void* cfg, int cfg_bytes, long long B, int g_total,
                      size_t node_bytes, void* stream) {
  if (cfg_bytes <= 0 || cfg_bytes % 16 != 0 || g_total < 1 ||
      (direct && g_total > NUM_MAX_G) || B < 1 || B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int lanes = (g_total + 31) / 32 * 32;
  const int threads = lanes < NUM_BLOCK ? lanes : NUM_BLOCK;
  const size_t smem = (size_t)cfg_bytes + node_bytes;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)mom, (T*)out, (const unsigned char*)cfg, cfg_bytes, B);
  return (int)cudaGetLastError();
}

template <typename T, int N, bool kDirect>
int launch_numerical(const void* mom, void* out, const void* cfg,
                     int cfg_bytes, long long B, int g_total, int ktag,
                     void* stream) {
  NumKernel<T> kern;
#if defined(CLOUDY_KERNEL_GEN)
  // a unit of a traced kernel function holds its arm alone
  if (ktag != KT_GEN) return (int)cudaErrorInvalidValue;
  kern = numerical_instance<T, N, KT_GEN, kDirect>();
#elif defined(CLOUDY_RUNTIME_KTAG)
  if (ktag < KT_CONSTANT || ktag > KT_LONG) return (int)cudaErrorInvalidValue;
  kern = numerical_instance<T, N, KT_RUNTIME, kDirect>();
#else
  switch (ktag) {
    case KT_CONSTANT: kern = numerical_instance<T, N, KT_CONSTANT, kDirect>(); break;
    case KT_LINEAR: kern = numerical_instance<T, N, KT_LINEAR, kDirect>(); break;
    case KT_HYDRO: kern = numerical_instance<T, N, KT_HYDRO, kDirect>(); break;
    case KT_LONG: kern = numerical_instance<T, N, KT_LONG, kDirect>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
#endif
  const size_t node_bytes = kDirect ? 0 : quad_node_bytes<T, N>(ktag, g_total);
  return launch_num_kernel<T>(kern, kDirect, mom, out, cfg, cfg_bytes, B, g_total,
                              node_bytes, stream);
}

}  // namespace cloudy

#define CLOUDY_NUMERICAL_ENTRY(name, T, N, DIRECT)                           \
  int name(const void* mom, void* out, const void* cfg, int cfg_bytes,       \
           long long B, int g_total, int ktag, void* stream) {               \
    return cloudy::launch_numerical<T, N, DIRECT>(mom, out, cfg, cfg_bytes,  \
                                                  B, g_total, ktag, stream); \
  }

// The C interface of a unit built at first use for N > NUM_MAX_MODES modes
// in type T (quad_kernel only):
//   cloudy_numerical_unit_launch(...): as cloudy_numerical_<T>_n<N>;
//   cloudy_numerical_unit_layout(out): per-mode stride, moment orders,
//     header size, as cloudy_numerical_layout;
//   cloudy_numerical_unit_info(out): N, sizeof(T);
//   cloudy_numerical_unit_error_string(err).
#define CLOUDY_NUMERICAL_UNIT_ENTRY(T, N)                                    \
  extern "C" {                                                               \
  CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_unit_launch, T, N, false)          \
  int cloudy_numerical_unit_layout(int* out) {                               \
    const int v[] = {cloudy::num_stride<N>(), cloudy::NUM_MAX_NMOM,          \
                     cloudy::NI_FAM};                                        \
    for (int i = 0; i < 3; ++i) out[i] = v[i];                               \
    return 3;                                                                \
  }                                                                          \
  int cloudy_numerical_unit_info(int* out) {                                 \
    out[0] = N;                                                              \
    out[1] = (int)sizeof(T);                                                 \
    return 2;                                                                \
  }                                                                          \
  const char* cloudy_numerical_unit_error_string(int err) {                  \
    return cudaGetErrorString((cudaError_t)err);                             \
  }                                                                          \
  }

extern "C" {

#if CLOUDY_IN_UNIT(0)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f32_n1, float, 1, false)

// The packed configuration's per-mode stride, moment orders and header
// size, for the host to check against its own
// (ops/numerical_coalescence.py, LAYOUT).
int cloudy_numerical_layout(int* out) {
  const int v[] = {cloudy::NUM_MAX_MODES, cloudy::NUM_MAX_NMOM, cloudy::NI_FAM};
  for (int i = 0; i < 3; ++i) out[i] = v[i];
  return 3;
}
#endif

#if CLOUDY_IN_UNIT(1)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f32_n2, float, 2, false)
#endif

#if CLOUDY_IN_UNIT(2)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f32_n3, float, 3, false)
#endif

#if CLOUDY_IN_UNIT(3)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f64_n1, double, 1, false)
#endif

#if CLOUDY_IN_UNIT(4)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f64_n2, double, 2, false)
#endif

#if CLOUDY_IN_UNIT(5)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_f64_n3, double, 3, false)
#endif

// numerical_kernel, the same-call yardstick
#if CLOUDY_IN_UNIT(6)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_direct_f32_n1, float, 1, true)
#endif

#if CLOUDY_IN_UNIT(7)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_direct_f32_n2, float, 2, true)
#endif

#if CLOUDY_IN_UNIT(8)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_direct_f32_n3, float, 3, true)
#endif

#if CLOUDY_IN_UNIT(9)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_direct_f64_n1, double, 1, true)
#endif

#if CLOUDY_IN_UNIT(10)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_direct_f64_n2, double, 2, true)
#endif

#if CLOUDY_IN_UNIT(11)
CLOUDY_NUMERICAL_ENTRY(cloudy_numerical_direct_f64_n3, double, 3, true)
#endif

}  // extern "C"
