// Per-op-class chain kernels for Hopper (sm_90a), bound to PyTorch by ctypes
// (ops/_build.py builds this file, ops/op_chains.py launches it).
//
// Replaces the Pallas TPU kernel of tools/op_microbench.py (`_kernel` :141,
// `measure` :157, `pallas_call` :170): chain c applies k serial links of one
// small bundle of operations to ILP independent streams; each link depends on
// the one before, so the compiler can neither drop nor merge links. Timing two
// chain lengths and differencing gives the card's cost per element and link
// of each bundle (tools/op_microbench.py in this package).
//
// The links are those of the JAX tool's CHAINS and BUNDLES (:55-131),
// constants as T(c), rounded once to the type as jnp's weakly typed constants
// are (a bare double literal would promote an f32 chain to f64). The bundles
// call this package's own device special functions, the ones B1, B3 and B4
// evaluate: lgamma_lanczos (common.cuh), lgamma_stirling, gamma_ratio,
// gammainc_gl, gammaincinv_gl and erf_approx (coal_body.cuh). gammainc_gl
// reads its Gauss-Legendre tables from a Config in shared memory, packed on
// the host by the coalescence kernels' packer for a 12-node plan, as B1 reads
// them.
//
// What bounds them on this card: execution of the link's instructions (FP32 or
// FP64 pipes, the MUFU unit for exp/log/sqrt, the division subroutine);
// bytes only at k = 0. What the design does about it: one thread per column
// of x [ilp, n], the ILP values in registers (unrolled over the streams), k
// links in a loop unrolled a little (kUnroll) for the cheap links and not at
// all for the bundles, whose own loops hold hundreds of operations. Which
// chain runs is chosen on the host: every chain is its own template instance
// (a run-time tag inside a kernel cost B5 14.9-25.7 %,
// tools/dispatch_compare.py). Built with B1's flags, FMA contraction on, so
// the costs apply to B1.
//
// No fast-math: expf/logf/division stay IEEE-accurate and denormals are kept.

#include "coal_body.cuh"

// Build units (ops/_build.py compiles each with -DCLOUDY_UNIT=u, all at once):
// 0 the entry points, 1-4 the f32 chains (primitive and mixed; lgamma,
// lgamma_stirling, erf_approx, gamma_ratio; gammainc_gl12; gammaincinv_gl12),
// 5-8 the same in f64.
#ifdef CLOUDY_UNIT
#define CLOUDY_IN_UNIT(u) (CLOUDY_UNIT == (u))
#else
#define CLOUDY_IN_UNIT(u) 1
#endif

namespace cloudy {
namespace chains {

constexpr int kThreads = 256;  // ops/op_chains.py THREADS
constexpr int kIlp = 8;        // ops/op_chains.py ILP

// Link functors: `x` -> the next link; kUnroll links per loop trip.
#define CLOUDY_LINK(Name, unroll, body)                                      \
  template <typename T> struct Name {                                        \
    static constexpr int kUnroll = unroll;                                   \
    __device__ __forceinline__ T operator()(const Config<T>& c, T x) const { \
      (void)c;                                                               \
      return body;                                                           \
    }                                                                        \
  };

CLOUDY_LINK(Mul, 4, x * T(1.0000001))
CLOUDY_LINK(Add, 4, x + T(1e-6))
CLOUDY_LINK(MulAdd, 4, x * T(0.999999) + T(1e-4))
CLOUDY_LINK(Div, 4, (x + T(2)) / (x + T(3)))
CLOUDY_LINK(Exp, 4, dexp(T(0.3) - x))
CLOUDY_LINK(Log, 4, dlog(x + T(1.5)))
CLOUDY_LINK(Sqrt, 4, dsqrt(x + T(0.5)))
CLOUDY_LINK(Sel, 4, (x > T(0.6)) ? x * T(0.699999) : x + T(0.25))
CLOUDY_LINK(ExpDiv, 4, dexp(-x) / (x + T(1.5)) + T(0.4))
CLOUDY_LINK(ExpLog, 4, dlog(dexp(T(0.3) - x) + T(0.9)))
CLOUDY_LINK(Poly, 4, ((T(0.01) * x + T(0.2)) * x + T(0.1)) * x + T(0.3))
CLOUDY_LINK(ExpMul4, 4,
            dexp(T(0.3) - x) * T(0.9999 * 1.0001) *
                (T(1.0 + 1e-7) * x + T(1e-6)) * T(0.5))
CLOUDY_LINK(LGamma, 1, lgamma_lanczos(x + T(2.2)))
CLOUDY_LINK(LGammaStirling, 1, lgamma_stirling(x + T(2.2)))
// lgamma(4.5), the JAX tool's _GLN_45
CLOUDY_LINK(GammaincGl12, 1,
            gammainc_gl(c, T(4.5), T(0.5) + T(3) * x, T(2.4537365708424423)))
CLOUDY_LINK(ErfApprox, 1, T(0.1) + T(0.7) * dabs(erf_approx(x)))
CLOUDY_LINK(GammaRatio, 1, T(0.2) + T(0.5) * gamma_ratio(x + T(0.5), T(1.0 / 6.0)))
CLOUDY_LINK(GammaincinvGl12, 1, T(0.1) * gammaincinv_gl(c, T(2.5), x))
#undef CLOUDY_LINK

// The chain table: id (ops/op_chains.py NAMES), name, functor.
#define CLOUDY_CHAINS(X)                    \
  X(0, "mul", Mul)                          \
  X(1, "add", Add)                          \
  X(2, "muladd", MulAdd)                    \
  X(3, "div", Div)                          \
  X(4, "exp", Exp)                          \
  X(5, "log", Log)                          \
  X(6, "sqrt", Sqrt)                        \
  X(7, "sel", Sel)                          \
  X(8, "expdiv", ExpDiv)                    \
  X(9, "explog", ExpLog)                    \
  X(10, "poly", Poly)                       \
  X(11, "expmul4", ExpMul4)                 \
  X(12, "lgamma", LGamma)                   \
  X(13, "lgamma_stirling", LGammaStirling)  \
  X(14, "gammainc_gl12", GammaincGl12)      \
  X(15, "erf_approx", ErfApprox)            \
  X(16, "gamma_ratio", GammaRatio)          \
  X(17, "gammaincinv_gl12", GammaincinvGl12)

// Link: a functor type of the table in T, e.g. Mul<float>
template <typename T, typename Link, int ILP, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const T* __restrict__ in, T* __restrict__ out, long long n,
                 int k, const unsigned char* __restrict__ cfg_g, int cfg_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  load_config(smem, cfg_g, cfg_bytes);
  __syncthreads();
  Config<T> c;
  c.bind(smem);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // no barrier follows

  const Link link{};
  T x[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) x[i] = in[i * n + e];
#pragma unroll (kUnroll)
  for (int l = 0; l < k; ++l) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) x[i] = link(c, x[i]);
  }
#pragma unroll
  for (int i = 0; i < ILP; ++i) out[i * n + e] = x[i];
}

// Chain `kChain` in type T: a launch, and the resident blocks per SM.
// Declared here, defined and instantiated in the chain's build unit.
template <typename T, int kChain>
int chain_launch(const void* in, void* out, long long n, int k, const void* cfg,
                 int cfg_bytes, void* stream);
template <typename T, int kChain>
int chain_blocks(int cfg_bytes, int* blocks);

// the functor of chain id in T: typename ChainOf<id>::template L<T>
template <int kChain> struct ChainOf;
#define CLOUDY_CHAIN_OF(id, name, Link)      \
  template <> struct ChainOf<id> {           \
    template <typename T> using L = Link<T>; \
  };
CLOUDY_CHAINS(CLOUDY_CHAIN_OF)
#undef CLOUDY_CHAIN_OF

#if CLOUDY_IN_UNIT(1) || CLOUDY_IN_UNIT(2) || CLOUDY_IN_UNIT(3) || \
    CLOUDY_IN_UNIT(4) || CLOUDY_IN_UNIT(5) || CLOUDY_IN_UNIT(6) || \
    CLOUDY_IN_UNIT(7) || CLOUDY_IN_UNIT(8)
template <typename T, int kChain>
int chain_launch(const void* in, void* out, long long n, int k, const void* cfg,
                 int cfg_bytes, void* stream) {
  using L = typename ChainOf<kChain>::template L<T>;
  const long long blocks = (n + kThreads - 1) / kThreads;
  chain_kernel<T, L, kIlp, L::kUnroll>
      <<<(unsigned)blocks, kThreads, cfg_bytes, (cudaStream_t)stream>>>(
          (const T*)in, (T*)out, n, k, (const unsigned char*)cfg, cfg_bytes);
  return (int)cudaGetLastError();
}

template <typename T, int kChain>
int chain_blocks(int cfg_bytes, int* blocks) {
  using L = typename ChainOf<kChain>::template L<T>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chain_kernel<T, L, kIlp, L::kUnroll>, kThreads, (size_t)cfg_bytes);
}
#endif

// explicit instances, each in its chain's unit (f32 unit u, f64 unit u + 4)
#define CLOUDY_INSTANCE(T, id)                                                 \
  template int chain_launch<T, id>(const void*, void*, long long, int,        \
                                   const void*, int, void*);                   \
  template int chain_blocks<T, id>(int, int*);

#if CLOUDY_IN_UNIT(1)
CLOUDY_INSTANCE(float, 0) CLOUDY_INSTANCE(float, 1) CLOUDY_INSTANCE(float, 2)
CLOUDY_INSTANCE(float, 3) CLOUDY_INSTANCE(float, 4) CLOUDY_INSTANCE(float, 5)
CLOUDY_INSTANCE(float, 6) CLOUDY_INSTANCE(float, 7) CLOUDY_INSTANCE(float, 8)
CLOUDY_INSTANCE(float, 9) CLOUDY_INSTANCE(float, 10) CLOUDY_INSTANCE(float, 11)
#endif
#if CLOUDY_IN_UNIT(2)
CLOUDY_INSTANCE(float, 12) CLOUDY_INSTANCE(float, 13) CLOUDY_INSTANCE(float, 15)
CLOUDY_INSTANCE(float, 16)
#endif
#if CLOUDY_IN_UNIT(3)
CLOUDY_INSTANCE(float, 14)
#endif
#if CLOUDY_IN_UNIT(4)
CLOUDY_INSTANCE(float, 17)
#endif
#if CLOUDY_IN_UNIT(5)
CLOUDY_INSTANCE(double, 0) CLOUDY_INSTANCE(double, 1) CLOUDY_INSTANCE(double, 2)
CLOUDY_INSTANCE(double, 3) CLOUDY_INSTANCE(double, 4) CLOUDY_INSTANCE(double, 5)
CLOUDY_INSTANCE(double, 6) CLOUDY_INSTANCE(double, 7) CLOUDY_INSTANCE(double, 8)
CLOUDY_INSTANCE(double, 9) CLOUDY_INSTANCE(double, 10) CLOUDY_INSTANCE(double, 11)
#endif
#if CLOUDY_IN_UNIT(6)
CLOUDY_INSTANCE(double, 12) CLOUDY_INSTANCE(double, 13) CLOUDY_INSTANCE(double, 15)
CLOUDY_INSTANCE(double, 16)
#endif
#if CLOUDY_IN_UNIT(7)
CLOUDY_INSTANCE(double, 14)
#endif
#if CLOUDY_IN_UNIT(8)
CLOUDY_INSTANCE(double, 17)
#endif
#undef CLOUDY_INSTANCE

template <typename T>
int dispatch_launch(int chain, int ilp, const void* in, void* out, long long n,
                    int k, const void* cfg, int cfg_bytes, void* stream) {
  if (ilp != kIlp || n <= 0 || k < 0 || cfg_bytes <= 0 ||
      cfg_bytes > SMEM_NO_OPTIN || cfg_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (chain) {
#define CLOUDY_CASE(id, name, Link) \
  case id: return chain_launch<T, id>(in, out, n, k, cfg, cfg_bytes, stream);
    CLOUDY_CHAINS(CLOUDY_CASE)
#undef CLOUDY_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_blocks(int chain, int cfg_bytes, int* blocks) {
  switch (chain) {
#define CLOUDY_CASE(id, name, Link) \
  case id: return chain_blocks<T, id>(cfg_bytes, blocks);
    CLOUDY_CHAINS(CLOUDY_CASE)
#undef CLOUDY_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace chains
}  // namespace cloudy

extern "C" {

#if CLOUDY_IN_UNIT(0)
// x [ilp, n] -> out [ilp, n] after k links of chain `chain`, ilp = kIlp; cfg:
// the packed 12-node configuration (ops/op_chains.py)
int cloudy_chain_f32(int chain, int ilp, const void* in, void* out, long long n,
                     int k, const void* cfg, int cfg_bytes, void* stream) {
  return cloudy::chains::dispatch_launch<float>(chain, ilp, in, out, n, k, cfg,
                                                cfg_bytes, stream);
}

int cloudy_chain_f64(int chain, int ilp, const void* in, void* out, long long n,
                     int k, const void* cfg, int cfg_bytes, void* stream) {
  return cloudy::chains::dispatch_launch<double>(chain, ilp, in, out, n, k, cfg,
                                                 cfg_bytes, stream);
}

int cloudy_chain_blocks_per_sm_f32(int chain, int cfg_bytes, int* blocks) {
  return cloudy::chains::dispatch_blocks<float>(chain, cfg_bytes, blocks);
}

int cloudy_chain_blocks_per_sm_f64(int chain, int cfg_bytes, int* blocks) {
  return cloudy::chains::dispatch_blocks<double>(chain, cfg_bytes, blocks);
}

// The chain table's names in id order, for the host to check its own against.
const char* cloudy_chain_name(int chain) {
  switch (chain) {
#define CLOUDY_NAME(id, name, Link) \
  case id: return name;
    CLOUDY_CHAINS(CLOUDY_NAME)
#undef CLOUDY_NAME
    default: return nullptr;
  }
}
#endif

}  // extern "C"
