"""Host builds of generated reference-tier units for the CPU tests
(tests/test_torch_codegen_reference.py and _step.py): the reference tier's
arms, the configurations of one arm in both types compiled by g++ into one
host library through a shim that defines the CUDA qualifiers away (each
configuration in a namespace of its own), and the inputs the tests draw.

A warp's shuffle is 32 threads exchanging through a buffer between two
barrier waits (tests/test_torch_four_modes.py), a `__constant__` table a
host array; the library is compiled without FMA contraction, so it runs
the twin's operations in the twin's order.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.ops import _build, codegen
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)
NZ, DZ, DT = 8, 3000.0 / 8, 1.0
DTYPES = {"f32": torch.float32, "f64": torch.float64}
HOST_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
G, E, L, M = Family.GAMMA, Family.EXPONENTIAL, Family.LOGNORMAL, Family.MONODISPERSE
#: the reference tier's arms: (families, thresholds, moving, build keywords,
#: call keywords)
ARMS = {
    "fixed Simpson": ((G, G), (5e-10, np.inf), False, {}, {}),
    "fixed Simpson, 32 iterations": ((G, G), (5e-10, np.inf), False, {"gammainc_iters": 32},
                                     {}),
    "fixed Gauss": ((G, G), (5e-10, np.inf), False, {}, {"quad_rule": "gauss"}),
    "moving Simpson, Newton": ((G, G), (0.9, 1.0), True, {}, {}),
    "moving Gauss": ((G, G), (0.9, 1.0), True, {}, {"quad_rule": "gauss"}),
    "exact F2, series/CF": ((G, G), (5e-10, np.inf), False, {"f2_exact": True}, {}),
    "exponential + gamma": ((E, G), (5e-10, np.inf), False, {}, {}),
    "mono + gamma": ((M, G), (5e-10, np.inf), False, {}, {}),
    "lognormal Φ grid, series erf": ((L, G), (5e-10, np.inf), False, {}, {}),
    "lognormal Φ grid, rational erf": ((L, G), (5e-10, np.inf), False,
                                       {"gammainc_gl_nodes": 12},
                                       {"quad_rule": "gauss", "gauss_nodes": 12}),
}

SHIM = """#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <math.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __constant__
#define __align__(n)
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static thread_local uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static uint3 blockDim = {1, 1, 1};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline void __syncthreads() {}
static std::barrier<>* shim_warp = nullptr;
alignas(16) static unsigned char shim_buf[32 * 8];
template <class T> T __shfl_down_sync(unsigned, T v, int delta, int width) {
  const int lane = threadIdx.x & 31;
  T* buf = reinterpret_cast<T*>(shim_buf);
  buf[lane] = v;
  shim_warp->arrive_and_wait();
  const int src = lane + delta;
  const T got = (src < 32 && src / width == lane / width) ? buf[src] : v;
  shim_warp->arrive_and_wait();
  return got;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
"""

#: the shells: the coalescence body and the fused RHS lane by lane, the
#: whole step one warp of 32 threads at a time
SHELLS = """#include <thread>
#include <vector>
#include "gen_kernels.cuh"
namespace cloudy { alignas(16) unsigned char gen_smem[16]; }
template <class C> void coal(const typename C::real* mom, typename C::real* out, long long B) {
  using T = typename C::real;
  const C c{};
  for (long long lane = 0; lane < B; ++lane) {
    T m[C::kNtot], acc[C::kNtot], params[C::kModes][3];
    for (int o = 0; o < C::n_tot; ++o) m[o] = mom[o * B + lane];
    cloudy::coal_body<C::kArms, C::kRef>(c, m, acc, params);
    for (int o = 0; o < C::n_tot; ++o) out[o * B + lane] = acc[o];
  }
}
template <class C> void rhs(const typename C::real* mom, typename C::real* out, long long B) {
  for (long long lane = 0; lane < B; ++lane) {
    blockIdx.x = (unsigned)(lane / C::kThreads);
    threadIdx.x = (unsigned)(lane % C::kThreads);
    cloudy::gen_rhs_body<C>(mom, out, B);
  }
}
template <class C> void warps(const typename C::real* mom, typename C::real* out, long long B,
                              const typename C::real* scale) {
  for (long long w = 0; w < (B + 31) / 32; ++w) {
    std::barrier<> bar(32);
    shim_warp = &bar;
    std::vector<std::thread> th;
    for (int l = 0; l < 32; ++l)
      th.emplace_back([&, l] {
        const long long lane = w * 32 + l;
        blockIdx.x = (unsigned)(lane / C::kThreads);
        threadIdx.x = (unsigned)(lane % C::kThreads);
        cloudy::gen_step_body<C>(mom, out, B, scale);
      });
    for (auto& t : th) t.join();
  }
  shim_warp = nullptr;
}
"""

_GXX = ["g++", "-std=c++20", "-O0", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
        "-Wno-unknown-pragmas"]


def kernel_library(d, units: dict, shim_extra: str = "") -> ctypes.CDLL:
    """Traced units' ``cfg.cuh`` texts (`codegen.numerical_unit`) in one host
    library under directory `d`, each in a namespace of its own: `units`
    maps an entry name to (cfg text, torch dtype), and the entry point
    ``<name>(x, y, out, n)`` calls that unit's ``cloudy_kernel_gen`` element
    by element. `shim_extra` is added to the shim (a host ``erfinv``)."""
    (d / "shim").mkdir(exist_ok=True)
    (d / "shim" / "cuda_runtime.h").write_text(SHIM + shim_extra)
    lines = []
    for entry, (cfg, dtype) in units.items():
        (d / f"{entry}.cuh").write_text(
            cfg.replace("namespace cloudy {", f"namespace cloudy {{ namespace {entry} {{")
               .replace("}  // namespace cloudy", "} }"))
        real = "float" if dtype == torch.float32 else "double"
        lines += [f'#include "{entry}.cuh"',
                  f'extern "C" void {entry}(const {real}* x, const {real}* y, {real}* out, '
                  f"long long n) {{ for (long long i = 0; i < n; ++i) out[i] = "
                  f"cloudy::{entry}::cloudy_kernel_gen<{real}>(x[i], y[i]); }}"]
    (d / "host.cpp").write_text("\n".join(lines) + "\n")
    so = d / "libhost.so"
    subprocess.run([*_GXX, "-I", str(d / "shim"), "-I", str(_build.CSRC), "-I", str(d), "-o",
                    str(so), str(d / "host.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for entry in units:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
        fn.restype = None
    return lib


def ker(mod=K):
    return mod.CoalescenceTensor.from_function(mod.LinearKernelFunction(5.0), 1, 1e-6)


def arm_data(arm):
    """The port's data of arm `arm` (`ARMS`) and its call keywords."""
    fams, thr, moving, bkw, ckw = ARMS[arm]
    data = build_coalescence_data(SpectrumSpec(fams), ker(), thr, norms=NORMS, moving=moving,
                                  **bkw)
    return data, ckw


def arm_plans(arm):
    """(whole-step plan, fused-RHS plan) of arm `arm`."""
    data, ckw = arm_data(arm)
    return (fc.build_plan(data, VEL, NORMS, NZ, DZ, DT, **ckw),
            fc.build_plan(data, VEL, NORMS, **ckw))


def compile_arm(d, arm, kinds):
    """The host library of arm `arm` under directory `d`, with the entry
    points ``host_<kind>_<f32|f64>`` of `kinds`: "coal" and "rhs" (the fused
    RHS configuration's body and shell, ``(mom, out, B)``), "step" and
    "scaled" (the whole step and its scaled form, ``(mom, out, B,
    scale)``)."""
    splan, rplan = arm_plans(arm)
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text(SHIM)
    lines, entries = [SHELLS], []
    for tag, dtype in DTYPES.items():
        real = "float" if dtype == torch.float32 else "double"
        for kind in kinds:
            cfg_kind = "rhs" if kind in ("coal", "rhs") else "step"
            ns = f"gen_{cfg_kind}_{kind == 'scaled'}_{tag}"
            path = d / f"{ns}.cuh"
            if not path.exists():
                src = codegen.config_source(splan if cfg_kind == "step" else rplan, dtype,
                                            cfg_kind, kind == "scaled")
                path.write_text(src.replace("namespace gen {", f"namespace {ns} {{"))
                lines.append(f'#include "{ns}.cuh"')
            shell = {"coal": "coal", "rhs": "rhs"}.get(kind, "warps")
            args = f"const {real}* mom, {real}* out, long long B"
            if shell == "warps":
                lines.append(f'extern "C" void host_{kind}_{tag}({args}, const {real}* s) '
                             f"{{ warps<cloudy::{ns}::Cfg>(mom, out, B, s); }}")
            else:
                lines.append(f'extern "C" void host_{kind}_{tag}({args}) '
                             f"{{ {shell}<cloudy::{ns}::Cfg>(mom, out, B); }}")
            entries.append((f"host_{kind}_{tag}", shell == "warps"))
    (d / "host.cpp").write_text("\n".join(lines) + "\n")
    so = d / "libhost.so"
    subprocess.run([*_GXX, "-I", str(d / "shim"), "-I", str(_build.CSRC), "-I", str(d), "-o",
                    str(so), str(d / "host.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    for name, scaled in entries:
        f = getattr(lib, name)
        f.argtypes = [p, p, ll] + ([p] if scaled else [])
        f.restype = None
    return lib


def arm_moments(families, B, seed):
    """Normalized moments [n_tot, B] from parameters drawn first: gamma
    (θ, k) ∈ [0.05, 5] × [0.5, 5], lognormal (μ, σ) ∈ [−2, 0.5] × [0.3,
    1.2], monodisperse θ ∈ [0.05, 0.6] (about T/2 = 0.25), exponential θ ∈
    [0.02, 0.5]; n ∈ [10, 200]; lane 3 empty."""
    ranges = {G: ((0.05, 5.0), (0.5, 5.0)), L: ((-2.0, 0.5), (0.3, 1.2)),
              M: ((0.05, 0.6), (0.0, 0.0)), E: ((0.02, 0.5), (0.0, 0.0))}
    rng = np.random.default_rng(seed)
    par = np.stack([np.stack([rng.uniform(10, 200, B), rng.uniform(*ranges[f][0], B),
                              rng.uniform(*ranges[f][1], B)], -1) for f in families], axis=1)
    mom = pd.get_moments(SpectrumSpec(families), torch.as_tensor(par)).numpy().T.copy()
    mom[:, 3] = 0.0
    return mom


def physical(plan, mom, dtype):
    """Normalized moments times the moment norms, one negative moment."""
    x = torch.as_tensor(mom, dtype=dtype) * torch.tensor(plan.mom_norms, dtype=dtype)[:, None]
    x[0, 5] = -x[0, 5]
    return x.contiguous()


def call(f, x, n_out, *extra):
    out = torch.empty((n_out, x.shape[1]), dtype=x.dtype)
    f(x.data_ptr(), out.data_ptr(), x.shape[1], *extra)
    return out


def row_scaled(got, want, plan=None, rows=1):
    """max over rows of |got − want| / max|want| of the row; rows first
    divided by `plan`'s moment norms (`rows` times over) where given."""
    got, want = got.double(), want.double()
    if plan is not None:
        norm = torch.tensor(plan.mom_norms * rows, dtype=torch.float64)[:, None]
        got, want = got / norm, want / norm
    d = (got - want).abs().amax(dim=1)
    return float((d / want.abs().amax(dim=1).clamp_min(1e-300)).max())
