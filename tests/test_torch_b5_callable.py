"""The quadrature kernel (B5) with any kernel function, on the CPU.

JAX's `make_pallas_numerical_fn` calls whatever callable it is given inside
its kernel; the port traces a callable that is not one of the four tagged
kernel functions into an expression (`ops.kernel_expr`) and generates the
kernel's ``KT_GEN`` arm from it (`codegen.numerical_unit`). Here, in f64:

- the twin (which calls the callable on tensors) with a traced
  `CoalescenceTensor` (Long, order 2, normalized), a torch lambda and a
  subclass of a tagged class against JAX's einsum path
  `get_coal_ints_numerical` at the same nodes, row-scaled ≤ 1e-12; one
  case against `make_pallas_numerical_fn` in interpret mode (B = 16, nodes
  (32, 16), ~11 s);
- the plan: exact tag classes keep their tags and the prebuilt library, a
  traced callable is ``KT_GEN`` with its own unit (the digest covers the
  emitted text), an operation the tracer lacks raises naming it (on a CUDA
  wrapper; the CPU twin still runs it, as JAX does);
- the emitted device function ``cloudy_kernel_gen`` compiled as host C++
  (g++, the CUDA qualifiers defined away as in tests/test_torch_codegen.py)
  and evaluated on 1,000 seeded points against the callable (on Python
  floats where it takes them, whose libm the host build shares; else on
  tensors), relative ≤ 1e-14.

The kernel itself against the twin on the card:
tests/test_torch_cuda_kernels.py::test_traced_kernel_function_matches_twin
(marker ``cuda``; that file imports no jax, so it runs on the card).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import coalescence_numerical as jcn
from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu.ops import pallas_numerical as pn
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.ops import _build, codegen, kernel_expr
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
TWO_GAMMA = (Family.GAMMA, Family.GAMMA)
NODES = dict(n_outer=64, n_inner=32)
TOL = 1e-12


class ScaledLinear(K.LinearKernelFunction):
    """A subclass of a tagged class with a K(x, y) of its own."""

    def __call__(self, x, y):
        return 2.0 * super().__call__(x, y) + self.coll_coal_rate * x * y


class JScaledLinear(JK.LinearKernelFunction):
    def __call__(self, x, y):
        return 2.0 * super().__call__(x, y) + self.coll_coal_rate * x * y


def _long_tensor(mod):
    kf = mod.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    return mod.CoalescenceTensor.from_function(kf, 2, 5e-10).normalized(NORMS)


#: (port callable, JAX callable) per case
CASES = {
    "tensor": lambda: (_long_tensor(K), _long_tensor(JK)),
    "lambda": lambda: (lambda x, y: 1e-3 * (x * x + y * y) + 1e-4 * torch.sqrt(x * y),
                       lambda x, y: 1e-3 * (x * x + y * y) + 1e-4 * jnp.sqrt(x * y)),
    "subclass": lambda: (ScaledLinear(5e-3), JScaledLinear(5e-3)),
}


def _moments(families, n, seed):
    """Normalized moments [n, n_tot] of seeded parameters
    (tests/test_pallas_numerical.py:16-29)."""
    rng = np.random.default_rng(seed)
    par = np.stack([np.stack([rng.uniform(10, 200, n), rng.uniform(0.05, 5.0, n),
                              rng.uniform(0.5, 5.0, n)], -1) for _ in families], 1)
    return pd.get_moments(SpectrumSpec(families), torch.as_tensor(par)).numpy()


def _row_scaled(got, want):
    d = np.abs(got - want).max(axis=0)
    return float((d / np.maximum(np.abs(want).max(axis=0), 1e-300)).max())


def _jax_einsum(jkf, mom, n_outer, n_inner):
    jspec = JSpec((JFamily.GAMMA, JFamily.GAMMA))
    jparams = jpd.params_from_moments(jspec, jnp.asarray(mom))
    return np.asarray(jcn.get_coal_ints_numerical(jspec, jparams, jkf, n_outer=n_outer,
                                                  n_inner=n_inner))


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_twin_matches_jax_einsum(case):
    kf, jkf = CASES[case]()
    mom = _moments(TWO_GAMMA, 128, seed=0)
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), kf, **NODES, device="cpu",
                              dtype=torch.float64)
    assert fn.plan.ktag == nc.KT_GEN and "cloudy_kernel_gen" in fn.unit.cfg
    got = fn(torch.as_tensor(mom)).numpy()
    want = _jax_einsum(jkf, mom, **NODES)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert _row_scaled(got, want) < TOL


def test_traced_twin_matches_pallas_interpret():
    """JAX's Pallas kernel evaluates the lambda inside its body; the port's
    twin the same quadrature (B = 16, nodes (32, 16))."""
    kf, jkf = CASES["lambda"]()
    mom = _moments(TWO_GAMMA, 16, seed=1)
    jspec = JSpec((JFamily.GAMMA, JFamily.GAMMA))
    pfn = pn.make_pallas_numerical_fn(jspec, jkf, n_outer=32, n_inner=16, block_cols=16,
                                      interpret=True)
    want = np.asarray(pfn(jnp.asarray(mom)))
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), kf, 32, 16, device="cpu",
                              dtype=torch.float64)
    got = fn(torch.as_tensor(mom)).numpy()
    assert _row_scaled(got, want) < TOL


def test_plans_tags_and_units():
    spec = SpectrumSpec(TWO_GAMMA)
    long = K.LongKernelFunction(2.0, 1e-3, 5e-3)
    tagged = nc.make_numerical_fn(spec, long, device="cpu")
    assert tagged.plan.ktag == 3
    assert tagged.unit is None  # the prebuilt library's instance
    for case in sorted(CASES):
        kf, _ = CASES[case]()
        fn = nc.make_numerical_fn(spec, kf, device="cpu")
        assert fn.plan.ktag == nc.KT_GEN and fn.plan.kpar == (0.0, 0.0, 0.0)
        u = fn.unit
        assert u.kind == "numerical" and u.caps == (2,)
        assert "#define CLOUDY_KERNEL_GEN 1" in u.source
        assert "cloudy_kernel_gen(T x, T y)" in u.cfg
        # the digest follows the emitted text: the same callable traced again
        # builds nothing new, another type or callable does
        again = nc.make_numerical_fn(spec, kf, device="cpu").unit
        assert again.digest == u.digest
        assert nc.make_numerical_fn(spec, kf, device="cpu",
                                    dtype=torch.float64).unit.digest != u.digest
    units = {nc.make_numerical_fn(spec, CASES[c]()[0], device="cpu").unit.digest
             for c in CASES}
    assert len(units) == len(CASES)
    # a subclass of a tag class keeps the subclass's own kink and call
    sub = type("LongSub", (K.LongKernelFunction,), {})(2.0, 1e-3, 5e-3)
    plan = nc.build_plan(spec, sub)
    assert plan.ktag == nc.KT_GEN and plan.kinks == (2.0,) and plan.n_po == 3
    # the f32 unit rounds its constants once to float
    lam = CASES["lambda"]()[0]
    src32 = nc.make_numerical_fn(spec, lam, device="cpu").unit.cfg
    assert codegen.literal(1e-3, torch.float32) in src32
    # node tables: the traced arm reserves X and WX·F_j per outer node
    fn = nc.make_numerical_fn(spec, lam, device="cpu", dtype=torch.float64)
    assert fn._smem_bytes(1024) == 1024 + 3 * fn.plan.g_total * 8


def test_unsupported_operation_raises_with_its_name():
    spec = SpectrumSpec(TWO_GAMMA)
    sin_kernel = lambda x, y: torch.sin(x) * y + 1e-3  # noqa: E731
    with pytest.raises(kernel_expr.KernelTraceError, match="torch.sin"):
        kernel_expr.trace(sin_kernel)
    plan = nc.build_plan(spec, sin_kernel, 32, 16)
    assert plan.ktag == nc.KT_GEN
    with pytest.raises(NotImplementedError, match="torch.sin"):
        nc.NumericalFn(plan, "cuda", torch.float32)
    # the CPU twin calls the callable itself, as JAX's kernel does
    mom = _moments(TWO_GAMMA, 8, seed=2)
    got = nc.NumericalFn(plan, "cpu", torch.float64)(torch.as_tensor(mom)).numpy()
    want = _jax_einsum(lambda x, y: jnp.sin(x) * y + 1e-3, mom, 32, 16)
    assert _row_scaled(got, want) < TOL
    # Python branches, methods and other operators name what they are
    for f, what in ((lambda x, y: x if x < y else y, "Python branch"),
                    (lambda x, y: x.exp() + y, ".exp"),
                    (lambda x, y: x % y, "%"),
                    (lambda x, y: torch.tanh(x + y), "torch.tanh")):
        with pytest.raises(kernel_expr.KernelTraceError, match=f"{what}"):
            kernel_expr.trace(f)


# --------------------------------------------------------------------------
# the emitted device function as host C++
# --------------------------------------------------------------------------

#: tests/test_torch_codegen.py's shim: the CUDA qualifiers defined away for g++
SHIM = """#pragma once
#include <cmath>
#include <math.h>
#include <cstddef>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline void __syncthreads() {}
"""

HARNESS = """#include "cfg.cuh"
extern "C" void host_kernel(const double* x, const double* y, double* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = cloudy::cloudy_kernel_gen<double>(x[i], y[i]);
}
"""

#: the traced callables of the host check: the three cases, and the four
#: tagged classes through subclasses (traced, so their own K(x, y) is emitted)
HOST_CASES = {
    "tensor": lambda: CASES["tensor"]()[0],
    "lambda": lambda: CASES["lambda"]()[0],
    "subclass": lambda: CASES["subclass"]()[0],
    "long": lambda: type("L", (K.LongKernelFunction,), {})(2.0, 1e-3, 5e-3),
    "hydro": lambda: type("H", (K.HydrodynamicKernelFunction,), {})(1e-2),
    "constant": lambda: type("C", (K.ConstantKernelFunction,), {})(1e-3),
    "clamped": lambda: (lambda x, y: torch.where((x > 1.0) | (y > 1.0),
                                                  torch.clamp(torch.abs(x - y), 0.1, 3.0),
                                                  torch.exp(-x) * torch.log(1.0 + y)) / (x + y)),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_emitted_function_on_the_host(case, tmp_path):
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the emitted function on the host")
    kf = HOST_CASES[case]()
    unit = codegen.numerical_unit(2, torch.float64, kernel_expr.trace(kf))
    (tmp_path / "shim").mkdir()
    (tmp_path / "shim" / "cuda_runtime.h").write_text(SHIM)
    (tmp_path / "cfg.cuh").write_text(unit.cfg)
    (tmp_path / "host.cpp").write_text(HARNESS)
    so = tmp_path / "libhost.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", str(tmp_path / "shim"), "-I", str(_build.CSRC), "-I", str(tmp_path),
                    "-o", str(so), str(tmp_path / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.host_kernel.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    rng = np.random.default_rng(11)
    x = np.ascontiguousarray(np.exp(rng.uniform(np.log(1e-3), np.log(20.0), 1000)))
    y = np.ascontiguousarray(np.exp(rng.uniform(np.log(1e-3), np.log(20.0), 1000)))
    got = np.empty(1000)
    lib.host_kernel(x.ctypes.data, y.ctypes.data, got.ctypes.data, 1000)
    try:  # point by point on Python floats where the callable takes them:
        # the libm the host build calls (numpy's and torch's vector pow
        # differ from it by ulps, which the hydrodynamic |a1 - a2| magnifies)
        want = np.asarray([float(kf(float(a), float(b))) for a, b in zip(x, y)])
    except TypeError:  # torch functions only
        want = kf(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    want = np.broadcast_to(want, got.shape)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert np.isfinite(got).all()
    assert rel.max() <= 1e-14, (case, rel.max())


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_evaluated_trace_matches_the_callable(case):
    """`kernel_expr.evaluate` computes a trace as the emitted function does
    (each shared subexpression once, a product with 1 folded), at the shape
    its operands broadcast to: the callable's values to 1e-14."""
    kf = HOST_CASES[case]()
    rng = np.random.default_rng(12)
    x = torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(20.0), (50, 1))))
    y = torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(20.0), (1, 40))))
    got = kernel_expr.evaluate(kernel_expr.trace(kf), x, y)
    want = torch.broadcast_to(kf(x, y), (50, 40))
    assert got.shape == (50, 40)
    assert float(((got - want).abs() / want.abs().clamp_min(1e-300)).max()) <= 1e-14


def test_bound_counts_the_emitted_function():
    """The bound of a traced wrapper counts its twin with the kernel
    function evaluated as emitted (`opcount.count_ops_traced`): the tensor's
    ``x**0`` powers, products by one and repeated ``x*x`` go (fewer
    operations than the twin calling the tensor as written); the lambda's
    trace is the lambda (the same count)."""
    from cloudy_tpu_torch.tools import opcount

    mom = torch.as_tensor(_moments(TWO_GAMMA, 8, seed=3).T.copy())
    counts = {}
    for case in ("tensor", "lambda"):
        fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), CASES[case]()[0], 32, 16,
                                  device="cpu", dtype=torch.float64)
        counts[case] = (opcount.count_ops_traced(fn, mom), opcount.count_ops(fn.plain, mom))
    assert counts["tensor"][0] < 0.8 * counts["tensor"][1]
    assert counts["lambda"][0] == counts["lambda"][1]
    # the emitted tensor has no product by one
    src = kernel_expr.device_source(kernel_expr.trace(CASES["tensor"]()[0]), repr)
    assert "* 1.0" not in src and "1.0 *" not in src
