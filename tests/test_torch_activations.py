"""The kernel-function tracer (`ops.kernel_expr`) on `torch.nn.functional`'s
activations with a `jax.nn` counterpart, on the CPU.

JAX's quadrature kernel calls whatever K it is given inside its body, the
`jax.nn` activations included; the port traces their torch forms into B5's
``KT_GEN`` arm. Here:

- each of the twelve forms (softplus, gelu in both modes, silu, mish, elu,
  leaky_relu, hardtanh, relu6, hardsigmoid, hardswish, logsigmoid,
  softsign), with its parameters, traces at f32 and f64, and
  `kernel_expr.evaluate` of its trace is the callable bit for bit;
  torch._C._nn's builtins trace as the functional forms, and an nn.Module
  over one traces as its functional form;
- each form's helper (csrc/common.cuh), compiled as host C++ through the
  unit's text, against torch on 1,000 seeded points of both signs: f64 ≤
  1e-14, f32 ≤ 1e-6 relative (beside `ALLOWANCE` where the form's own
  formula cancels; at ±inf torch's f64 values), the piecewise-linear forms
  bit for bit everywhere (±0, ±inf and NaN too), and every piecewise form
  bit for bit at its joints (softplus at threshold/β, hardtanh's bounds, ±3
  of hardsigmoid and hardswish, 0) and an ulp either side;
- hardsigmoid and hardswish divide by 6 on the card as on the host (torch's
  CUDA kernels multiply by a float one sixth, 3e-8 off in f64): the helpers
  compiled with ``__CUDA_ARCH__`` defined, against torch's CPU kernels bit
  for bit;
- the forms left refused raise `KernelTraceError` naming themselves;
- the traps between torch and JAX: F.gelu's default is the erf form and
  jax.nn.gelu's the tanh form; torch's softplus switches to x past β·x >
  threshold, JAX's is logaddexp(x, 0), exp(-20) apart past the switch;
- `tools.traced_kernels.activations` through the twin against
  `make_pallas_numerical_fn` in interpret mode (B = 8, nodes (16, 8));
  against JAX's einsum path it is a case of
  tests/test_torch_kernel_expr.py::test_twin_matches_jax_einsum.
"""

import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _codegen_host as ch
from cloudy_tpu.ops import pallas_numerical as pn
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec
from test_torch_b5_callable import TWO_GAMMA, _moments, _row_scaled
from test_torch_kernel_expr import _jactivations, _exactly_equal

from cloudy_tpu_torch.ops import _build, codegen, kernel_expr
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.spec import SpectrumSpec
from cloudy_tpu_torch.tools import traced_kernels as tk

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
HOST_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
N_POINTS = 1000

#: each form with its parameters, on x
FORMS = {
    "softplus": lambda x, y: F.softplus(x),
    "softplus_beta": lambda x, y: F.softplus(x, 2.0),
    "softplus_threshold": lambda x, y: F.softplus(x, beta=2.0, threshold=4.0),
    "gelu": lambda x, y: F.gelu(x),
    "gelu_tanh": lambda x, y: F.gelu(x, approximate="tanh"),
    "silu": lambda x, y: F.silu(x),
    "mish": lambda x, y: F.mish(x),
    "elu": lambda x, y: F.elu(x, 0.7),
    "elu_scaled": lambda x, y: torch._C._nn.elu(x, 0.7, 1.3, 0.6),
    "leaky_relu": lambda x, y: F.leaky_relu(x, 0.05),
    "hardtanh": lambda x, y: F.hardtanh(x),
    "hardtanh_bounds": lambda x, y: F.hardtanh(x, -0.5, 2.0),
    "relu6": lambda x, y: F.relu6(x),
    "hardsigmoid": lambda x, y: F.hardsigmoid(x),
    "hardswish": lambda x, y: F.hardswish(x),
    "logsigmoid": lambda x, y: F.logsigmoid(x),
    "softsign": lambda x, y: F.softsign(x),
}
#: the piecewise-linear forms: bit for bit on every point
EXACT = ("leaky_relu", "hardtanh", "hardtanh_bounds", "relu6", "hardsigmoid", "hardswish",
         "softsign")
#: each piecewise form's joints
JOINTS = {
    "softplus": (20.0,), "softplus_beta": (10.0,), "softplus_threshold": (2.0,),
    "elu": (0.0,), "elu_scaled": (0.0,), "leaky_relu": (0.0,), "hardtanh": (-1.0, 1.0),
    "hardtanh_bounds": (-0.5, 2.0), "relu6": (0.0, 6.0), "hardsigmoid": (-3.0, 3.0),
    "hardswish": (-3.0, 3.0),
}
_EPS_ALLOW = 4.0


def _cancelling(x, eps):
    """½|x| · 4 eps: gelu's 1 + erf(x/√2) and 1 + tanh(...) keep only what
    is left of 1 at x << 0, so an erf or tanh a few ulps of 1 apart in
    another libm (torch's CPU kernels call their own vector routines) moves
    the form by that much times ½|x|."""
    return 0.5 * x.abs() * _EPS_ALLOW * eps


#: the absolute error a form's own formula allows where it cancels
ALLOWANCE = {"gelu": _cancelling, "gelu_tanh": _cancelling}


def _points(dtype, seed=31):
    """The joints, an ulp either side, ±0, ±inf and NaN first, then x
    uniform in [-25, 25] (past softplus's threshold 20 and below -20)."""
    joints = sorted({j for js in JOINTS.values() for j in js})
    special = [0.0, -0.0, math.inf, -math.inf, math.nan]
    for j in joints:
        special += [j, float(np.nextafter(np.asarray(j, _np(dtype)), np.inf)),
                    float(np.nextafter(np.asarray(j, _np(dtype)), -np.inf))]
    rng = np.random.default_rng(seed)
    x = np.concatenate([special, rng.uniform(-25.0, 25.0, N_POINTS - len(special))])
    return torch.as_tensor(x, dtype=dtype)


def _np(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


@pytest.mark.parametrize("name", sorted(FORMS))
def test_activation_traces_and_evaluates_as_the_callable(name):
    f = FORMS[name]
    for dtype in DTYPES.values():
        assert not kernel_expr.trace(f, dtype).boolean
    x = _points(torch.float64)
    got = kernel_expr.evaluate(kernel_expr.trace(f), x, x)
    assert _exactly_equal(got, f(x, x)), name


def _text(f, dtype=torch.float64):
    return codegen.numerical_unit(2, dtype, kernel_expr.trace(f, dtype)).cfg


#: torch._C._nn's builtins against the functional forms they stand behind
NN_BUILTINS = {
    "softplus": (lambda x, y: torch._C._nn.softplus(x, 2.0, 4.0),
                 lambda x, y: F.softplus(x, 2.0, 4.0)),
    "gelu": (lambda x, y: torch._C._nn.gelu(x, approximate="tanh"),
             lambda x, y: F.gelu(x, approximate="tanh")),
    "silu": (lambda x, y: torch._C._nn.silu(x), lambda x, y: F.silu(x)),
    "mish": (lambda x, y: torch._C._nn.mish(x), lambda x, y: F.mish(x)),
    "elu": (lambda x, y: torch._C._nn.elu(x, 0.7), lambda x, y: F.elu(x, 0.7)),
    "leaky_relu": (lambda x, y: torch._C._nn.leaky_relu(x, 0.05),
                   lambda x, y: F.leaky_relu(x, 0.05)),
    "hardtanh": (lambda x, y: torch._C._nn.hardtanh(x, -0.5, 2.0),
                 lambda x, y: F.hardtanh(x, -0.5, 2.0)),
    "relu6": (lambda x, y: torch._C._nn.relu6(x), lambda x, y: F.relu6(x)),
    "hardsigmoid": (lambda x, y: torch._C._nn.hardsigmoid(x), lambda x, y: F.hardsigmoid(x)),
    "hardswish": (lambda x, y: torch._C._nn.hardswish(x), lambda x, y: F.hardswish(x)),
    "log_sigmoid": (lambda x, y: torch._C._nn.log_sigmoid(x), lambda x, y: F.logsigmoid(x)),
}
#: nn.Module instances against their functional forms
MODULES = {
    "GELU": (lambda x, y: torch.nn.GELU()(x), lambda x, y: F.gelu(x)),
    "GELU_tanh": (lambda x, y: torch.nn.GELU(approximate="tanh")(x),
                  lambda x, y: F.gelu(x, approximate="tanh")),
    "Softplus": (lambda x, y: torch.nn.Softplus(beta=2.0)(x),
                 lambda x, y: F.softplus(x, 2.0, 20.0)),
    "Hardtanh": (lambda x, y: torch.nn.Hardtanh(-0.5, 2.0)(x),
                 lambda x, y: F.hardtanh(x, -0.5, 2.0)),
    "Mish": (lambda x, y: torch.nn.Mish()(y), lambda x, y: F.mish(y)),
}


@pytest.mark.parametrize("name", sorted(NN_BUILTINS))
def test_nn_builtin_traces_as_the_functional_form(name):
    builtin, functional = NN_BUILTINS[name]
    assert _text(builtin) == _text(functional)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_traces_as_its_functional_form(name):
    module, functional = MODULES[name]
    assert _text(module) == _text(functional)
    assert _text(module, torch.float32) == _text(functional, torch.float32)


#: the forms left refused, and what the error names
REFUSED = {
    "tanhshrink": (lambda x, y: F.tanhshrink(x), "tanhshrink"),
    "softshrink": (lambda x, y: F.softshrink(x, 0.5), "softshrink"),
    "hardshrink": (lambda x, y: F.hardshrink(x, 0.5), "hardshrink"),
    "threshold": (lambda x, y: F.threshold(x, 0.1, 0.0), "threshold"),
    "rrelu": (lambda x, y: F.rrelu(x), "rrelu"),
    "prelu": (lambda x, y: F.prelu(x, torch.tensor([0.25])), "prelu"),
    "glu": (lambda x, y: F.glu(x), "glu"),
    "softmax": (lambda x, y: F.softmax(x, dim=0), "softmax"),
    "log_softmax": (lambda x, y: F.log_softmax(x, dim=0), "log_softmax"),
    "softmin": (lambda x, y: F.softmin(x, dim=0), "softmin"),
    "layer_norm": (lambda x, y: F.layer_norm(x, (1,)), "layer_norm"),
    "normalize": (lambda x, y: F.normalize(x), "normalize"),
    "inplace_flag": (lambda x, y: F.elu(x, inplace=True), "in-place torch.nn.functional"),
    "inplace_module": (lambda x, y: torch.nn.Hardswish(inplace=True)(x),
                       "in-place torch.nn.functional"),
    "inplace_name": (lambda x, y: F.leaky_relu_(x), "in-place torch.nn.functional"),
    "inplace_builtin": (lambda x, y: torch._C._nn.hardsigmoid_(x),
                        "in-place torch.nn.functional"),
    "operand_parameter": (lambda x, y: F.softplus(x, beta=y), "softplus's beta"),
    "gelu_mode": (lambda x, y: F.gelu(x, approximate="sigmoid"), "approximate='sigmoid'"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_activation_names_itself(name):
    f, what = REFUSED[name]
    with pytest.raises(kernel_expr.KernelTraceError, match=what):
        kernel_expr.trace(f)


# --------------------------------------------------------------------------
# the helpers as host C++
# --------------------------------------------------------------------------

def _host_name(name, dtype):
    return f"act_{name}_{'f32' if dtype == torch.float32 else 'f64'}"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """Every form's unit text (``codegen.numerical_unit``'s ``cfg.cuh``)
    in one host library, entry points ``act_<form>_<f32|f64>(x, y, out,
    n)``."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the emitted functions on the host")
    units = {_host_name(name, dtype): (_text(f, dtype), dtype)
             for name, f in FORMS.items() for dtype in DTYPES.values()}
    return ch.kernel_library(tmp_path_factory.mktemp("activations_host"), units)


def _host(lib, name, x):
    got = torch.empty_like(x)
    getattr(lib, _host_name(name, x.dtype))(x.data_ptr(), x.data_ptr(), got.data_ptr(),
                                            x.numel())
    return got


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", sorted(FORMS))
def test_activation_helper_on_the_host(host_lib, name, dtype):
    """The emitted helper against torch on the same points: the
    piecewise-linear forms bit for bit, the others within `HOST_TOL`
    relative (plus `ALLOWANCE`), NaN and the infinities where torch has
    them."""
    x = _points(dtype)
    got, want = _host(host_lib, name, x), FORMS[name](x, x)
    if name in EXACT:
        assert _exactly_equal(got, want), name
        return
    # at ±inf torch's f32 gelu kernel gives NaN (its vector erf there) where
    # its f64 kernel, the erf form and the helper give +inf: the infinite
    # points are held to torch in f64
    edge = ~torch.isfinite(x)
    want[edge] = FORMS[name](x[edge].double(), x[edge].double()).to(dtype)
    nan, inf = torch.isnan(want), torch.isinf(want)
    assert torch.equal(torch.isnan(got), nan) and torch.equal(got[inf], want[inf]), name
    fin = ~(nan | inf)
    bound = HOST_TOL[dtype] * want[fin].abs()
    if name in ALLOWANCE:
        bound = bound + ALLOWANCE[name](x[fin], torch.finfo(dtype).eps)
    err = (got[fin] - want[fin]).abs()
    assert bool((err <= bound).all()), (name, float((err / bound.clamp_min(1e-300)).max()))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", sorted(JOINTS))
def test_piecewise_form_at_its_joints(host_lib, name, dtype):
    """At each joint and an ulp either side the helper takes torch's
    branch and its value bit for bit: softplus at threshold/β (x past it,
    log1p(exp(βx))/β at and below it), elu and leaky_relu at 0, hardtanh's
    bounds, relu6 at 0 and 6, hardsigmoid and hardswish at ±3; and at ±0."""
    pts = [0.0, -0.0]
    for j in JOINTS[name]:
        a = np.asarray(j, _np(dtype))
        pts += [j, float(np.nextafter(a, np.inf)), float(np.nextafter(a, -np.inf))]
    x = torch.as_tensor(pts, dtype=dtype)
    got, want = _host(host_lib, name, x), FORMS[name](x, x)
    assert _exactly_equal(got, want), (name, x, got, want)


def test_device_hardsigmoid_divides_by_six(tmp_path):
    """hardsigmoid and hardswish as the card compiles them (``__CUDA_ARCH__``
    defined) divide by 6, as torch's CPU kernels and jax.nn.hard_sigmoid do,
    not by torch's CUDA kernels' float one sixth: in f64, bit for bit torch
    on the CPU."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the emitted functions on the host")
    (tmp_path / "shim").mkdir()
    (tmp_path / "shim" / "cuda_runtime.h").write_text(ch.SHIM)
    (tmp_path / "dev.cpp").write_text(
        '#define __CUDA_ARCH__ 900\n#include "common.cuh"\n'
        'extern "C" void dev(const double* x, double* s, double* w, long long n) {\n'
        "  for (long long i = 0; i < n; ++i) {\n"
        "    s[i] = cloudy::dhardsigmoid(x[i]); w[i] = cloudy::dhardswish(x[i]); } }\n")
    so = tmp_path / "libdev.so"
    subprocess.run([*ch._GXX, "-I", str(tmp_path / "shim"), "-I", str(_build.CSRC), "-o",
                    str(so), str(tmp_path / "dev.cpp")], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(so))
    lib.dev.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    x = _points(torch.float64)
    s, w = torch.empty_like(x), torch.empty_like(x)
    lib.dev(x.data_ptr(), s.data_ptr(), w.data_ptr(), x.numel())
    assert _exactly_equal(s, F.hardsigmoid(x)) and _exactly_equal(w, F.hardswish(x))


# --------------------------------------------------------------------------
# torch against JAX
# --------------------------------------------------------------------------

def test_gelu_default_modes_differ_between_torch_and_jax():
    """F.gelu's default is the erf form, jax.nn.gelu's the tanh form: each
    twin pair names its mode."""
    x = np.linspace(-4.0, 4.0, 801)
    t = torch.as_tensor(x)
    erf_t, tanh_t = F.gelu(t).numpy(), F.gelu(t, approximate="tanh").numpy()
    erf_j = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    default_j = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert np.abs(erf_t - erf_j).max() <= 1e-15
    assert np.abs(tanh_t - default_j).max() <= 1e-15
    assert np.abs(erf_t - default_j).max() > 1e-4


def test_softplus_switch_allowance_against_jax():
    """torch's softplus is x past β·x > 20, JAX's logaddexp(x, 0): below
    the switch the two agree to rounding, past it they differ by
    log1p(exp(-x)) ≤ exp(-20) ≈ 2.1e-9 in absolute terms (the allowance a
    comparison with JAX that reaches the switch states)."""
    x = np.linspace(-30.0, 40.0, 7001)
    got = F.softplus(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    below, past = x <= 20.0, x > 20.0
    assert np.abs(got[below] - want[below]).max() <= 1e-14 * np.abs(want[below]).max()
    gap = np.abs(got[past] - want[past])
    assert gap.max() <= math.exp(-20.0) and gap.max() > 1e-10


def test_activations_twin_matches_pallas_interpret():
    """JAX's Pallas kernel evaluates the `jax.nn` activations inside its
    body; the port's twin the same quadrature with their torch forms (B =
    8, nodes (16, 8))."""
    mom = _moments(TWO_GAMMA, 8, seed=10)
    pfn = pn.make_pallas_numerical_fn(JSpec((JFamily.GAMMA, JFamily.GAMMA)), _jactivations,
                                      n_outer=16, n_inner=8, block_cols=8, interpret=True)
    want = np.asarray(pfn(jnp.asarray(mom)))
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), tk.activations, 16, 8, device="cpu",
                              dtype=torch.float64)
    got = fn(torch.as_tensor(mom)).numpy()
    assert np.isfinite(want).all()
    assert _row_scaled(got, want) < 1e-12


def test_activation_terms_reach_every_piece():
    """`activations`' terms reach both sides of each joint on masses
    through the quadrature's range: softplus past its threshold, both
    bounds of hardtanh, ±3 of hardsigmoid and hardswish, both signs."""
    u = torch.linspace(0.0, 0.999, 2001, dtype=torch.float64)
    arg = {"softplus_threshold": 6.0 * (8.0 * u - 4.0), "hardtanh": 4.0 * u - 2.0,
           "hardsigmoid": 8.0 * u - 4.0, "hardswish": 8.0 * u - 4.0, "relu6": 8.0 * u - 1.0}
    edges = {"softplus_threshold": (20.0,), "hardtanh": (-1.0, 1.0),
             "hardsigmoid": (-3.0, 3.0), "hardswish": (-3.0, 3.0), "relu6": (0.0, 6.0)}
    for k, a in arg.items():
        for e in edges[k]:
            assert bool((a < e).any()) and bool((a > e).any()), k
    assert len(tk.ACTIVATION_TERMS) >= 12
