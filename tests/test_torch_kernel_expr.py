"""The kernel-function tracer (`ops.kernel_expr`) on every elementwise form
it covers, on the CPU, and `distributions.nparams`.

JAX's quadrature kernel calls whatever callable it is given inside its
body; the port traces the callable and emits it into the ``KT_GEN`` arm of
B5 (`codegen.numerical_unit`). Here:

- every covered form traces, at f32 and at f64, and `kernel_expr.evaluate`
  of its trace is the callable on seeded f64 tensors (relative ≤ 1e-14;
  the rounding, sign and modulus forms exactly);
- the unit's ``cloudy_kernel_gen`` of every form, compiled as host C++ (g++
  through tests/_codegen_host.py's shim, plus an ``erfinv`` that glibc
  lacks), against the callable on 1,000 seeded points: f64 relative ≤
  1e-14, f32 (the unit traced at f32, against the callable on f32 tensors)
  ≤ 1e-6 (`efficiency`'s 1 + tanh(z), which cancels at z << 0, with one
  ulp of tanh beside it), and the rounding, sign and modulus forms exactly,
  on points that hold half-way cases (``round`` is half to even), ``1e-3
  // 1e-4`` (9, not floor(1e-3/1e-4) = 10), operands of either sign, ±0, a
  zero divisor and NaN (``torch.sign`` gives 0 at NaN and +0 at -0);
- the method form of every covered function traces as the function, and
  each `torch.special` alias as its `torch` name; the forms that stay
  refused raise `KernelTraceError` naming themselves;
- `tools.traced_kernels`' `efficiency` and `coverage` through the twin
  against JAX's `get_coal_ints_numerical` with their `jnp` /
  `jax.scipy.special` twins (row-scaled ≤ 1e-12), and `efficiency`
  against `make_pallas_numerical_fn` in interpret mode (B = 16, nodes (32,
  16), ~11 s). The seeded moments keep the quadrature's nodes away from
  the points where torch and JAX differ (the sign of NaN and of -0, and
  ties of the rounding forms, which no node meets);
- the emitted text of the tensor and lambda cases of
  tests/test_torch_b5_callable.py, pinned by digest: a trace at a type
  changes nothing a kernel function does not ask the type of.

The kernels themselves against the twin on the card:
tests/test_torch_cuda_kernels.py::test_traced_kernel_function_matches_twin.
"""

import ctypes
import functools
import hashlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import torch

import _codegen_host as ch
from cloudy_tpu import distributions as jpd
from cloudy_tpu.ops import pallas_numerical as pn
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec
from test_torch_b5_callable import CASES, TWO_GAMMA, _jax_einsum, _moments, _row_scaled

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch.ops import _build, codegen, kernel_expr
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import traced_kernels as tk

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
HOST_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
N_POINTS = 1000


def _on_unit(term):
    return lambda x, y: term(tk.unit_interval(x), tk.unit_interval(y))


#: the smooth forms: each term of the coverage unit, on masses x, y
SMOOTH = {name: _on_unit(term) for name, term in tk.COVERAGE_TERMS.items()}
SMOOTH.update(tk.KERNELS)
#: the rounding, sign and modulus forms on x and y themselves, held exactly
EXACT = {
    "exact_round": lambda x, y: torch.round(x),
    "exact_round_method": lambda x, y: x.round(),
    "exact_special_round": lambda x, y: torch.special.round(x),
    "exact_floor": lambda x, y: torch.floor(x),
    "exact_ceil": lambda x, y: x.ceil(),
    "exact_trunc": lambda x, y: torch.trunc(x),
    "exact_fix": lambda x, y: torch.fix(x),
    "exact_sign": lambda x, y: torch.sign(x),
    "exact_sign_method": lambda x, y: x.sign(),
    "exact_copysign": lambda x, y: torch.copysign(x, y),
    "exact_fmod": lambda x, y: torch.fmod(x, y),
    "exact_remainder": lambda x, y: torch.remainder(x, y),
    "exact_remainder_method": lambda x, y: x.remainder(y),
    "exact_mod_operator": lambda x, y: x % y,
    "exact_rmod_operator": lambda x, y: 7.5 % y,
    "exact_floor_divide": lambda x, y: torch.floor_divide(x, y),
    "exact_floordiv_operator": lambda x, y: x // y,
    "exact_rfloordiv_operator": lambda x, y: 1e-3 // y,
    "exact_div_floor": lambda x, y: torch.div(x, y, rounding_mode="floor"),
    "exact_div_trunc": lambda x, y: x.div(y, rounding_mode="trunc"),
}
FORMS = {**SMOOTH, **EXACT}


def _smooth_points(dtype, shape=(N_POINTS,), seed=21):
    """Masses log-uniform in [1e-4, 1e4]."""
    rng = np.random.default_rng(seed)
    x, y = (torch.as_tensor(np.exp(rng.uniform(np.log(1e-4), np.log(1e4), shape)),
                            dtype=dtype) for _ in range(2))
    return x, y


def _exact_points(dtype, seed=22):
    """Operands of either sign, with the half-way cases, ``1e-3 // 1e-4``,
    ±0, a zero divisor and NaN first."""
    nan = float("nan")
    special = [(0.5, 0.7), (1.5, 0.7), (2.5, 0.7), (-0.5, 0.7), (-1.5, -0.7), (-2.5, 3.0),
               (3.5, 1e-4), (1e-3, 1e-4), (-1e-3, 1e-4), (1e-3, -1e-4), (-7.5, 2.0),
               (7.5, -2.0), (6.0, 2.0), (-6.0, 2.0), (0.0, 2.0), (-0.0, 2.0), (5.0, 0.0),
               (nan, 1.0), (1.0, nan)]
    rng = np.random.default_rng(seed)
    n = N_POINTS - len(special)
    x = np.concatenate([[p[0] for p in special], rng.uniform(-20.0, 20.0, n)])
    y = np.concatenate([[p[1] for p in special],
                        rng.choice([-1.0, 1.0], n) * np.exp(rng.uniform(-5.0, 2.0, n))])
    return torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)


def _points(name, dtype):
    return _exact_points(dtype) if name in EXACT else _smooth_points(dtype)


def _exactly_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    finite = ~np.isnan(want)
    return (np.array_equal(got, want, equal_nan=True)
            and np.array_equal(np.signbit(got[finite]), np.signbit(want[finite])))


def _relative(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-300)).max())


@pytest.mark.parametrize("name", sorted(FORMS))
def test_form_traces_and_evaluates_as_the_callable(name):
    """Each form traces at both types; the trace evaluated on f64 tensors
    (each shared subexpression once, at the shape its operands broadcast
    to) is the callable's value."""
    f = FORMS[name]
    for dtype in DTYPES.values():
        assert not kernel_expr.trace(f, dtype).boolean
    if name in EXACT:
        x, y = _exact_points(torch.float64)
        got = kernel_expr.evaluate(kernel_expr.trace(f), x, y)
        assert _exactly_equal(got, torch.broadcast_to(f(x, y), got.shape)), name
    else:
        x, y = _smooth_points(torch.float64, (50, 1))
        y = y.reshape(1, 50)[:, :40]
        got = kernel_expr.evaluate(kernel_expr.trace(f), x, y)
        assert got.shape == (50, 40)
        assert _relative(got, torch.broadcast_to(f(x, y), (50, 40))) <= 1e-14, name


# --------------------------------------------------------------------------
# the emitted device function as host C++
# --------------------------------------------------------------------------

#: glibc has no erfinv: a host one for the shim (torch's algorithm, in
#: double: a rational first guess, then Newton steps on erf)
ERFINV = """
inline double erfinv(double y) {
  if (y != y || y < -1.0 || y > 1.0) return NAN;
  if (y == 1.0 || y == -1.0) return copysign(INFINITY, y);
  const double a = fabs(y);
  double x;
  if (a <= 0.7) {
    const double z = y * y;
    x = y * (((-0.140543331 * z + 0.914624893) * z - 1.645349621) * z + 0.886226899) /
        ((((0.012229801 * z - 0.329097515) * z + 1.442710462) * z - 2.118377725) * z + 1.0);
  } else {
    const double z = sqrt(-log((1.0 - a) / 2.0));
    x = copysign(((1.641345311 * z + 3.429567803) * z - 1.624906493) * z - 1.970840454, y) /
        ((1.637067800 * z + 3.543889200) * z + 1.0);
  }
  for (int i = 0; i < 3; ++i) x -= (erf(x) - y) / (1.1283791670955126 * exp(-x * x));
  return x;
}
inline float erfinvf(float y) { return (float)erfinv((double)y); }
"""


#: the absolute error a form's own rounding allows where it cancels, beside
#: the relative tolerance: `efficiency`'s 1 + tanh(z) keeps only what is
#: left of 1 at z << 0, so a tanh one ulp (eps/2 near -1) apart in another
#: libm moves it by eps/2, carried through the other factors
ALLOWANCE = {"efficiency": lambda x, y, eps: 1e-3 * (x + y) * 0.5 * eps
             * torch.special.erf(x * y + 0.1)}


def _host_name(name, dtype):
    return f"host_{name}_{'f32' if dtype == torch.float32 else 'f64'}"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """Every form's unit text (``codegen.numerical_unit``'s ``cfg.cuh``,
    traced at each type) in one host library, each in a namespace of its
    own, entry points ``host_<form>_<f32|f64>(x, y, out, n)``."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the emitted functions on the host")
    d = tmp_path_factory.mktemp("kernel_expr_host")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text(ch.SHIM + ERFINV)
    lines = []
    for name, f in FORMS.items():
        for dtype in DTYPES.values():
            entry = _host_name(name, dtype)
            cfg = codegen.numerical_unit(2, dtype, kernel_expr.trace(f, dtype)).cfg
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
    subprocess.run([*ch._GXX, "-I", str(d / "shim"), "-I", str(_build.CSRC), "-I",
                    str(d), "-o", str(so), str(d / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in FORMS:
        for dtype in DTYPES.values():
            fn = getattr(lib, _host_name(name, dtype))
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            fn.restype = None
    return lib


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", sorted(FORMS))
def test_emitted_form_on_the_host(host_lib, name, dtype):
    """The emitted function against the callable on tensors of the same
    type: f64 ≤ 1e-14, f32 ≤ 1e-6 relative (plus `ALLOWANCE` where the
    form's own formula cancels), the rounding, sign and modulus forms bit
    for bit (NaN where the callable gives NaN)."""
    f = FORMS[name]
    x, y = _points(name, dtype)
    got = torch.empty_like(x)
    getattr(host_lib, _host_name(name, dtype))(x.data_ptr(), y.data_ptr(), got.data_ptr(),
                                               x.numel())
    want = torch.broadcast_to(f(x, y), x.shape)
    if name in EXACT:
        assert _exactly_equal(got, want), (name, got[:19], want[:19])
        return
    assert bool(torch.isfinite(got).all())
    if name in ALLOWANCE:
        bound = HOST_TOL[dtype] * want.abs() + ALLOWANCE[name](x, y, torch.finfo(dtype).eps)
        assert bool(((got - want).abs() <= bound).all()), name
    else:
        assert _relative(got, want) <= HOST_TOL[dtype], (name, _relative(got, want))


def test_exact_forms_follow_torch_not_c():
    """Where torch's semantics, which the helpers follow, differ from C's
    or from JAX's: round half to even, floor_divide's divmod correction,
    remainder's sign rule, sign at NaN and at -0."""
    t = torch.tensor
    assert torch.equal(torch.round(t([0.5, 1.5, 2.5, -0.5, -2.5])), t([0.0, 2.0, 2.0, -0.0, -2.0]))
    assert float(torch.floor_divide(t(1e-3, dtype=torch.float64), 1e-4)) == 9.0
    assert np.floor(1e-3 / 1e-4) == 10.0
    assert float(torch.remainder(t(-7.5), 2.0)) == 0.5 and float(torch.fmod(t(-7.5), 2.0)) == -1.5
    s = torch.sign(t([float("nan"), -0.0]))
    assert float(s[0]) == 0.0 and float(s[1]) == 0.0 and not bool(torch.signbit(s[1]))
    assert bool(jnp.isnan(jnp.sign(jnp.nan))) and bool(jnp.signbit(jnp.sign(-0.0)))


# --------------------------------------------------------------------------
# methods, aliases, constants of the traced type, refusals
# --------------------------------------------------------------------------

def _text(f, dtype=torch.float64):
    return kernel_expr.device_source(kernel_expr.trace(f, dtype),
                                     functools.partial(codegen.literal, dtype=dtype))


_MASKS = ("logical_and", "logical_or", "logical_not")
_CALLS = {
    "where": (lambda x, y: torch.where(x < y, x, y), lambda x, y: x.where(x < y, y)),
    "clamp": (lambda x, y: torch.clamp(x, 0.1, 0.9), lambda x, y: x.clamp(0.1, 0.9)),
    "clamp_min": (lambda x, y: torch.clamp_min(x, 0.2), lambda x, y: x.clamp_min(0.2)),
    "clamp_max": (lambda x, y: torch.clamp_max(x, 0.8), lambda x, y: x.clamp_max(0.8)),
}
METHODS = sorted(n for n in kernel_expr.TORCH_FUNCTIONS if hasattr(torch.Tensor, n))


def _method_pair(name):
    """(function form, method form) of the covered function `name`."""
    if name in _CALLS:
        return _CALLS[name]
    fn = getattr(torch, name)
    if name in _MASKS:
        args = (lambda x, y: (x < y,)) if name == "logical_not" else (
            lambda x, y: (x < y, y < 1.0))
        return (lambda x, y: torch.where(fn(*args(x, y)), x, y),
                lambda x, y: torch.where(getattr(args(x, y)[0], name)(*args(x, y)[1:]), x, y))
    try:
        fn(torch.ones(2))
        return (lambda x, y: fn(x), lambda x, y: getattr(x, name)())
    except TypeError:
        pass
    if name in ("lt", "le", "gt", "ge", "eq", "ne"):
        return (lambda x, y: torch.where(fn(x, y), x, y),
                lambda x, y: torch.where(getattr(x, name)(y), x, y))
    return (lambda x, y: fn(x, y), lambda x, y: getattr(x, name)(y))


@pytest.mark.parametrize("name", METHODS)
def test_method_form_traces_as_the_function(name):
    func, method = _method_pair(name)
    x, y = _smooth_points(torch.float64, (64,))
    assert _text(method) == _text(func)
    # the pair is one function on tensors too
    torch.testing.assert_close(method(x, y), func(x, y), rtol=0, atol=0, equal_nan=True)


SPECIAL_ALIASES = {"expm1": "expm1", "log1p": "log1p", "erf": "erf", "erfc": "erfc",
                   "erfinv": "erfinv", "exp2": "exp2", "gammaln": "lgamma", "round": "round",
                   "expit": "sigmoid"}


@pytest.mark.parametrize("name", sorted(SPECIAL_ALIASES))
def test_special_alias_traces_as_its_torch_name(name):
    special, plain = getattr(torch.special, name), getattr(torch, SPECIAL_ALIASES[name])
    assert special is not plain  # found by identity, not by __name__
    assert _text(lambda x, y: special(0.5 * x)) == _text(lambda x, y: plain(0.5 * x))


def test_dtype_and_device_give_constants_of_the_traced_type():
    """``torch.as_tensor(c, dtype=x.dtype, device=x.device)`` is a constant
    rounded to the traced type: the f32 and f64 units differ, as the
    callable does on tensors of the two types."""
    f = lambda x, y: torch.as_tensor(0.1, dtype=x.dtype, device=x.device) * y  # noqa: E731
    assert kernel_expr.trace(f, torch.float32).args[0].args[0] == float(np.float32(0.1))
    assert kernel_expr.trace(f, torch.float64).args[0].args[0] == 0.1
    g = lambda x, y: torch.full_like(x, 0.3, dtype=x.dtype, device=x.device) * y  # noqa: E731
    assert kernel_expr.trace(g).op == "mul"
    spec = SpectrumSpec(TWO_GAMMA)
    u32 = nc.make_numerical_fn(spec, f, device="cpu").unit
    u64 = nc.make_numerical_fn(spec, f, device="cpu", dtype=torch.float64).unit
    assert codegen.literal(float(np.float32(0.1)), torch.float32) in u32.cfg
    assert codegen.literal(0.1, torch.float64) in u64.cfg


#: the forms that stay refused, and what the error names
REFUSED = {
    "python_branch": (lambda x, y: x if x < y else y, "Python branch"),
    "reduction_method": (lambda x, y: x.sum() + y, r"\.sum"),
    "reduction_function": (lambda x, y: torch.cumsum(x + y, 0), "torch.cumsum"),
    "indexing": (lambda x, y: x[0] + y, "indexing"),
    "shape_change": (lambda x, y: x.reshape(-1) + y, r"\.reshape"),
    "in_place": (lambda x, y: x.add_(y), r"in-place method \.add_"),
    "dtype_method": (lambda x, y: x.double() + y, r"\.double"),
    "dtype_function": (lambda x, y: torch.float_power(x, 2.0), "torch.float_power"),
    "dtype_constant": (lambda x, y: torch.ones_like(x, dtype=torch.float16) * y,
                       "another type"),
    "random": (lambda x, y: torch.rand_like(x) * y, "torch.rand_like"),
    "no_device_version": (lambda x, y: torch.special.digamma(x + y), "torch.special.digamma"),
    "add_alpha": (lambda x, y: torch.add(x, y, alpha=2.0), "torch.add with alpha"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_form_names_itself(name):
    f, what = REFUSED[name]
    with pytest.raises(kernel_expr.KernelTraceError, match=what):
        kernel_expr.trace(f)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", ["tensor", "lambda"])
def test_emitted_text_of_the_earlier_cases_is_unchanged(case, dtype):
    """The units of the tensor and lambda cases are the ones built before
    the tracer took more forms (their cfg.cuh, SHA-256)."""
    pinned = {
        ("tensor", torch.float32): "12f7cd4579f7fb9ca68fb1b91e6dd9bbdd0464f5381dd73fa9fdc18533eeaa13",
        ("tensor", torch.float64): "d605a6a2034a317aad2fd8c5b1ead5cd1e38489e5c4096866562f55915f47cc7",
        ("lambda", torch.float32): "1af70703dbb0b2626a431e20c3245880b062099aec4806f5909769fef74dbe06",
        ("lambda", torch.float64): "eea5985dda5ad88c02c041504c35c82bb592481c0c1731619462bf0a977376b3",
    }
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), CASES[case]()[0], device="cpu",
                              dtype=dtype)
    assert hashlib.sha256(fn.unit.cfg.encode()).hexdigest() == pinned[case, dtype]


# --------------------------------------------------------------------------
# the two kernel functions through the twin, against JAX
# --------------------------------------------------------------------------

def _jefficiency(x, y):
    """The JAX twin of `tools.traced_kernels.efficiency`."""
    return jnp.multiply(1e-3 * (x + y), 0.5 * (1 + jnp.tanh(jnp.log1p(x) - y))) * jsp.erf(
        x * y + 0.1)


#: the JAX twins of `tools.traced_kernels.COVERAGE_TERMS`, by the same names
J_TERMS = {
    "add": lambda u, v: jnp.add(u, v),
    "sub": lambda u, v: 2.0 - u,
    "mul": lambda u, v: jnp.multiply(u, v),
    "div": lambda u, v: u / (1.0 + v),
    "div_floor": lambda u, v: jnp.floor_divide(0.5 * u + 2.25, 1.0),
    "div_trunc": lambda u, v: jnp.trunc((0.5 * v + 2.25) / 1.0),
    "true_divide": lambda u, v: jnp.true_divide(v, 1.0 + u),
    "neg": lambda u, v: jnp.negative(u - 1.5),
    "square": lambda u, v: jnp.square(v),
    "reciprocal": lambda u, v: jnp.reciprocal(1.0 + u),
    "tensor_mul": lambda u, v: 0.5 * u,
    "tensor_sub": lambda u, v: 2.0 - v,
    "tensor_div": lambda u, v: 1.0 / (1.0 + v),
    "tensor_pow": lambda u, v: 3.0 ** u,
    "pow": lambda u, v: jnp.power(1.0 + u, v),
    "pow_method": lambda u, v: (1.0 + v) ** 1.5,
    "ones_like": lambda u, v: 0.5 * jnp.ones_like(u),
    "zeros_like": lambda u, v: jnp.zeros_like(v) + v,
    "full_like": lambda u, v: jnp.full_like(u, 0.3),
    "as_tensor": lambda u, v: jnp.asarray(0.7, dtype=u.dtype) * v,
    "clamp": lambda u, v: jnp.clip(u, 0.1, 0.9),
    "clamp_min": lambda u, v: jnp.maximum(u, 0.25),
    "clamp_max": lambda u, v: jnp.minimum(v, 0.75),
    "minimum": lambda u, v: jnp.minimum(u, v),
    "maximum": lambda u, v: jnp.maximum(u, v),
    "fmin": lambda u, v: jnp.fmin(u, 1.0 - v),
    "fmax": lambda u, v: jnp.fmax(u, v),
    "where": lambda u, v: jnp.where(u > v, u - v, v - u),
    "where_method": lambda u, v: jnp.where(u < 0.5, u, 1.0 - u),
    "abs": lambda u, v: jnp.abs(u - v),
    "exp": lambda u, v: jnp.exp(-u),
    "log": lambda u, v: jnp.log(1.0 + v),
    "sqrt": lambda u, v: jnp.sqrt(u),
    "rsqrt": lambda u, v: jax.lax.rsqrt(1.0 + v),
    "sin": lambda u, v: jnp.sin(u),
    "cos": lambda u, v: jnp.cos(v),
    "tan": lambda u, v: jnp.tan(u),
    "asin": lambda u, v: jnp.arcsin(0.9 * u),
    "acos": lambda u, v: jnp.arccos(0.9 * v),
    "atan": lambda u, v: jnp.arctan(u),
    "atan2": lambda u, v: jnp.arctan2(u, 1.0 + v),
    "sinh": lambda u, v: jnp.sinh(u),
    "cosh": lambda u, v: jnp.cosh(v),
    "tanh": lambda u, v: jnp.tanh(u),
    "asinh": lambda u, v: jnp.arcsinh(v),
    "acosh": lambda u, v: jnp.arccosh(2.0 + u),
    "atanh": lambda u, v: jnp.arctanh(0.5 * v),
    "erf": lambda u, v: jsp.erf(u),
    "erfc": lambda u, v: jsp.erfc(v),
    "erfinv": lambda u, v: jsp.erfinv(0.9 * u),
    "lgamma": lambda u, v: jsp.gammaln(3.0 + v),
    "expm1": lambda u, v: jnp.expm1(u),
    "log1p": lambda u, v: jnp.log1p(v),
    "exp2": lambda u, v: jnp.exp2(u),
    "log2": lambda u, v: jnp.log2(2.0 + v),
    "log10": lambda u, v: jnp.log10(10.0 + 10.0 * u),
    "hypot": lambda u, v: jnp.hypot(u, v),
    "floor": lambda u, v: jnp.floor(0.5 * u + 2.25),
    "ceil": lambda u, v: jnp.ceil(0.5 * v + 2.25),
    "trunc": lambda u, v: jnp.trunc(0.5 * v + 2.25),
    "round": lambda u, v: jnp.round(0.4 * v + 2.05),
    "sign": lambda u, v: 2.0 + jnp.sign(-0.5 - u),
    "copysign": lambda u, v: 1.0 + jnp.copysign(u, -0.5 - v),
    "fmod": lambda u, v: jnp.fmod(0.5 * u + 2.25, 1.0),
    "remainder": lambda u, v: jnp.remainder(-0.5 * v - 1.25, 1.0),
    "floor_divide": lambda u, v: 3.0 + jnp.floor_divide(-0.5 * u - 1.25, 1.0),
    "mod_operator": lambda u, v: (0.5 * v + 2.25) % 1.0,
    "floordiv_operator": lambda u, v: (0.5 * u + 2.25) // 1.0,
    "sigmoid": lambda u, v: jax.nn.sigmoid(u),
    "special_expm1": lambda u, v: jnp.expm1(v),
    "special_log1p": lambda u, v: jnp.log1p(u),
    "special_erf": lambda u, v: jsp.erf(v),
    "special_erfc": lambda u, v: jsp.erfc(u),
    "special_erfinv": lambda u, v: jsp.erfinv(0.9 * v),
    "special_exp2": lambda u, v: jnp.exp2(v),
    "special_gammaln": lambda u, v: jsp.gammaln(3.0 + u),
    "special_round": lambda u, v: jnp.round(0.4 * u + 2.05),
    "special_expit": lambda u, v: jax.nn.sigmoid(v),
}


def _jcoverage(x, y):
    u, v = x / (1.0 + x), y / (1.0 + y)
    return 1e-3 * functools.reduce(lambda a, b: a + b, (J_TERMS[k](u, v)
                                                         for k in tk.COVERAGE_TERMS))


JAX_KERNELS = {"efficiency": _jefficiency, "coverage": _jcoverage}


def test_jax_twins_name_every_coverage_term():
    assert list(J_TERMS) == list(tk.COVERAGE_TERMS)


@pytest.mark.parametrize("name", sorted(tk.KERNELS))
def test_twin_matches_jax_einsum(name):
    mom = _moments(TWO_GAMMA, 128, seed=7)
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), tk.KERNELS[name], 64, 32, device="cpu",
                              dtype=torch.float64)
    assert fn.plan.ktag == nc.KT_GEN and "cloudy_kernel_gen" in fn.unit.cfg
    got = fn(torch.as_tensor(mom)).numpy()
    want = _jax_einsum(JAX_KERNELS[name], mom, 64, 32)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert _row_scaled(got, want) < 1e-12


def test_efficiency_twin_matches_pallas_interpret():
    """JAX's Pallas kernel evaluates the efficiency lambda inside its body;
    the port's twin the same quadrature (B = 16, nodes (32, 16))."""
    mom = _moments(TWO_GAMMA, 16, seed=8)
    pfn = pn.make_pallas_numerical_fn(JSpec((JFamily.GAMMA, JFamily.GAMMA)), _jefficiency,
                                      n_outer=32, n_inner=16, block_cols=16, interpret=True)
    want = np.asarray(pfn(jnp.asarray(mom)))
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), tk.efficiency, 32, 16, device="cpu",
                              dtype=torch.float64)
    got = fn(torch.as_tensor(mom)).numpy()
    assert np.isfinite(want).all()
    assert _row_scaled(got, want) < 1e-12


# --------------------------------------------------------------------------
# distributions.nparams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(Family), ids=lambda f: f.name)
def test_nparams_matches_jax(family):
    assert pd.nparams(family) == jpd.nparams(JFamily(int(family)))
    assert pd.nparams(int(family)) == pd.nparams(family)
