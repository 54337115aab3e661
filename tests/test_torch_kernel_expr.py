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
- the special functions, closed forms, masks and cleanups (`special`'s
  terms on masses; `EDGE`: the exact ones bit for bit on ±0, ±inf, NaN
  and their jumps; `REGIME`: torch's special functions on grids through
  every regime of its algorithms, its poles, infinities and NaN exactly
  and the rest within 1e-13 (f64) and 1e-5 (f32) relative, beside
  `SPECIAL_ALLOWANCE` where the formula itself cancels);
- `tools.traced_kernels`' `efficiency`, `coverage`, `special` and
  `activations` through the twin against JAX's `get_coal_ints_numerical`
  with their `jnp` / `jax.scipy.special` / `jax.nn` twins (row-scaled ≤
  1e-12; `special` at B = 32,
  nodes (32, 16)), and `efficiency` (B = 16, nodes (32, 16), ~11 s) and a
  closed-form subset of `special` (B = 8, nodes (16, 8), ~14 s) against
  `make_pallas_numerical_fn` in interpret mode. The seeded moments keep
  the quadrature's nodes away from the points where torch and JAX differ
  (the sign of NaN and of -0, and ties of the rounding forms, which no
  node meets);
- the emitted text of the tensor and lambda cases of
  tests/test_torch_b5_callable.py and of `efficiency` and `coverage`,
  pinned by digest: a trace at a type changes nothing a kernel function
  does not ask the type of, and a helper is emitted only where a trace
  calls it (the traced K as pinned before the tracer took more forms, the
  whole unit with its factored form beside it).

The activations' helpers on their own: tests/test_torch_activations.py;
the factored form R is taken from: tests/test_torch_b5_factored.py.

The kernels themselves against the twin on the card:
tests/test_torch_cuda_kernels.py::test_traced_kernel_function_matches_twin.
"""

import functools
import hashlib
import operator
import shutil

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
from cloudy_tpu_torch.ops import codegen, kernel_expr
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import traced_kernels as tk

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
HOST_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
N_POINTS = 1000


def _on_unit(term):
    return lambda x, y: term(tk.unit_interval(x), tk.unit_interval(y))


#: the smooth forms: each term of the coverage and special units, on masses x, y
SMOOTH = {name: _on_unit(term) for name, term in tk.COVERAGE_TERMS.items()}
SMOOTH.update({name: _on_unit(term) for name, term in tk.SPECIAL_TERMS.items()})
SMOOTH.update(tk.KERNELS)
assert len(SMOOTH) == len(tk.COVERAGE_TERMS) + len(tk.SPECIAL_TERMS) + len(tk.KERNELS)
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
#: the exact forms the tracer took with the special functions, held bit
#: for bit on `_edge_points` (±0, ±inf, NaN, the jumps); the masks through
#: a `where`, as a kernel function uses them
EDGE = {
    "edge_isnan": lambda x, y: torch.where(torch.isnan(x), 1.0, 2.0),
    "edge_isinf": lambda x, y: torch.where(x.isinf(), 1.0, 2.0),
    "edge_isfinite": lambda x, y: torch.where(torch.isfinite(x), 1.0, 2.0),
    "edge_isposinf": lambda x, y: torch.where(torch.isposinf(x), 1.0, 2.0),
    "edge_isneginf": lambda x, y: torch.where(torch.isneginf(x), 1.0, 2.0),
    "edge_signbit": lambda x, y: torch.where(torch.signbit(x), 1.0, 2.0),
    "edge_mask_logic": lambda x, y: torch.where(torch.isnan(y) | ~torch.isfinite(x), x, y),
    "edge_nan_to_num": lambda x, y: torch.nan_to_num(x),
    "edge_nan_to_num_values": lambda x, y: x.nan_to_num(nan=1.5, posinf=2.5, neginf=-3.5),
    "edge_frac": lambda x, y: torch.frac(x),
    "edge_ldexp": lambda x, y: torch.ldexp(x, torch.round(y)),
    "edge_ldexp_const": lambda x, y: torch.ldexp(x, torch.tensor(3.0, dtype=x.dtype)),
    "edge_nextafter": lambda x, y: torch.nextafter(x, y),
    "edge_heaviside": lambda x, y: torch.heaviside(x, y),
    "edge_heaviside_const": lambda x, y: x.heaviside(torch.tensor(0.5, dtype=x.dtype)),
    "edge_positive": lambda x, y: torch.positive(x),
    "edge_rsub": lambda x, y: torch.rsub(x, y),
    "edge_sgn": lambda x, y: torch.sgn(x),
    "edge_angle": lambda x, y: torch.angle(x),
    "edge_relu": lambda x, y: torch.relu(x),
    "edge_functional_relu": lambda x, y: torch.nn.functional.relu(y),
}


def _regime(f, x, y=None):
    """A special function on its own points: `f`, the points of x (and of y
    for a binary form) as lists, paired as given."""
    return f, x, x if y is None else y


_NAN, _INF = float("nan"), float("inf")
_POLES = [0.0, -0.0, -1.0, -2.0, -3.0, -10.0, _INF, -_INF, _NAN]


def _lin(lo, hi, n):
    return list(np.linspace(lo, hi, n))


#: torch's special functions on grids that reach every regime of their
#: algorithms (and their poles, infinities and NaN), held to relative 1e-13
#: in f64 and 1e-5 in f32 (NaN and the infinities exactly): digamma at
#: negative non-integers, at its poles and at 10 (its table's shortcut);
#: the incomplete gammas in their series, continued fraction, series of Q
#: and asymptotic (a ~ x, 20 < a < 200 and a > 200) regimes; the Bessel
#: functions both sides of 8 (i) and 5 (j); log_ndtr's erfcx tail
_A_IG = [0.1, 0.5, 1.0, 1.5, 2.5, 7.0, 19.5, 25.0, 60.0, 150.0, 250.0, 1000.0]
_X_IG = [0.05, 0.3, 0.5, 0.8, 1.05, 1.2, 2.0, 6.0, 21.0, 24.0, 27.0, 55.0, 66.0, 140.0,
         160.0, 240.0, 262.0, 980.0, 1100.0]
REGIME = {
    "regime_digamma": _regime(lambda x, y: torch.digamma(x),
                              _lin(-9.97, -0.013, 301) + _lin(0.013, 30.0, 300) + _POLES
                              + [10.0, 9.0, 1e-8, -1e-8, 1e16, 2e17]),
    "regime_trigamma": _regime(lambda x, y: torch.polygamma(1, x),
                               _lin(-9.97, -0.013, 151) + _lin(0.013, 30.0, 150) + _POLES),
    "regime_polygamma": _regime(lambda x, y: torch.special.polygamma(3, x),
                                _lin(-4.97, -0.013, 151) + _lin(0.013, 30.0, 150) + _POLES),
    "regime_zeta": _regime(lambda x, y: torch.special.zeta(x, y),
                           [1.0, 0.5, 2.0, 3.0, 4.0, 2.5, 1.5, 6.0, 3.0, 2.0, 7.0, 1.01, _NAN, 2.0]
                           + _lin(1.05, 12.0, 200),
                           [1.0, 1.0, -2.0, -2.5, -3.5, -0.5, 0.0, 0.5, 1e-3, 1e4, 30.0, 2.0, 1.0,
                            _NAN] + _lin(0.02, 40.0, 200)),
    "regime_igamma": _regime(lambda x, y: torch.special.gammainc(x, y),
                             [a for a in _A_IG for _ in _X_IG]
                             + [0.0, 0.0, 1.0, -1.0, 1.0, _INF, _INF, 2.0, _NAN],
                             [x for _ in _A_IG for x in _X_IG]
                             + [1.0, 0.0, 0.0, 1.0, -1.0, 1.0, _INF, _INF, 1.0]),
    "regime_igammac": _regime(lambda x, y: torch.special.gammaincc(x, y),
                              [a for a in _A_IG for _ in _X_IG]
                              + [0.0, 0.0, 1.0, -1.0, 1.0, _INF, _INF, 2.0, _NAN],
                              [x for _ in _A_IG for x in _X_IG]
                              + [1.0, 0.0, 0.0, 1.0, -1.0, 1.0, _INF, _INF, 1.0]),
    "regime_i0": _regime(lambda x, y: torch.i0(x), _lin(-30.0, 30.0, 241) + [_NAN, 8.0, -8.0]),
    "regime_i0e": _regime(lambda x, y: torch.special.i0e(x),
                          _lin(-60.0, 60.0, 241) + [_NAN, _INF, -_INF, 8.0]),
    "regime_i1": _regime(lambda x, y: torch.special.i1(x), _lin(-30.0, 30.0, 241) + [_NAN, 8.0]),
    "regime_i1e": _regime(lambda x, y: torch.special.i1e(x),
                          _lin(-60.0, 60.0, 241) + [_NAN, _INF, -_INF, 8.0]),
    "regime_modified_bessel_i0": _regime(lambda x, y: torch.special.modified_bessel_i0(x),
                                         _lin(-30.0, 30.0, 241) + [_NAN, 8.0]),
    "regime_modified_bessel_i1": _regime(lambda x, y: torch.special.modified_bessel_i1(x),
                                         _lin(-30.0, 30.0, 241) + [_NAN, 8.0]),
    "regime_bessel_j0": _regime(lambda x, y: torch.special.bessel_j0(x),
                                _lin(-40.0, 40.0, 321) + [_NAN, 5.0, 1e-6, _INF]),
    "regime_bessel_j1": _regime(lambda x, y: torch.special.bessel_j1(x),
                                _lin(-40.0, 40.0, 321) + [_NAN, 5.0, 1e-6, _INF]),
    "regime_ndtr": _regime(lambda x, y: torch.special.ndtr(x),
                           _lin(-8.0, 8.0, 201) + [_NAN, _INF, -_INF, 0.0]),
    "regime_log_ndtr": _regime(lambda x, y: torch.special.log_ndtr(x),
                               _lin(-60.0, 6.0, 331) + [-1.0, -40.0, -1e4, -1e9, _NAN, _INF,
                                                        -_INF, 0.0]),
    "regime_logit": _regime(lambda x, y: torch.logit(x),
                            _lin(0.013, 0.987, 101) + [0.0, 1.0, -0.5, 1.5, _NAN]),
    "regime_logit_eps": _regime(lambda x, y: torch.special.logit(x, eps=1e-3),
                                _lin(-0.5, 1.5, 101) + [0.0, 1.0, _NAN, _INF]),
    "regime_xlogy": _regime(lambda x, y: torch.xlogy(x, y),
                            _lin(-3.0, 3.0, 61) + [0.0, 0.0, 0.0, 1.0, _NAN, 2.0, 1.0],
                            _lin(0.01, 20.0, 61) + [0.0, _NAN, _INF, 0.0, 1.0, -1.0, _INF]),
    "regime_xlog1py": _regime(lambda x, y: torch.special.xlog1py(x, y),
                              _lin(-3.0, 3.0, 61) + [0.0, 0.0, 1.0, 1.0, 2.0],
                              _lin(-0.9, 20.0, 61) + [-1.0, _NAN, -1.0, _INF, -2.0]),
    "regime_entr": _regime(lambda x, y: torch.special.entr(x),
                           _lin(0.01, 20.0, 101) + [0.0, -0.0, -1.0, _NAN, _INF]),
    "regime_sinc": _regime(lambda x, y: torch.sinc(x),
                           _lin(-9.93, 9.93, 201) + [0.0, -0.0, _NAN, 1e-9]),
    "regime_logaddexp": _regime(lambda x, y: torch.logaddexp(x, y),
                                _lin(-50.0, 50.0, 101) + [_INF, -_INF, _INF, _NAN, 3.0],
                                _lin(-20.0, 60.0, 101) + [_INF, -_INF, -_INF, 1.0, -_INF]),
    "regime_logaddexp2": _regime(lambda x, y: torch.logaddexp2(x, y),
                                 _lin(-50.0, 50.0, 101) + [_INF, -_INF, _INF, _NAN, 3.0],
                                 _lin(-20.0, 60.0, 101) + [_INF, -_INF, -_INF, 1.0, -_INF]),
    "regime_selu": _regime(lambda x, y: torch.selu(x),
                           _lin(-20.0, 20.0, 201) + [0.0, -0.0, _NAN, _INF, -_INF]),
    "regime_celu": _regime(lambda x, y: torch.celu(x, alpha=0.7),
                           _lin(-20.0, 20.0, 201) + [0.0, -0.0, _NAN, _INF, -_INF]),
    "regime_functional_celu": _regime(lambda x, y: torch.nn.functional.celu(x, 1.3),
                                      _lin(-20.0, 20.0, 201) + [0.0, _NAN]),
    "regime_deg2rad": _regime(lambda x, y: torch.deg2rad(x),
                              _lin(-720.0, 720.0, 101) + [0.0, -0.0, _NAN, _INF]),
    "regime_rad2deg": _regime(lambda x, y: torch.rad2deg(x),
                              _lin(-20.0, 20.0, 101) + [0.0, -0.0, _NAN, _INF]),
    "regime_mvlgamma": _regime(lambda x, y: torch.mvlgamma(x, 4), _lin(1.51, 40.0, 101)),
}
#: the relative tolerance of the special functions (`REGIME` and the
#: special unit's terms) against torch on the host
SPECIAL_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
#: what a form's own formula allows beside it, as |got - want| ≤ tol |want|
#: + allowance: ndtr's (1 + erf(x/√2))/2 keeps only what is left of 1 in its
#: lower tail, so one ulp of erf (eps/2 near -1, another libm: torch's CPU
#: erf is SLEEF's) is an absolute eps/4 there; the incomplete gammas' far
#: tails are exp(a log x - x - lgamma(a)), whose rounding of an exponent of
#: size |ln want| moves them by that many ulps relative
def _exp_conditioning(want, eps):
    a = np.abs(want)
    return 4 * eps * a * np.abs(np.log(np.where(a > 0, a, 1.0)))


SPECIAL_ALLOWANCE = {
    "regime_ndtr": lambda want, eps: np.full_like(want, eps),
    "regime_igamma": _exp_conditioning,
    "regime_igammac": _exp_conditioning,
}
FORMS = {**SMOOTH, **EXACT, **EDGE, **{k: v[0] for k, v in REGIME.items()}}


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


def _edge_points(dtype, seed=23):
    """±0, ±inf, NaN, half-way and integral values, large and tiny ones in
    every pairing, then operands of either sign."""
    special = [0.0, -0.0, _INF, -_INF, _NAN, 0.5, -0.5, 1.5, -2.5, 1.0, -1.0, 3.0, 1e30,
               -1e30, 1e-3, 1e-40, -1e-40]
    xs, ys = zip(*[(a, b) for a in special for b in special])
    rng = np.random.default_rng(seed)
    n = N_POINTS - len(xs)
    x = np.concatenate([xs, rng.uniform(-20.0, 20.0, n)])
    y = np.concatenate([ys, rng.choice([-1.0, 1.0], n) * np.exp(rng.uniform(-5.0, 2.0, n))])
    return torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)


def _points(name, dtype):
    if name in REGIME:
        _, x, y = REGIME[name]
        return torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    if name in EDGE:
        return _edge_points(dtype)
    return _exact_points(dtype) if name in EXACT else _smooth_points(dtype)


def _special_agrees(got, want, tol, allowance=None, eps=0.0):
    """NaN where torch gives NaN, its infinities exactly, and the rest
    within `tol` relative (beside `allowance`, `SPECIAL_ALLOWANCE`); and
    the largest error as a share of what is allowed."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nan, inf = np.isnan(want), np.isinf(want)
    if not (np.array_equal(np.isnan(got), nan) and np.array_equal(got[inf], want[inf])):
        return False, float("inf")
    fin = ~(nan | inf)
    got, want = got[fin], want[fin]
    if not np.isfinite(got).all():
        return False, float("inf")
    bound = tol * np.abs(want) + (0.0 if allowance is None else allowance(want, eps))
    share = float((np.abs(got - want) / np.maximum(bound, 1e-300)).max(initial=0.0))
    return share <= 1.0, share


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
    if name in EXACT or name in EDGE or name in REGIME:
        x, y = _points(name, torch.float64)
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
    units = {_host_name(name, dtype): (
        codegen.numerical_unit(2, dtype, kernel_expr.trace(f, dtype)).cfg, dtype)
        for name, f in FORMS.items() for dtype in DTYPES.values()}
    return ch.kernel_library(tmp_path_factory.mktemp("kernel_expr_host"), units, ERFINV)


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
    if name in EXACT or name in EDGE:
        bad = ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
        assert _exactly_equal(got, want), (name, x[bad][:8], y[bad][:8], got[bad][:8],
                                           want[bad][:8])
        return
    if name in REGIME or name in tk.SPECIAL_TERMS or name == "special":
        ok, share = _special_agrees(got, want, SPECIAL_TOL[dtype], SPECIAL_ALLOWANCE.get(name),
                                    torch.finfo(dtype).eps)
        assert ok, (name, share)
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
    "polygamma": (lambda x, y: torch.polygamma(2, x), lambda x, y: x.polygamma(2)),
    "mvlgamma": (lambda x, y: torch.mvlgamma(x + 2.0, 3), lambda x, y: (x + 2.0).mvlgamma(3)),
    "logit": (lambda x, y: torch.logit(x, 0.2), lambda x, y: x.logit(0.2)),
    "nan_to_num": (lambda x, y: torch.nan_to_num(x, 1.0, 2.0, 3.0),
                   lambda x, y: x.nan_to_num(1.0, 2.0, 3.0)),
    **{m: (lambda x, y, m=m: torch.where(getattr(torch, m)(x - 5.0), x, y),
           lambda x, y, m=m: torch.where(getattr(x - 5.0, m)(), x, y))
       for m in ("isnan", "isinf", "isfinite", "isposinf", "isneginf", "signbit")},
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
                   "expit": "sigmoid", "digamma": "digamma", "psi": "digamma", "i0": "i0",
                   "logit": "logit", "sinc": "sinc", "xlogy": "xlogy", "gammainc": "igamma",
                   "gammaincc": "igammac", "polygamma": "polygamma",
                   "multigammaln": "mvlgamma"}
#: how each alias is called, where not on 0.5 x alone
_ALIAS_CALLS = {"xlogy": lambda f: lambda x, y: f(0.5 * x, y),
                "gammainc": lambda f: lambda x, y: f(0.5 * x, y),
                "gammaincc": lambda f: lambda x, y: f(0.5 * x, y),
                "polygamma": lambda f: lambda x, y: f(2, 0.5 * x),
                "multigammaln": lambda f: lambda x, y: f(0.5 * x, 2)}


@pytest.mark.parametrize("name", sorted(SPECIAL_ALIASES))
def test_special_alias_traces_as_its_torch_name(name):
    special, plain = getattr(torch.special, name), getattr(torch, SPECIAL_ALIASES[name])
    assert special is not plain  # found by identity, not by __name__
    call = _ALIAS_CALLS.get(name, lambda f: lambda x, y: f(0.5 * x))
    assert _text(call(special)) == _text(call(plain))


#: torch.nn.functional's forms of covered torch functions
FUNCTIONAL = {"relu": (lambda x, y: torch.nn.functional.relu(x), lambda x, y: torch.relu(x)),
              "selu": (lambda x, y: torch.nn.functional.selu(x), lambda x, y: torch.selu(x)),
              "celu": (lambda x, y: torch.nn.functional.celu(x, 0.5),
                       lambda x, y: torch.celu(x, 0.5))}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_special_alias_traces_as_its_torch_name_functional(name):
    functional, plain = FUNCTIONAL[name]
    assert _text(functional) == _text(plain)


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
    "no_device_version": (lambda x, y: torch.special.ndtri(x + y), "torch.special.ndtri"),
    "add_alpha": (lambda x, y: torch.add(x, y, alpha=2.0), "torch.add with alpha"),
    # what JAX's kernel refuses (ndtri, above) or has no counterpart of
    "no_jax_erfcx": (lambda x, y: torch.special.erfcx(x), "torch.special.erfcx"),
    "no_jax_bessel_y0": (lambda x, y: torch.special.bessel_y0(x), "torch.special.bessel_y0"),
    "no_jax_bessel_y1": (lambda x, y: torch.special.bessel_y1(x), "torch.special.bessel_y1"),
    "no_jax_modified_bessel_k0": (lambda x, y: torch.special.modified_bessel_k0(x),
                                  "torch.special.modified_bessel_k0"),
    "no_jax_scaled_modified_bessel_k1": (
        lambda x, y: torch.special.scaled_modified_bessel_k1(x),
        "torch.special.scaled_modified_bessel_k1"),
    "no_jax_spherical_bessel_j0": (lambda x, y: torch.special.spherical_bessel_j0(x),
                                   "torch.special.spherical_bessel_j0"),
    "no_jax_airy_ai": (lambda x, y: torch.special.airy_ai(x), "torch.special.airy_ai"),
    "no_jax_polynomial": (lambda x, y: torch.special.chebyshev_polynomial_t(x, 3),
                          "torch.special.chebyshev_polynomial_t"),
    "loss": (lambda x, y: torch.nn.functional.mse_loss(x, y), "torch.nn.functional.mse_loss"),
    "isclose": (lambda x, y: torch.where(torch.isclose(x, y), x, y), "torch.isclose"),
    "isin": (lambda x, y: torch.where(torch.isin(x, y), x, y), "torch.isin"),
    "functional_only": (lambda x, y: torch.nn.functional.tanhshrink(x),
                        "torch.nn.functional.tanhshrink"),
    "functional_in_place": (lambda x, y: torch.nn.functional.relu(x, inplace=True),
                            "in-place torch.nn.functional"),
    # an integer argument that is an operand
    "polygamma_order_operand": (lambda x, y: torch.polygamma(x, y), "polygamma's order n"),
    "mvlgamma_p_operand": (lambda x, y: torch.mvlgamma(x, y), "mvlgamma's p"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_form_names_itself(name):
    f, what = REFUSED[name]
    with pytest.raises(kernel_expr.KernelTraceError, match=what):
        kernel_expr.trace(f)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", ["tensor", "lambda", "efficiency", "coverage"])
def test_emitted_text_of_the_earlier_cases_is_unchanged(case, dtype):
    """The units of the tensor and lambda cases, and of `efficiency` and
    `coverage`: their traced K (``cloudy_kernel_gen``) is the text built
    before the tracer took more forms (the cfg.cuh without its factored
    form, SHA-256 as pinned then: a helper is emitted only where a trace
    calls it), and the whole cfg.cuh, with the factored form R is taken
    from (`kernel_expr.factored_source`), is pinned too."""
    traced_k = {
        ("tensor", torch.float32): "12f7cd4579f7fb9ca68fb1b91e6dd9bbdd0464f5381dd73fa9fdc18533eeaa13",
        ("tensor", torch.float64): "d605a6a2034a317aad2fd8c5b1ead5cd1e38489e5c4096866562f55915f47cc7",
        ("lambda", torch.float32): "1af70703dbb0b2626a431e20c3245880b062099aec4806f5909769fef74dbe06",
        ("lambda", torch.float64): "eea5985dda5ad88c02c041504c35c82bb592481c0c1731619462bf0a977376b3",
        ("efficiency", torch.float32):
            "3e9828be7c358f67aae18c771273e3a6ba1dd5bf1795a72080ca9692be4dbc34",
        ("efficiency", torch.float64):
            "dfb4601b9788efd855106f831bd45597782284a2100444e397828f084572946d",
        ("coverage", torch.float32):
            "ac18eee70a133020611b642f6f5ead65e6f728b394039fee50e064d496903919",
        ("coverage", torch.float64):
            "d78f1c3f4287bb59896385cac9f1de4745da6c45967dfebaf19e2956e4b84b2b",
    }
    pinned = {
        ("tensor", torch.float32): "fde17533202f7d91dbaf4be1f87f85929f3420546d4378f784c6af086fe68730",
        ("tensor", torch.float64): "7b44444820aa10a4ce0d13564126b6ac302d362573be85730fdc91024c70c44a",
        ("lambda", torch.float32): "49773a677949eb795b298b18b3c72b529f75a97b0312b5ba1290eadf3a482f77",
        ("lambda", torch.float64): "a1647d8e9f3095c13a3635bb2fe69e1350dab72e676e27f10ef104eaec3f0c98",
        ("efficiency", torch.float32):
            "03d10dd4b1b6074f3e9e4c5bf2e7ea0105d44c6d96af3a356b63026d6048b997",
        ("efficiency", torch.float64):
            "8327a84209fc6b14491d2fb06a383288fe2b6b5912927ce11309987afbb9b465",
        ("coverage", torch.float32):
            "80bf1efdad9207d9a61d4c2cc3e4039114cde21880624f39be24d9153b516b56",
        ("coverage", torch.float64):
            "1103a00ecd450ea155a00689993a2a3df97fe44691016cdbf1976f3cebb98817",
    }
    kf = tk.KERNELS[case] if case in tk.KERNELS else CASES[case]()[0]
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), kf, device="cpu", dtype=dtype)
    cfg = fn.unit.cfg
    start, end = cfg.index("// K(x, y) = sum_i"), cfg.index("}  // namespace cloudy")
    assert hashlib.sha256((cfg[:start] + cfg[end:]).encode()).hexdigest() == traced_k[case, dtype]
    assert hashlib.sha256(cfg.encode()).hexdigest() == pinned[case, dtype]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_emitted_text_of_the_earlier_cases_is_unchanged_special_header(dtype):
    """The special unit includes special_functions.cuh; the others do not."""
    cfg = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), tk.special, device="cpu",
                               dtype=dtype).unit.cfg
    assert '#include "special_functions.cuh"' in cfg and "dgammainc(" in cfg
    for name in ("efficiency", "coverage"):
        other = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), tk.KERNELS[name], device="cpu",
                                     dtype=dtype).unit.cfg
        assert "special_functions.cuh" not in other


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


#: the JAX twins of `tools.traced_kernels.SPECIAL_TERMS`, by the same names:
#: the counterparts JAX's kernel takes (jnp.ldexp takes an integer
#: exponent, so the operand case is v 2**u; frac is u - trunc(u))
J_SPECIAL = {
    "xlogy": lambda u, v: jsp.xlogy(u, 2.0 + v),
    "special_xlogy": lambda u, v: jsp.xlogy(v, 1.5 + u),
    "xlog1py": lambda u, v: jsp.xlog1py(u, v),
    "entr": lambda u, v: jsp.entr(0.1 + 0.3 * u),
    "logit": lambda u, v: jsp.logit(0.55 + 0.4 * u),
    "logit_eps": lambda u, v: jsp.logit(jnp.clip(0.5 + 0.5 * v, 0.1, 0.9)),
    "special_logit": lambda u, v: jsp.logit(0.6 + 0.3 * v),
    "sinc": lambda u, v: jnp.sinc(0.5 * u),
    "special_sinc": lambda u, v: jnp.sinc(0.5 * v),
    "logaddexp": lambda u, v: jnp.logaddexp(u, v),
    "logaddexp2": lambda u, v: jnp.logaddexp2(u, -v),
    "heaviside": lambda u, v: jnp.heaviside(u + 0.5, 0.5),
    "heaviside_operand": lambda u, v: 1.0 + jnp.heaviside(-0.5 - v, u),
    "deg2rad": lambda u, v: jnp.deg2rad(30.0 * u),
    "rad2deg": lambda u, v: jnp.rad2deg(0.02 * v),
    "frac": lambda u, v: (0.5 * u + 2.25) - jnp.trunc(0.5 * u + 2.25),
    "ldexp": lambda u, v: jnp.ldexp(u, -1),
    "ldexp_operand": lambda u, v: v * jnp.exp2(u),
    "nextafter": lambda u, v: jnp.nextafter(u, 2.0),
    "positive": lambda u, v: jnp.positive(v),
    "rsub": lambda u, v: 2.0 - u,
    "sgn": lambda u, v: 2.0 + jnp.sign(-0.5 - u),
    "angle": lambda u, v: jnp.angle(-0.5 - v) + jnp.angle(u + 0.5),
    "relu": lambda u, v: jax.nn.relu(u + 0.1),
    "selu": lambda u, v: 1.0 + jax.nn.selu(u - 0.5),
    "celu": lambda u, v: 1.0 + jax.nn.celu(v - 0.5, alpha=0.5),
    "isnan": lambda u, v: jnp.where(jnp.isnan(u), 0.0, u),
    "isinf": lambda u, v: jnp.where(jnp.isinf(v), 0.0, v),
    "isfinite": lambda u, v: jnp.where(jnp.isfinite(u), v, 0.0),
    "isposinf": lambda u, v: jnp.where(jnp.isposinf(u), 0.0, 1.0 - u),
    "isneginf": lambda u, v: jnp.where(jnp.isneginf(v), 0.0, 1.0 - v),
    "signbit": lambda u, v: jnp.where(jnp.signbit(-0.5 - u), 1.0, 0.0),
    "nan_to_num": lambda u, v: jnp.nan_to_num(u),
    "nan_to_num_values": lambda u, v: jnp.nan_to_num(v, nan=0.0, posinf=1.0, neginf=-1.0),
    "ndtr": lambda u, v: jsp.ndtr(u - 0.5),
    "log_ndtr_tail": lambda u, v: -jsp.log_ndtr(-1.5 - u),
    "log_ndtr": lambda u, v: -jsp.log_ndtr(v),
    "digamma": lambda u, v: jsp.digamma(1.5 + u),
    "special_digamma": lambda u, v: jsp.digamma(2.0 + v),
    "psi": lambda u, v: jsp.digamma(3.0 + u),
    "digamma_reflection": lambda u, v: jsp.digamma(-0.5 + 0.2 * v),
    "polygamma": lambda u, v: 30.0 * jsp.polygamma(1, 30.0 + u),
    "special_polygamma": lambda u, v: -jsp.polygamma(2, 1.0 + v),
    "polygamma_method": lambda u, v: jsp.polygamma(3, 2.0 + u),
    "zeta": lambda u, v: jsp.zeta(2.0 + u, 1.0 + v),
    "igamma": lambda u, v: jsp.gammainc(1.0 + u, 0.5 + v),
    "gammainc": lambda u, v: jsp.gammainc(2.0 + v, 1.0 + u),
    "gammainc_asymptotic": lambda u, v: jsp.gammainc(1e4 + 100.0 * u, 1e4 + 100.0 * v),
    "igammac": lambda u, v: jsp.gammaincc(1.5 + v, 2.0 + u),
    "gammaincc": lambda u, v: jsp.gammaincc(0.5 + u, 0.25 + v),
    "mvlgamma": lambda u, v: jsp.multigammaln(2.0 + u, 2),
    "multigammaln": lambda u, v: jsp.multigammaln(2.5 + v, 3),
    "i0": lambda u, v: jsp.i0(u),
    "special_i0": lambda u, v: jsp.i0(v),
    "i0e": lambda u, v: jsp.i0e(2.0 * u),
    "i0e_large": lambda u, v: 3.0 * jsp.i0e(9.0 + v),
    "i1": lambda u, v: jsp.i1(u),
    "i1e": lambda u, v: jsp.i1e(v),
    "modified_bessel_i0": lambda u, v: jsp.i0(u),
    "modified_bessel_i1": lambda u, v: jsp.i1(v),
    "bessel_j0": lambda u, v: jsp.bessel_jn(0.1 + 2.0 * u, v=0)[0],
    "bessel_j0_large": lambda u, v: 1.0 + jsp.bessel_jn(20.0 + v, v=0)[0],
    "bessel_j1": lambda u, v: jsp.bessel_jn(0.1 + 2.0 * v, v=1)[1],
    "bessel_j1_large": lambda u, v: 1.0 + jsp.bessel_jn(20.0 + u, v=1)[1],
}


@jax.jit
def _jspecial_flat(x, y):
    u, v = x / (1.0 + x), y / (1.0 + y)
    return 1e-3 * functools.reduce(lambda a, b: a + b, (J_SPECIAL[k](u, v)
                                                         for k in tk.SPECIAL_TERMS))


def _jspecial(x, y):
    """The JAX twin of `tools.traced_kernels.special` on the einsum path's
    arrays, flattened and padded to one length: XLA compiles the 63 terms
    once (~10 s) instead of once per array shape (~35 s)."""
    x, y = jnp.broadcast_arrays(x, y)
    n = x.size
    size = max(1 << 15, 1 << (n - 1).bit_length())

    def pad(a):
        return jnp.pad(a.ravel(), (0, size - n), constant_values=1.0)

    return _jspecial_flat(pad(x), pad(y))[:n].reshape(x.shape)


#: the JAX twins of `tools.traced_kernels.ACTIVATION_TERMS`, by the same
#: names: `jax.nn`'s counterparts, each naming its mode where the two
#: differ (jax.nn.gelu defaults to the tanh form, F.gelu to erf; torch's
#: softplus switches to x past beta x > threshold, JAX's is logaddexp(x, 0):
#: the thresholded term's twin makes the switch itself, and the other two
#: stay below theirs); hardtanh with other bounds is jnp.clip
J_ACTIVATIONS = {
    "softplus": lambda u, v: jax.nn.softplus(4.0 * u - 2.0),
    "softplus_threshold": lambda u, v: jnp.where(6.0 * (8.0 * v - 4.0) > 20.0, 8.0 * v - 4.0,
                                                 jax.nn.softplus(6.0 * (8.0 * v - 4.0)) / 6.0),
    "softplus_module": lambda u, v: jax.nn.softplus(2.0 * (4.0 * (u - v))) / 2.0,
    "gelu": lambda u, v: 0.2 + jax.nn.gelu(4.0 * u - 2.0, approximate=False),
    "gelu_tanh": lambda u, v: 0.2 + jax.nn.gelu(8.0 * v - 4.0, approximate=True),
    "silu": lambda u, v: 0.3 + jax.nn.silu(8.0 * u - 4.0),
    "mish": lambda u, v: 0.31 + jax.nn.mish(4.0 * (u - v)),
    "elu": lambda u, v: 1.0 + jax.nn.elu(4.0 * v - 2.0, alpha=0.5),
    "leaky_relu": lambda u, v: 1.0 + jax.nn.leaky_relu(4.0 * u - 2.0, 0.2),
    "hardtanh": lambda u, v: 1.0 + jax.nn.hard_tanh(4.0 * v - 2.0),
    "hardtanh_bounds": lambda u, v: 0.5 + jnp.clip(4.0 * (u - v), -0.5, 2.0),
    "relu6": lambda u, v: jax.nn.relu6(8.0 * u - 1.0),
    "hardsigmoid": lambda u, v: jax.nn.hard_sigmoid(8.0 * v - 4.0),
    "hardswish": lambda u, v: 0.375 + jax.nn.hard_swish(8.0 * u - 4.0),
    "logsigmoid": lambda u, v: -jax.nn.log_sigmoid(4.0 * v - 2.0),
    "softsign": lambda u, v: 1.0 + jax.nn.soft_sign(4.0 * (v - u)),
}


def _jactivations(x, y):
    """The JAX twin of `tools.traced_kernels.activations`."""
    u, v = x / (1.0 + x), y / (1.0 + y)
    return 1e-3 * functools.reduce(lambda a, b: a + b, (J_ACTIVATIONS[k](u, v)
                                                         for k in tk.ACTIVATION_TERMS))


JAX_KERNELS = {"efficiency": _jefficiency, "coverage": _jcoverage, "special": _jspecial,
               "activations": _jactivations}
#: (boxes, outer nodes, inner nodes) of each kernel's twin against JAX's
#: einsum path: `special`'s JAX twin takes ~19 s at (128, 64, 32)
EINSUM_SIZE = {"special": (32, 32, 16)}


def test_jax_twins_name_every_coverage_term():
    assert list(J_TERMS) == list(tk.COVERAGE_TERMS)


def test_jax_twins_name_every_special_term():
    assert list(J_SPECIAL) == list(tk.SPECIAL_TERMS)


@pytest.mark.parametrize("name", sorted(tk.KERNELS))
def test_twin_matches_jax_einsum(name):
    n_box, n_outer, n_inner = EINSUM_SIZE.get(name, (128, 64, 32))
    mom = _moments(TWO_GAMMA, n_box, seed=7)
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), tk.KERNELS[name], n_outer, n_inner,
                              device="cpu", dtype=torch.float64)
    assert fn.plan.ktag == nc.KT_GEN and "cloudy_kernel_gen" in fn.unit.cfg
    got = fn(torch.as_tensor(mom)).numpy()
    want = _jax_einsum(JAX_KERNELS[name], mom, n_outer, n_inner)
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


#: the closed forms, masks and cleanups of `SPECIAL_TERMS` that go
#: through JAX's Pallas kernel in interpret mode within the test's budget
CLOSED_SUBSET = ("xlogy", "xlog1py", "entr", "logit", "sinc", "logaddexp", "heaviside",
                 "frac", "isfinite", "nan_to_num", "ndtr", "selu")


def _closed_subset(x, y):
    u, v = tk.unit_interval(x), tk.unit_interval(y)
    return 1e-3 * functools.reduce(operator.add, (tk.SPECIAL_TERMS[k](u, v)
                                                  for k in CLOSED_SUBSET))


def _jclosed_subset(x, y):
    u, v = x / (1.0 + x), y / (1.0 + y)
    return 1e-3 * functools.reduce(lambda a, b: a + b, (J_SPECIAL[k](u, v)
                                                         for k in CLOSED_SUBSET))


def test_closed_forms_twin_matches_pallas_interpret():
    """JAX's Pallas kernel evaluates the closed forms, masks and cleanups
    inside its body; the port's twin the same quadrature (B = 8, nodes
    (16, 8))."""
    mom = _moments(TWO_GAMMA, 8, seed=9)
    pfn = pn.make_pallas_numerical_fn(JSpec((JFamily.GAMMA, JFamily.GAMMA)), _jclosed_subset,
                                      n_outer=16, n_inner=8, block_cols=8, interpret=True)
    want = np.asarray(pfn(jnp.asarray(mom)))
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), _closed_subset, 16, 8, device="cpu",
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
