"""Four kernel functions K(x, y) that B5's traced arm (`ops.kernel_expr`,
the ``KT_GEN`` arm of csrc/numerical_coalescence.cu) is checked and timed
with, beside the Long kernel fitted as a tensor and a sqrt lambda
(`traced`: `chip_smoke.py` phase 30, `tools.traced_tune`,
tests/test_torch_kernel_expr.py, tests/test_torch_cuda_kernels.py), and
what those check and time them by (`NUM_TOL`, `CAPPED`).

- `efficiency`: a collision kernel with a smooth collection efficiency, the
  kind users write (turbulence enhancement through erf and tanh), in
  `torch.mul` and method forms;
- `coverage`: one unit that calls every elementwise form the tracer covers,
  a sum of small non-negative terms (`COVERAGE_TERMS`), each on arguments
  inside its function's domain (away from the jumps of the rounding forms)
  and of order one, so that nothing cancels: one unit per type instead of
  one per form;
- `special`: the same for the special functions, closed forms, masks and
  cleanups the tracer took after `coverage` (`SPECIAL_TERMS`): the normal
  distribution, the gamma family (digamma, polygamma, zeta, the incomplete
  gammas, mvlgamma), the Bessel functions, and each in every regime its
  algorithm switches between;
- `activations`: the same for `torch.nn.functional`'s activations with a
  `jax.nn` counterpart (`ACTIVATION_TERMS`), each on arguments of both
  signs that reach every piece of it (softplus past its threshold, the
  bounds of hardtanh, ±3 of hardsigmoid and hardswish), some on u and v
  together, so that they also stay in the pair loop of B5's factored arm,
  and one through an `nn.Module`.
"""

from __future__ import annotations

import functools
import operator

import torch
import torch.nn.functional as F


def efficiency(x, y):
    """1e-3 (x + y) · ½(1 + tanh(log1p(x) − y)) · erf(xy + 0.1)."""
    return torch.mul(1e-3 * (x + y), 0.5 * (1 + (x.log1p() - y).tanh())) * torch.special.erf(
        x * y + 0.1)


def _pow3(u, v):
    # a 0-d tensor on the left of ** reaches torch.Tensor.pow
    return torch.tensor(3.0, dtype=u.dtype, device=u.device) ** u


#: one term per covered form, of (u, v) in [0, 1]: non-negative, of order one
COVERAGE_TERMS = {
    # arithmetic through functions, methods, operators and 0-d tensors
    "add": lambda u, v: torch.add(u, v),
    "sub": lambda u, v: torch.sub(2.0, u),
    "mul": lambda u, v: torch.mul(u, v),
    "div": lambda u, v: torch.div(u, 1.0 + v),
    "div_floor": lambda u, v: torch.div(0.5 * u + 2.25, 1.0, rounding_mode="floor"),
    "div_trunc": lambda u, v: torch.div(0.5 * v + 2.25, 1.0, rounding_mode="trunc"),
    "true_divide": lambda u, v: torch.true_divide(v, 1.0 + u),
    "neg": lambda u, v: torch.neg(u - 1.5),
    "square": lambda u, v: torch.square(v),
    "reciprocal": lambda u, v: torch.reciprocal(1.0 + u),
    "tensor_mul": lambda u, v: torch.tensor(0.5) * u,
    "tensor_sub": lambda u, v: torch.tensor(2.0) - v,
    "tensor_div": lambda u, v: torch.tensor(1.0) / (1.0 + v),
    "tensor_pow": _pow3,
    "pow": lambda u, v: torch.pow(1.0 + u, v),
    "pow_method": lambda u, v: (1.0 + v).pow(1.5),
    "ones_like": lambda u, v: 0.5 * torch.ones_like(u),
    "zeros_like": lambda u, v: torch.zeros_like(v) + v,
    "full_like": lambda u, v: torch.full_like(u, 0.3),
    "as_tensor": lambda u, v: torch.as_tensor(0.7, dtype=u.dtype, device=u.device) * v,
    "clamp": lambda u, v: u.clamp(min=0.1, max=0.9),
    "clamp_min": lambda u, v: torch.clamp_min(u, 0.25),
    "clamp_max": lambda u, v: torch.clamp_max(v, 0.75),
    "minimum": lambda u, v: torch.minimum(u, v),
    "maximum": lambda u, v: torch.maximum(u, v),
    "fmin": lambda u, v: torch.fmin(u, 1.0 - v),
    "fmax": lambda u, v: torch.fmax(u, v),
    "where": lambda u, v: torch.where(u > v, u - v, v - u),
    "where_method": lambda u, v: u.where(u < 0.5, 1.0 - u),
    "abs": lambda u, v: torch.abs(u - v),
    "exp": lambda u, v: (-u).exp(),
    "log": lambda u, v: torch.log(1.0 + v),
    "sqrt": lambda u, v: torch.sqrt(u),
    "rsqrt": lambda u, v: torch.rsqrt(1.0 + v),
    # trigonometric and hyperbolic
    "sin": lambda u, v: torch.sin(u),
    "cos": lambda u, v: torch.cos(v),
    "tan": lambda u, v: torch.tan(u),
    "asin": lambda u, v: torch.asin(0.9 * u),
    "acos": lambda u, v: torch.acos(0.9 * v),
    "atan": lambda u, v: torch.atan(u),
    "atan2": lambda u, v: torch.atan2(u, 1.0 + v),
    "sinh": lambda u, v: torch.sinh(u),
    "cosh": lambda u, v: torch.cosh(v),
    "tanh": lambda u, v: u.tanh(),
    "asinh": lambda u, v: torch.asinh(v),
    "acosh": lambda u, v: torch.acosh(2.0 + u),
    "atanh": lambda u, v: torch.atanh(0.5 * v),
    # error and gamma
    "erf": lambda u, v: torch.erf(u),
    "erfc": lambda u, v: torch.erfc(v),
    "erfinv": lambda u, v: torch.erfinv(0.9 * u),
    "lgamma": lambda u, v: torch.lgamma(3.0 + v),
    # exponentials and logarithms
    "expm1": lambda u, v: torch.expm1(u),
    "log1p": lambda u, v: torch.log1p(v),
    "exp2": lambda u, v: torch.exp2(u),
    "log2": lambda u, v: torch.log2(2.0 + v),
    "log10": lambda u, v: torch.log10(10.0 + 10.0 * u),
    "hypot": lambda u, v: torch.hypot(u, v),
    # rounding, sign and modulus, on arguments that keep a unit interval
    # between two of their jumps (the quadrature places its nodes an ulp
    # apart in the kernel and the twin, and a jump between them is a step
    # in K of order one: a discontinuous K is no kernel to hold in f32);
    # tests/test_torch_kernel_expr.py holds them across their jumps
    "floor": lambda u, v: torch.floor(0.5 * u + 2.25),
    "ceil": lambda u, v: torch.ceil(0.5 * v + 2.25),
    "trunc": lambda u, v: torch.trunc(0.5 * v + 2.25),
    "round": lambda u, v: torch.round(0.4 * v + 2.05),
    "sign": lambda u, v: 2.0 + torch.sign(-0.5 - u),
    "copysign": lambda u, v: 1.0 + torch.copysign(u, -0.5 - v),
    "fmod": lambda u, v: torch.fmod(0.5 * u + 2.25, 1.0),
    "remainder": lambda u, v: torch.remainder(-0.5 * v - 1.25, 1.0),
    "floor_divide": lambda u, v: 3.0 + torch.floor_divide(-0.5 * u - 1.25, 1.0),
    "mod_operator": lambda u, v: (0.5 * v + 2.25) % 1.0,
    "floordiv_operator": lambda u, v: (0.5 * u + 2.25) // 1.0,
    "sigmoid": lambda u, v: torch.sigmoid(u),
    # torch.special's names
    "special_expm1": lambda u, v: torch.special.expm1(v),
    "special_log1p": lambda u, v: torch.special.log1p(u),
    "special_erf": lambda u, v: torch.special.erf(v),
    "special_erfc": lambda u, v: torch.special.erfc(u),
    "special_erfinv": lambda u, v: torch.special.erfinv(0.9 * v),
    "special_exp2": lambda u, v: torch.special.exp2(v),
    "special_gammaln": lambda u, v: torch.special.gammaln(3.0 + u),
    "special_round": lambda u, v: torch.special.round(0.4 * u + 2.05),
    "special_expit": lambda u, v: torch.special.expit(v),
}


def _ldexp_const(u, v):
    return torch.ldexp(u, torch.tensor(-1.0, dtype=u.dtype, device=u.device))


def _nextafter(u, v):
    return torch.nextafter(u, torch.tensor(2.0, dtype=u.dtype, device=u.device))


def _heaviside_const(u, v):
    return torch.heaviside(u + 0.5, torch.tensor(0.5, dtype=u.dtype, device=u.device))


#: one term per form the tracer added for `special`, of (u, v) in [0, 1):
#: non-negative, of order one, each inside its function's domain; the
#: masks, heaviside, signbit, frac and nextafter a unit away from their
#: jumps (as `COVERAGE_TERMS`' rounding forms); the incomplete gammas'
#: series, continued fraction, series of Q and asymptotic regimes,
#: digamma's reflection, the Bessel functions' both ranges and log_ndtr's
#: erfcx tail reached by some (u, v). Three of torch's algorithms are less
#: accurate than JAX's counterparts in part of their range (trigamma below
#: ~30, its 6-term asymptotic series: 5e-10 relative; the incomplete
#: gammas' asymptotic regime, whose 1/sqrt(2 pi a) takes pi in float: 6e-10
#: at a = 25; bessel_j0/j1 just above 5: 1e-7): their terms sit where the
#: two agree to the quadrature's 1e-12, and tests/test_torch_kernel_expr.py
#: holds the port to torch across the rest
SPECIAL_TERMS = {
    # closed forms
    "xlogy": lambda u, v: torch.xlogy(u, 2.0 + v),
    "special_xlogy": lambda u, v: torch.special.xlogy(v, 1.5 + u),
    "xlog1py": lambda u, v: torch.special.xlog1py(u, v),
    "entr": lambda u, v: torch.special.entr(0.1 + 0.3 * u),
    "logit": lambda u, v: torch.logit(0.55 + 0.4 * u),
    "logit_eps": lambda u, v: (0.5 + 0.5 * v).logit(eps=0.1),
    "special_logit": lambda u, v: torch.special.logit(0.6 + 0.3 * v),
    "sinc": lambda u, v: torch.sinc(0.5 * u),
    "special_sinc": lambda u, v: torch.special.sinc(0.5 * v),
    "logaddexp": lambda u, v: torch.logaddexp(u, v),
    "logaddexp2": lambda u, v: torch.logaddexp2(u, -v),
    "heaviside": _heaviside_const,
    "heaviside_operand": lambda u, v: 1.0 + torch.heaviside(-0.5 - v, u),
    "deg2rad": lambda u, v: torch.deg2rad(30.0 * u),
    "rad2deg": lambda u, v: torch.rad2deg(0.02 * v),
    "frac": lambda u, v: torch.frac(0.5 * u + 2.25),
    "ldexp": _ldexp_const,
    "ldexp_operand": lambda u, v: torch.ldexp(v, u),
    "nextafter": _nextafter,
    "positive": lambda u, v: torch.positive(v),
    "rsub": lambda u, v: torch.rsub(u, 2.0),
    "sgn": lambda u, v: 2.0 + torch.sgn(-0.5 - u),
    "angle": lambda u, v: torch.angle(-0.5 - v) + torch.angle(u + 0.5),
    "relu": lambda u, v: torch.relu(u + 0.1),
    "selu": lambda u, v: 1.0 + torch.selu(u - 0.5),
    "celu": lambda u, v: 1.0 + torch.celu(v - 0.5, alpha=0.5),
    # masks and cleanup
    "isnan": lambda u, v: torch.where(torch.isnan(u), 0.0, u),
    "isinf": lambda u, v: torch.where(torch.isinf(v), 0.0, v),
    "isfinite": lambda u, v: torch.where(torch.isfinite(u), v, 0.0),
    "isposinf": lambda u, v: torch.where(torch.isposinf(u), 0.0, 1.0 - u),
    "isneginf": lambda u, v: torch.where(v.isneginf(), 0.0, 1.0 - v),
    "signbit": lambda u, v: torch.where(torch.signbit(-0.5 - u), 1.0, 0.0),
    "nan_to_num": lambda u, v: torch.nan_to_num(u),
    "nan_to_num_values": lambda u, v: torch.nan_to_num(v, nan=0.0, posinf=1.0, neginf=-1.0),
    # the normal distribution
    "ndtr": lambda u, v: torch.special.ndtr(u - 0.5),
    "log_ndtr_tail": lambda u, v: -torch.special.log_ndtr(-1.5 - u),
    "log_ndtr": lambda u, v: -torch.special.log_ndtr(v),
    # the gamma family
    "digamma": lambda u, v: torch.digamma(1.5 + u),
    "special_digamma": lambda u, v: torch.special.digamma(2.0 + v),
    "psi": lambda u, v: torch.special.psi(3.0 + u),
    "digamma_reflection": lambda u, v: torch.digamma(-0.5 + 0.2 * v),
    "polygamma": lambda u, v: 30.0 * torch.polygamma(1, 30.0 + u),
    "special_polygamma": lambda u, v: -torch.special.polygamma(2, 1.0 + v),
    "polygamma_method": lambda u, v: (2.0 + u).polygamma(3),
    "zeta": lambda u, v: torch.special.zeta(2.0 + u, 1.0 + v),
    "igamma": lambda u, v: torch.igamma(1.0 + u, 0.5 + v),
    "gammainc": lambda u, v: torch.special.gammainc(2.0 + v, 1.0 + u),
    "gammainc_asymptotic": lambda u, v: torch.special.gammainc(1e4 + 100.0 * u,
                                                               1e4 + 100.0 * v),
    "igammac": lambda u, v: torch.igammac(1.5 + v, 2.0 + u),
    "gammaincc": lambda u, v: torch.special.gammaincc(0.5 + u, 0.25 + v),
    "mvlgamma": lambda u, v: torch.mvlgamma(2.0 + u, p=2),
    "multigammaln": lambda u, v: torch.special.multigammaln(2.5 + v, 3),
    # Bessel functions
    "i0": lambda u, v: torch.i0(u),
    "special_i0": lambda u, v: torch.special.i0(v),
    "i0e": lambda u, v: torch.special.i0e(2.0 * u),
    "i0e_large": lambda u, v: 3.0 * torch.special.i0e(9.0 + v),
    "i1": lambda u, v: torch.special.i1(u),
    "i1e": lambda u, v: torch.special.i1e(v),
    "modified_bessel_i0": lambda u, v: torch.special.modified_bessel_i0(u),
    "modified_bessel_i1": lambda u, v: torch.special.modified_bessel_i1(v),
    "bessel_j0": lambda u, v: torch.special.bessel_j0(0.1 + 2.0 * u),
    "bessel_j0_large": lambda u, v: 1.0 + torch.special.bessel_j0(20.0 + v),
    "bessel_j1": lambda u, v: torch.special.bessel_j1(0.1 + 2.0 * v),
    "bessel_j1_large": lambda u, v: 1.0 + torch.special.bessel_j1(20.0 + u),
}


def special(x, y):
    """1e-3 times the sum of `SPECIAL_TERMS` at u = x/(1 + x), v = y/(1 + y)."""
    u, v = unit_interval(x), unit_interval(y)
    return 1e-3 * functools.reduce(operator.add, (t(u, v) for t in SPECIAL_TERMS.values()))


def unit_interval(x):
    """x / (1 + x): a mass in [0, 1)."""
    return x / (1.0 + x)


def coverage(x, y):
    """1e-3 times the sum of `COVERAGE_TERMS` at u = x/(1 + x), v = y/(1 + y)."""
    u, v = unit_interval(x), unit_interval(y)
    return 1e-3 * functools.reduce(operator.add, (t(u, v) for t in COVERAGE_TERMS.values()))


#: one term per activation, of (u, v) in [0, 1): non-negative, of order
#: one (each shifted by its least value); torch's softplus switches to x
#: past beta x > threshold, reached here at beta 6 (8v - 4 > 20/6), where
#: its jump is log1p(exp(-20))/6 ~ 3e-10: a larger jump between nodes the
#: kernel and the twin place an ulp apart shows as an O(jump) difference
#: (threshold 4 at beta 2: 4e-9 row-scaled in f64)
ACTIVATION_TERMS = {
    "softplus": lambda u, v: F.softplus(4.0 * u - 2.0),
    "softplus_threshold": lambda u, v: F.softplus(8.0 * v - 4.0, beta=6.0),
    "softplus_module": lambda u, v: torch.nn.Softplus(beta=2.0)(4.0 * (u - v)),
    "gelu": lambda u, v: 0.2 + F.gelu(4.0 * u - 2.0),
    "gelu_tanh": lambda u, v: 0.2 + F.gelu(8.0 * v - 4.0, approximate="tanh"),
    "silu": lambda u, v: 0.3 + F.silu(8.0 * u - 4.0),
    "mish": lambda u, v: 0.31 + F.mish(4.0 * (u - v)),
    "elu": lambda u, v: 1.0 + F.elu(4.0 * v - 2.0, alpha=0.5),
    "leaky_relu": lambda u, v: 1.0 + F.leaky_relu(4.0 * u - 2.0, 0.2),
    "hardtanh": lambda u, v: 1.0 + F.hardtanh(4.0 * v - 2.0),
    "hardtanh_bounds": lambda u, v: 0.5 + F.hardtanh(4.0 * (u - v), -0.5, 2.0),
    "relu6": lambda u, v: F.relu6(8.0 * u - 1.0),
    "hardsigmoid": lambda u, v: F.hardsigmoid(8.0 * v - 4.0),
    "hardswish": lambda u, v: 0.375 + F.hardswish(8.0 * u - 4.0),
    "logsigmoid": lambda u, v: -F.logsigmoid(4.0 * v - 2.0),
    "softsign": lambda u, v: 1.0 + F.softsign(4.0 * (v - u)),
}


def activations(x, y):
    """1e-3 times the sum of `ACTIVATION_TERMS` at u = x/(1 + x), v = y/(1 + y)."""
    u, v = unit_interval(x), unit_interval(y)
    return 1e-3 * functools.reduce(operator.add, (t(u, v) for t in ACTIVATION_TERMS.values()))


#: the traced kernel functions these modules add, by name
KERNELS = {"efficiency": efficiency, "coverage": coverage, "special": special,
           "activations": activations}

#: B5's kernel against its twin, row-scaled, by type: the kernel sums its
#: nodes in another order than the twin and its assembly subtracts sums of
#: like size
NUM_TOL = {"float32": 1e-3, "float64": 1e-9}
#: the traced kernel functions timed at fewer boxes than the numerical
#: bench's 262,144 (one launch of `special` there takes seconds), by name:
#: the width its row has been timed at since it was added, so that its
#: times compare across trees
CAPPED = {"special": 4096}


def traced() -> dict:
    """B5's traced kernel functions, by name, as `chip_smoke.py` phase 30
    and `tools.traced_tune` check and time them: the Long kernel fitted as
    a kernel tensor (order 2, normalized), a torch lambda, and `KERNELS`."""
    from cloudy_tpu_torch import kernels as K

    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    return {
        "tensor": K.CoalescenceTensor.from_function(kf, 2, 5e-10).normalized((1e6, 1e-9)),
        "lambda": lambda x, y: 1e-3 * (x * x + y * y) + 1e-4 * torch.sqrt(x * y),
        **KERNELS,
    }


def check_only() -> dict:
    """Traced kernel functions held against their twin, not timed: a
    separable term that changes sign ((x − 1)(y − 1), its block sums of
    both signs)."""
    return {"sign": lambda x, y: 1e-3 * (x + y) + 1e-4 * (x - 1.0) * (y - 1.0)}
