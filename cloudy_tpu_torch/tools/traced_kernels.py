"""Two kernel functions K(x, y) that B5's traced arm (`ops.kernel_expr`,
the ``KT_GEN`` arm of csrc/numerical_coalescence.cu) is checked and timed
with, beside the Long kernel fitted as a tensor and a sqrt lambda
(`chip_smoke.py` phase 30, tests/test_torch_kernel_expr.py,
tests/test_torch_cuda_kernels.py).

- `efficiency`: a collision kernel with a smooth collection efficiency, the
  kind users write (turbulence enhancement through erf and tanh), in
  `torch.mul` and method forms;
- `coverage`: one unit that calls every elementwise form the tracer covers,
  a sum of small non-negative terms (`COVERAGE_TERMS`), each on arguments
  inside its function's domain (away from the jumps of the rounding forms)
  and of order one, so that nothing cancels: one unit per type instead of
  one per form.
"""

from __future__ import annotations

import functools
import operator

import torch


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


def unit_interval(x):
    """x / (1 + x): a mass in [0, 1)."""
    return x / (1.0 + x)


def coverage(x, y):
    """1e-3 times the sum of `COVERAGE_TERMS` at u = x/(1 + x), v = y/(1 + y)."""
    u, v = unit_interval(x), unit_interval(y)
    return 1e-3 * functools.reduce(operator.add, (t(u, v) for t in COVERAGE_TERMS.values()))


#: the traced kernel functions these modules add, by name
KERNELS = {"efficiency": efficiency, "coverage": coverage}
