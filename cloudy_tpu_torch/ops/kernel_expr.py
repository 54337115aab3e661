"""A kernel function K(x, y), traced once on the host into an expression and
emitted as a CUDA device function.

JAX's quadrature kernel (`cloudy_tpu.ops.pallas_numerical.
make_pallas_numerical_fn`, pallas_numerical.py:166) calls whatever callable
it is given inside its body (``kernel_func(X, Xy)`` :295, ``kernel_func(XR,
XS)`` :342): Pallas traces the Python function into the kernel. A CUDA
kernel cannot call back into Python, so the port does that trace itself:
`trace` calls the callable once on two symbolic operands `(x, y)` and
records the operations they meet, as a DAG of `Expr` nodes, and
`device_source` writes the DAG as

    template <typename T> __device__ __forceinline__ T cloudy_kernel_gen(T x, T y)

one statement per distinct subexpression, its constants rounded once to the
unit's type (`codegen.literal`). `codegen.numerical_unit` builds the
quadrature kernel's ``KT_GEN`` arm around it (csrc/numerical_coalescence.cu).
`factor` splits the trace into separable terms f_i(x) g_i(y) and a mixed
remainder, and `factored_source` writes them as the functions the arm
takes R from: the g_i and the remainder's y values once per outer node,
the f_i and its x values once per node, the remainder alone per pair.
`evaluate` computes a trace on tensors as those functions do, and
`factored_r_sums` R as the arm takes it, for `tools.opcount`'s count of
the operations the kernel needs.

What the operands cover, each in the unit's type through a helper of
csrc/common.cuh with the torch semantics (not C's where they differ):

- ``+ - * / ** % //`` and their reflected forms, unary minus, ``abs``, the
  comparisons and ``& | ~`` on their results (the masks of `torch.where`);
  integer powers become products;
- torch functions, found by identity (so `torch.special` aliases and the
  `torch.Tensor` methods and dunders a 0-d tensor on the left reaches
  resolve): add, sub, mul, div (``rounding_mode`` too), true_divide, neg,
  square, reciprocal, pow, abs, minimum, maximum, fmin, fmax, clamp,
  clamp_min, clamp_max, where, ones_like, zeros_like, full_like,
  broadcast_tensors, the comparisons and logical_and/or/not; exp, log,
  sqrt, rsqrt, sin, cos, tan, asin, acos, atan, atan2, sinh, cosh, tanh,
  asinh, acosh, atanh, erf, erfc, erfinv, lgamma (gammaln), expm1, log1p,
  exp2, log2, log10, hypot, floor, ceil, trunc (fix), round (half to even,
  as torch), sign (0 at NaN and +0 at -0, as torch), copysign, fmod,
  remainder (Python's sign rule), floor_divide (torch's divmod-corrected
  quotient) and sigmoid (expit, as its closed form 1/(1 + exp(-x))), with
  their numpy-style aliases (arcsin, multiply, negative, ...);
- the closed forms, with torch's values at 0, ±inf, NaN and the poles:
  xlogy, xlog1py, entr, logit (with ``eps``), sinc, logaddexp, logaddexp2,
  heaviside, deg2rad, rad2deg, frac, ldexp, nextafter, positive, rsub, sgn,
  angle (of a real), relu, selu, celu, ndtr; the masks isnan, isinf,
  isfinite, isposinf, isneginf, signbit (bool, usable in `where` and
  ``& | ~``) and nan_to_num (its defaults the traced type's largest and
  lowest values);
- torch's special functions, its own algorithms copied into
  csrc/special_functions.cuh: log_ndtr, digamma (psi), polygamma,
  zeta (Hurwitz), igamma/igammac (gammainc/gammaincc), mvlgamma
  (multigammaln, as torch's sum of lgammas), i0, i0e, i1, i1e,
  modified_bessel_i0/i1, bessel_j0/j1. polygamma's n and mvlgamma's p are
  a Python int or a 0-d integer tensor, compile-time constants of the
  emitted text;
- `torch.nn.functional`'s relu, selu, celu and its activations with a
  `jax.nn` counterpart, each with torch's own formula (its CPU kernels',
  where JAX's differs: softplus is x past beta·x > threshold, gelu's
  default is the erf form, mish has no threshold, logsigmoid is min(x, 0)
  − log1p(exp(−|x|))): softplus (beta, threshold), gelu (``approximate``
  'none' or 'tanh'), silu, mish, elu (alpha; torch._C._nn.elu's scale and
  input_scale too), leaky_relu (negative_slope), hardtanh (min_val,
  max_val), relu6, hardsigmoid, hardswish (dividing by 6, as torch's CPU
  kernels do, on the card too), logsigmoid, softsign; also as
  torch._C._nn's builtins (log_sigmoid) and through an nn.Module over one (nn.GELU(), nn.Softplus(beta=2.0), ...);
  each parameter a Python number or a 0-d tensor, a constant of the
  emitted text;
- the method form of each (``x.exp()``, ``x.clamp(min=...)``, ``x.pow(y)``,
  ``x.where(cond, other)``, which is ``torch.where(cond, x, other)``,
  ``x.polygamma(n)``, which is ``torch.polygamma(n, x)``);
- ``x.dtype`` (the type being traced: `trace`'s `dtype`) and ``x.device``
  (the CPU), so that ``torch.as_tensor(c, dtype=x.dtype, device=x.device)``
  is a constant of that type; a 0-d tensor or a numpy scalar is a constant
  (a numpy scalar on the left hands the operation to the operand's
  reflected method, because the operand sets ``__array_ufunc__ = None``).

So every elementwise kernel function that JAX's kernel takes runs here
too. Everything else raises `KernelTraceError` naming the operation:

- `torch.special.ndtri`: JAX's kernel refuses `jax.scipy.special.ndtri`
  (its coefficient arrays are captured constants Pallas does not take);
- the forms with no JAX counterpart: `torch.special.erfcx`, bessel_y0/y1,
  the modified_bessel_k* and scaled_modified_bessel_k* families,
  spherical_bessel_j0, airy_ai, the polynomial families;
- `torch.nn.functional`'s forms with no `jax.nn` counterpart or that are
  not elementwise: tanhshrink, softshrink, hardshrink, threshold, rrelu,
  prelu, glu, softmax, log_softmax, softmin and the normalisations;
- a Python branch on an operand's value, reductions (``x.sum()``,
  `torch.cumsum`), indexing and shape changes, in-place methods
  (``x.add_``) and forms (``inplace=True``, ``F.elu_``), dtype changes
  (``x.double()``, `torch.float_power`), random draws, losses,
  `torch.isclose` / `torch.isin`, ``alpha`` scaling of add/sub/rsub, an
  operand as polygamma's n, mvlgamma's p or an activation's parameter, and
  any other function not listed.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch


class KernelTraceError(NotImplementedError):
    """The kernel function used an operation the tracer does not cover."""


def _unsupported(what: str) -> KernelTraceError:
    return KernelTraceError(
        f"the kernel-function tracer does not cover {what}: the CUDA quadrature "
        "kernel evaluates K(x, y) from a trace of the elementwise forms that "
        "cloudy_tpu_torch.ops.kernel_expr lists")


#: the type being traced: what ``x.dtype`` answers inside `trace`
_DTYPE = contextvars.ContextVar("kernel_expr_dtype", default=torch.float64)


class Expr:
    """One node of a traced kernel function: `op` with operands `args`
    (`Expr` nodes; a ``"const"`` node holds its float, a ``"var"`` node its
    name). `boolean` nodes are masks (comparisons and their logic)."""

    __slots__ = ("op", "args", "boolean")
    __array_ufunc__ = None  # numpy scalars defer to the reflected methods
    __hash__ = None  # == builds a node; an Expr is not a dict key

    def __init__(self, op: str, args: tuple, boolean: bool = False):
        self.op = op
        self.args = args
        self.boolean = boolean

    # ---- arithmetic --------------------------------------------------------
    def __add__(self, o):
        return _bin("add", self, o)

    def __radd__(self, o):
        return _bin("add", o, self)

    def __sub__(self, o):
        return _bin("sub", self, o)

    def __rsub__(self, o):
        return _bin("sub", o, self)

    def __mul__(self, o):
        return _bin("mul", self, o)

    def __rmul__(self, o):
        return _bin("mul", o, self)

    def __truediv__(self, o):
        return _bin("div", self, o)

    def __rtruediv__(self, o):
        return _bin("div", o, self)

    def __pow__(self, o):
        return _pow(self, o)

    def __rpow__(self, o):
        return _pow(o, self)

    def __mod__(self, o):
        return _call("remainder", self, o)

    def __rmod__(self, o):
        return _call("remainder", o, self)

    def __floordiv__(self, o):
        return _call("floor_divide", self, o)

    def __rfloordiv__(self, o):
        return _call("floor_divide", o, self)

    def __neg__(self):
        return _call("neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _call("abs", self)

    # ---- masks -------------------------------------------------------------
    def __lt__(self, o):
        return _cmp("lt", self, o)

    def __le__(self, o):
        return _cmp("le", self, o)

    def __gt__(self, o):
        return _cmp("gt", self, o)

    def __ge__(self, o):
        return _cmp("ge", self, o)

    def __eq__(self, o):
        return _cmp("eq", self, o)

    def __ne__(self, o):
        return _cmp("ne", self, o)

    def __and__(self, o):
        return _logic("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logic("or", self, o)

    __ror__ = __or__

    def __invert__(self):
        return _not(self)

    # ---- what a tensor answers ---------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return _DTYPE.get()

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        method = _METHODS.get(name)
        if method is None:
            kind = "the in-place method" if name.endswith("_") else "the attribute or method"
            raise _unsupported(f"{kind} .{name}")
        return functools.partial(method, self)

    # ---- what a trace cannot follow ----------------------------------------
    def __bool__(self):
        raise _unsupported("a Python branch on the value of x or y (use torch.where)")

    def __float__(self):
        raise _unsupported("float() of x or y")

    def __index__(self):
        raise _unsupported("an integer from x or y")

    def __getitem__(self, key):
        raise _unsupported("indexing x[...] or y[...]")

    def __setitem__(self, key, value):
        raise _unsupported("indexing x[...] or y[...]")

    def __matmul__(self, o):
        raise _unsupported("@")

    __rmatmul__ = __matmul__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is None:
            raise _unsupported(_qualname(func))
        try:
            return rule(*args, **(kwargs or {}))
        except TypeError:
            raise _unsupported(f"{_qualname(func)} called with these arguments") from None


def const(v) -> Expr:
    v = float(v)
    return Expr("const", (v,))


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise _unsupported("a tensor operand of more than one element")
        return const(v.item())
    try:
        return const(v)
    except (TypeError, ValueError):
        raise _unsupported(f"an operand of type {type(v).__name__}") from None


def _value(e: Expr):
    return e.args[0] if e.op == "const" else None


_FOLD = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
         "mul": lambda a, b: a * b, "div": lambda a, b: a / b if b else None}


def _bin(op: str, a, b) -> Expr:
    """a op b; two constants (``c * x**0``) folded in double, as Python
    folds them before torch sees them, and a product with 1 (``c*x * y**0``)
    taken as its other factor, which it equals exactly."""
    a, b = _wrap(a), _wrap(b)
    if a.boolean or b.boolean:
        raise _unsupported(f"arithmetic ({op}) on a mask")
    va, vb = _value(a), _value(b)
    if va is not None and vb is not None and _FOLD[op](va, vb) is not None:
        return const(_FOLD[op](va, vb))
    if op == "mul" and (va == 1.0 or vb == 1.0):
        return b if va == 1.0 else a
    return Expr(op, (a, b))


def _call(op: str, *args) -> Expr:
    """The elementwise function `op` (`_CALL_C`) of values."""
    args = tuple(_wrap(a) for a in args)
    if any(a.boolean for a in args):
        raise _unsupported(f"{op} of a mask")
    return Expr(op, args)


def _cmp(op: str, a, b) -> Expr:
    a, b = _wrap(a), _wrap(b)
    return Expr(op, (a, b), True)


def _logic(op: str, a, b) -> Expr:
    a, b = _wrap(a), _wrap(b)
    if not (a.boolean and b.boolean):
        raise _unsupported(f"{'&' if op == 'and' else '|'} on values that are not masks")
    return Expr(op, (a, b), True)


def _not(a) -> Expr:
    a = _wrap(a)
    if not a.boolean:
        raise _unsupported("~ on a value that is not a mask")
    return Expr("not", (a,), True)


def _pow(a, b) -> Expr:
    """a ** b; an integer exponent as a product (a negative one as its
    reciprocal)."""
    a, b = _wrap(a), _wrap(b)
    n = _value(b)
    if n is not None and float(n).is_integer() and abs(n) <= 64:
        n = int(n)
        if n == 0:
            return const(1.0)
        p = a
        for _ in range(abs(n) - 1):
            p = Expr("mul", (p, a))
        return Expr("div", (const(1.0), p)) if n < 0 else p
    return _call("pow", a, b)


def _where(cond, a, b) -> Expr:
    cond = _wrap(cond)
    if not cond.boolean:
        raise _unsupported("torch.where on a condition that is not a mask")
    return Expr("where", (cond, _wrap(a), _wrap(b)))


def _clamp(x, min=None, max=None):
    out = _wrap(x)
    if min is not None:
        out = _call("max", out, min)
    if max is not None:
        out = _call("min", out, max)
    return out


def _add_sub(op):
    def rule(a, b, *, alpha=1):
        if alpha != 1:
            raise _unsupported(f"torch.{op} with alpha")
        return _bin(op, a, b)
    return rule


def _div(a, b, *, rounding_mode=None):
    if rounding_mode is None:
        return _bin("div", a, b)
    if rounding_mode == "floor":
        return _call("floor_divide", a, b)
    if rounding_mode == "trunc":
        return _call("trunc", _bin("div", a, b))
    raise _unsupported(f"torch.div with rounding_mode={rounding_mode!r}")


def _round(x, *, decimals=0):
    if decimals != 0:
        raise _unsupported("torch.round with decimals")
    return _call("round", x)


def _like(x, fill_value, *, dtype=None, **kw):
    """ones_like / zeros_like / full_like: a constant of the traced type."""
    if dtype is not None and dtype != _DTYPE.get():
        raise _unsupported(f"a constant of another type ({dtype})")
    return const(torch.tensor(fill_value, dtype=_DTYPE.get()).item())


def _int_arg(v, what: str) -> int:
    """`what` (polygamma's n, mvlgamma's p): a Python int or a 0-d integer
    tensor, a compile-time constant of the emitted text."""
    if isinstance(v, torch.Tensor) and v.numel() == 1 and not v.is_floating_point() \
            and v.dtype != torch.bool:
        return int(v.item())
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    raise _unsupported(f"{what} that is not a Python int or a 0-d integer tensor "
                       "(an operand or a float in that place)")


def _mask(op: str, x) -> Expr:
    """torch.isnan / isinf / isfinite / isposinf / isneginf / signbit: a
    mask of a value, as the comparisons are."""
    x = _wrap(x)
    if x.boolean:
        raise _unsupported(f"{op} of a mask")
    return Expr(op, (x,), True)


def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    """NaN, +inf and -inf replaced; the defaults of the infinities are the
    traced type's largest and lowest finite values, as torch's."""
    info = torch.finfo(_DTYPE.get())
    return _call("nan_to_num", x, 0.0 if nan is None else nan,
                 info.max if posinf is None else posinf, info.min if neginf is None else neginf)


def _logit(x, eps=None):
    return _call("logit", x) if eps is None else _call("logit", x, eps)


def _celu(x, alpha=1.0):
    # torch.celu is elu with input scale 1/alpha (taken in double, then
    # rounded to the tensor's type, as torch's Scalar is)
    return _call("celu", x, alpha, 1.0 / float(alpha))


def _polygamma(n, x) -> Expr:
    n = _int_arg(n, "torch.polygamma's order n")
    if n < 0:
        raise _unsupported("torch.polygamma of a negative order")
    return _call("polygamma", Expr("int", (n,)), x)


def _mvlgamma(x, p) -> Expr:
    """torch.mvlgamma(x, p) as torch computes it: the sum of lgamma(x -
    j/2) over j = p-1, ..., 0, plus p(p-1)/4 log(pi) (a closed form over
    lgamma; where x <= (p-1)/2 torch raises, the device gives the sum)."""
    p = _int_arg(p, "torch.mvlgamma's p")
    if p < 1:
        raise _unsupported("torch.mvlgamma with p < 1")
    x = _wrap(x)
    total = None
    for j in range(p - 1, -1, -1):
        term = _call("lgamma", x if j == 0 else _bin("add", x, -0.5 * j))
        total = term if total is None else _bin("add", total, term)
    return _bin("add", total, p * (p - 1) * math.log(math.pi) / 4.0)


def _unary(op):
    return lambda x: _call(op, x)


def _binary(op):
    return lambda a, b: _call(op, a, b)


_UNARY_CALLS = ("exp", "log", "sqrt", "abs", "rsqrt", "sin", "cos", "tan", "asin", "acos",
                "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfc",
                "erfinv", "lgamma", "expm1", "log1p", "exp2", "log2", "log10", "floor",
                "ceil", "trunc", "sign", "sigmoid",
                # closed forms over the helpers above
                "ndtr", "entr", "sinc", "frac", "angle", "relu", "selu",
                # special_functions.cuh: torch's series and tables
                "log_ndtr", "digamma", "i0", "i0e", "i1", "i1e", "modified_bessel_i0",
                "modified_bessel_i1", "bessel_j0", "bessel_j1")
_BINARY_CALLS = ("atan2", "hypot", "copysign", "fmod", "remainder", "floor_divide", "fmin",
                 "fmax", "xlogy", "xlog1py", "logaddexp", "logaddexp2", "heaviside",
                 "nextafter", "ldexp", "zeta", "igamma", "igammac")
#: the masks of a value (bool, as the comparisons)
_MASK_CALLS = ("isnan", "isinf", "isfinite", "isposinf", "isneginf", "signbit")
#: torch.nn.functional's activations with a `jax.nn` counterpart, each a
#: helper of csrc/common.cuh with torch's own formula (its CPU kernels')
_ACTIVATIONS = ("softplus", "gelu", "gelu_tanh", "silu", "mish", "elu", "leaky_relu",
                "hardtanh", "relu6", "hardsigmoid", "hardswish", "log_sigmoid", "softsign")
#: the elementwise functions emitted as a call of a csrc/common.cuh (or
#: special_functions.cuh) helper, ``d<op>`` but for jnp's and torch's
#: NaN-propagating min/max (``vmin``, ``vmax``), torch.round's half to even
#: (``drint``), ``dfloordiv``, digamma (``dpsi``), the incomplete gammas
#: (``dgammainc``, ``dgammaincc``), modified_bessel_i0, which is i0's
#: arithmetic, and elu (``delu_alpha``); ``logit`` takes an ``eps``,
#: ``celu`` its alpha and 1/alpha, ``nan_to_num`` its three replacements,
#: ``polygamma`` its order as a template argument, the activations their
#: parameters
_CALL_C = {**{op: f"d{op}" for op in _UNARY_CALLS + _BINARY_CALLS + _MASK_CALLS
              + _ACTIVATIONS + ("pow", "logit", "celu", "nan_to_num", "polygamma")},
           "min": "vmin", "max": "vmax", "round": "drint", "floor_divide": "dfloordiv",
           "digamma": "dpsi", "igamma": "dgammainc", "igammac": "dgammaincc",
           "modified_bessel_i0": "di0", "elu": "delu_alpha"}
#: the operations whose helpers are in csrc/special_functions.cuh, which a
#: unit includes only where its trace calls one (`includes`)
_SPECIAL_OPS = frozenset({"log_ndtr", "digamma", "polygamma", "zeta", "igamma", "igammac",
                         "i0", "i0e", "i1", "i1e", "modified_bessel_i0", "modified_bessel_i1",
                         "bessel_j0", "bessel_j1"})

#: the torch functions a kernel function may call on x and y, by name in
#: `torch`, `torch.special` and as `torch.Tensor` methods (each found there
#: by identity); `_ALIASES` adds their other names
TORCH_FUNCTIONS: Dict[str, Callable] = {
    **{op: _unary(op) for op in _UNARY_CALLS},
    **{op: _binary(op) for op in _BINARY_CALLS},
    "add": _add_sub("add"),
    "sub": _add_sub("sub"),
    "mul": lambda a, b: _bin("mul", a, b),
    "div": _div,
    "true_divide": lambda a, b: _bin("div", a, b),
    "neg": _unary("neg"),
    "square": lambda x: _bin("mul", x, x),
    "reciprocal": lambda x: _bin("div", 1.0, x),
    "pow": lambda a, b: _pow(a, b),
    "round": _round,
    "minimum": lambda a, b: _call("min", a, b),
    "maximum": lambda a, b: _call("max", a, b),
    "clamp": _clamp,
    "clamp_min": lambda x, min: _clamp(x, min=min),
    "clamp_max": lambda x, max: _clamp(x, max=max),
    "where": _where,
    "ones_like": lambda x, **kw: _like(x, 1.0, **kw),
    "zeros_like": lambda x, **kw: _like(x, 0.0, **kw),
    "full_like": _like,
    "broadcast_tensors": lambda *xs: tuple(xs),
    **{op: functools.partial(_cmp, op) for op in ("lt", "le", "gt", "ge", "eq", "ne")},
    "logical_and": lambda a, b: _logic("and", a, b),
    "logical_or": lambda a, b: _logic("or", a, b),
    "logical_not": _not,
    **{op: functools.partial(_mask, op) for op in _MASK_CALLS},
    "nan_to_num": _nan_to_num,
    "logit": _logit,
    "celu": _celu,
    "polygamma": _polygamma,
    "mvlgamma": _mvlgamma,
    "positive": _wrap,
    "sgn": _unary("sign"),
    "rsub": lambda a, b, *, alpha=1: _add_sub("sub")(b, a, alpha=alpha),
    # torch multiplies by the double pi/180 (180/pi) rounded to the type
    "deg2rad": lambda x: _bin("mul", x, math.pi / 180.0),
    "rad2deg": lambda x: _bin("mul", x, 180.0 / math.pi),
}
_ALIASES = {"absolute": "abs", "arcsin": "asin", "arccos": "acos", "arctan": "atan",
            "arctan2": "atan2", "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
            "fix": "trunc", "gammaln": "lgamma", "expit": "sigmoid", "negative": "neg",
            "multiply": "mul", "divide": "div", "subtract": "sub", "clip": "clamp",
            "less": "lt", "less_equal": "le", "greater": "gt", "greater_equal": "ge",
            "not_equal": "ne", "psi": "digamma", "gammainc": "igamma",
            "gammaincc": "igammac", "multigammaln": "mvlgamma"}
#: the Tensor dunders a 0-d tensor on the left may reach (``t // x`` reaches
#: ``__floordiv__``; the others reach the methods in this torch)
_DUNDERS = {"__add__": "add", "__sub__": "sub", "__mul__": "mul", "__truediv__": "div",
            "__div__": "div", "__pow__": "pow", "__mod__": "remainder",
            "__floordiv__": "floor_divide", "__neg__": "neg", "__abs__": "abs",
            "__lt__": "lt", "__le__": "le", "__gt__": "gt", "__ge__": "ge", "__eq__": "eq",
            "__ne__": "ne"}


def _no_inplace(rule):
    def functional(x, *args, inplace=False, **kw):
        if inplace:
            raise _unsupported("an in-place torch.nn.functional form")
        return rule(x, *args, **kw)
    return functional


def _param(v, what: str) -> float:
    """An activation's parameter (softplus's beta, elu's alpha, ...): a
    Python number or a 0-d tensor, a constant of the emitted text."""
    if isinstance(v, Expr):
        raise _unsupported(f"x or y as {what}")
    return _wrap(v).args[0]


def _softplus(x, beta=1.0, threshold=20.0):
    return _call("softplus", x, _param(beta, "softplus's beta"),
                 _param(threshold, "softplus's threshold"))


def _gelu(x, approximate="none"):
    if approximate == "none":
        return _call("gelu", x)
    if approximate == "tanh":
        return _call("gelu_tanh", x)
    raise _unsupported(f"torch.nn.functional.gelu with approximate={approximate!r}")


def _elu(x, alpha=1.0, scale=1.0, input_scale=1.0):
    # torch's elu kernel: alpha * scale at x <= 0 (each rounded to the
    # type, then multiplied), input_scale inside the exponential
    return _call("elu", x, _param(alpha, "elu's alpha"), _param(scale, "elu's scale"),
                 _param(input_scale, "elu's input_scale"))


def _leaky_relu(x, negative_slope=0.01):
    return _call("leaky_relu", x, _param(negative_slope, "leaky_relu's negative_slope"))


def _hardtanh(x, min_val=-1.0, max_val=1.0):
    return _call("hardtanh", x, _param(min_val, "hardtanh's min_val"),
                 _param(max_val, "hardtanh's max_val"))


#: the torch.nn.functional forms the tracer takes: those of covered torch
#: functions (relu, selu, celu) and the activations (`_ACTIVATIONS`), by
#: their names there; torch._C._nn's builtins of the same names (and
#: log_sigmoid, which is logsigmoid) resolve to the same rules, and so does
#: an nn.Module over them (nn.GELU(), nn.Softplus(beta=2.0), ...), whose
#: forward calls the functional form. The in-place forms (``inplace=True``
#: and the names ending in ``_``) are refused; so are the forms with no
#: `jax.nn` counterpart or that are not elementwise (tanhshrink,
#: softshrink, hardshrink, threshold, rrelu, prelu, glu, softmax and the
#: normalisations), each by its name
_FUNCTIONAL = {"relu": _no_inplace(_unary("relu")), "selu": _no_inplace(_unary("selu")),
               "celu": _no_inplace(_celu), "softplus": _softplus, "gelu": _gelu,
               "silu": _no_inplace(_unary("silu")), "mish": _no_inplace(_unary("mish")),
               "elu": _no_inplace(_elu), "leaky_relu": _no_inplace(_leaky_relu),
               "hardtanh": _no_inplace(_hardtanh), "relu6": _no_inplace(_unary("relu6")),
               "hardsigmoid": _no_inplace(_unary("hardsigmoid")),
               "hardswish": _no_inplace(_unary("hardswish")),
               "logsigmoid": _unary("log_sigmoid"), "softsign": _unary("softsign")}
#: torch._C._nn's names where they differ from torch.nn.functional's
_NN_NAMES = {"logsigmoid": "log_sigmoid"}


def _refuse_inplace(*args, **kw):
    raise _unsupported("an in-place torch.nn.functional form")


def _method_where(self, condition, other):
    # Tensor.where(cond, other) is torch.where(cond, self, other)
    return _where(condition, self, other)


def _method_polygamma(self, n):
    # Tensor.polygamma(n) is torch.polygamma(n, self)
    return _polygamma(n, self)


#: the methods whose arguments come in another order than the function's
_METHOD_ORDER = {"where": _method_where, "polygamma": _method_polygamma}


def _tables():
    """(rules by function object, method rules by name, names by function
    object)."""
    rules, methods, names = {}, {}, {}
    forms = {**TORCH_FUNCTIONS, **{a: TORCH_FUNCTIONS[n] for a, n in _ALIASES.items()}}
    for name, rule in forms.items():
        for owner, prefix in ((torch, "torch"), (torch.special, "torch.special")):
            f = getattr(owner, name, None)
            if f is not None:
                rules[f], names[f] = rule, f"{prefix}.{name}"
        f = getattr(torch.Tensor, name, None)
        if f is not None:
            method = _METHOD_ORDER.get(name, rule)
            rules[f], names[f] = method, f"torch.Tensor.{name}"
            methods[name] = method
    for name, rule in _FUNCTIONAL.items():
        nn_name = _NN_NAMES.get(name, name)
        for owner, prefix, n in ((torch._C._nn, "torch._C._nn", nn_name),
                                 (torch.nn.functional, "torch.nn.functional", name)):
            for f, r in ((getattr(owner, n, None), rule),
                         (getattr(owner, f"{n}_", None), _refuse_inplace)):
                if f is not None:
                    rules[f], names[f] = r, f"{prefix}.{n}{'' if r is rule else '_'}"
    for dunder, name in _DUNDERS.items():
        f = getattr(torch.Tensor, dunder, None)
        if f is not None:
            rules[f], names[f] = forms[name], f"torch.Tensor.{dunder}"
    return rules, methods, names


_RULES, _METHODS, _NAMES = _tables()


def _qualname(func) -> str:
    """``torch.special.ndtri`` for `torch.special.ndtri` (whose
    ``__name__`` is ``special_ndtri``), ``torch.cumsum``, ..."""
    if func in _NAMES:
        return _NAMES[func]
    name = getattr(func, "__name__", None)
    if name is None:
        return repr(func)
    for owner, prefix in ((torch.special, "torch.special"), (torch, "torch"),
                          (torch.Tensor, "torch.Tensor"),
                          (torch.nn.functional, "torch.nn.functional")):
        for n in (name.removeprefix("special_"), name):
            if getattr(owner, n, None) is func:
                return f"{prefix}.{n}"
    return f"torch.{name}"


def trace(kernel_func: Callable, dtype: torch.dtype = torch.float64) -> Expr:
    """K(x, y) as an expression of the variables ``x`` and ``y``, traced at
    `dtype` (what ``x.dtype`` answers: a constant made at the operand's type
    is rounded to it)."""
    token = _DTYPE.set(dtype)
    try:
        out = _wrap(kernel_func(Expr("var", ("x",)), Expr("var", ("y",))))
    finally:
        _DTYPE.reset(token)
    if out.boolean:
        raise _unsupported("a mask as the kernel's value")
    return out


# --------------------------------------------------------------------------
# emission
# --------------------------------------------------------------------------

_BINARY_C = {"add": "+", "sub": "-", "mul": "*", "div": "/",
             "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
             "and": "&&", "or": "||"}


def statements(expr: Expr, literal: Callable[[float], str]) -> Tuple[List[str], str]:
    """(statements, result) of `expr` in C++: one ``const`` per distinct
    subexpression in evaluation order (equal subexpressions share one),
    constants written by `literal`."""
    lines, refs = statements_of([expr], literal)
    return lines, refs[0]


def statements_of(roots, literal: Callable[[float], str],
                  leaves: Dict[int, str] = None) -> Tuple[List[str], List[str]]:
    """`statements` of several roots at once (their shared subexpressions
    once): (statements, the roots' references). A node in `leaves` (by
    ``id``) is the C++ expression it maps to, not computed."""
    lines: List[str] = []
    names: Dict[str, str] = {}
    memo: Dict[int, str] = dict(leaves or {})

    def emit(e: Expr) -> str:
        if id(e) in memo:
            return memo[id(e)]
        if e.op == "var":
            ref = e.args[0]
        elif e.op == "const":
            ref = literal(e.args[0])
        elif e.op == "int":
            ref = str(e.args[0])
        else:
            args = [emit(a) for a in e.args]
            if e.op == "polygamma":
                rhs = f"{_CALL_C[e.op]}<{args[0]}>({args[1]})"
            elif e.op in _BINARY_C:
                rhs = f"{args[0]} {_BINARY_C[e.op]} {args[1]}"
            elif e.op == "neg":
                rhs = f"-{args[0]}"
            elif e.op == "not":
                rhs = f"!{args[0]}"
            elif e.op == "where":
                rhs = f"{args[0]} ? {args[1]} : {args[2]}"
            else:
                rhs = f"{_CALL_C[e.op]}({', '.join(args)})"
            ref = names.get(rhs)
            if ref is None:
                ref = f"{'b' if e.boolean else 't'}{len(names)}"
                names[rhs] = ref
                lines.append(f"const {'bool' if e.boolean else 'T'} {ref} = {rhs};")
        memo[id(e)] = ref
        return ref

    return lines, [emit(r) for r in roots]


def _torch_op(op: str):
    return getattr(torch, op, None) or getattr(torch.special, op)


_TORCH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
              "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
              "eq": torch.eq, "ne": torch.ne, "and": torch.logical_and,
              "or": torch.logical_or, "not": torch.logical_not, "neg": torch.neg,
              "pow": torch.pow, "min": torch.minimum, "max": torch.maximum,
              "where": torch.where, "round": torch.round,
              **{op: _torch_op(op) for op in _UNARY_CALLS + _BINARY_CALLS + _MASK_CALLS},
              "logit": lambda x, eps=None: torch.logit(x, None if eps is None else float(eps)),
              "celu": lambda x, alpha, inv_alpha: torch.celu(x, float(alpha)),
              "nan_to_num": lambda x, nan, posinf, neginf: torch.nan_to_num(
                  x, float(nan), float(posinf), float(neginf)),
              "polygamma": torch.polygamma,
              **{op: (lambda f: lambda x, *p: f(x, *(float(v) for v in p)))(
                  getattr(torch.nn.functional, op))
                 for op in ("softplus", "silu", "mish", "leaky_relu", "hardtanh", "relu6",
                            "hardsigmoid", "hardswish", "softsign")},
              "gelu": torch.nn.functional.gelu,
              "gelu_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
              "elu": lambda x, alpha, scale, input_scale: torch._C._nn.elu(
                  x, float(alpha), float(scale), float(input_scale)),
              "log_sigmoid": torch.nn.functional.logsigmoid}


def evaluate(expr: Expr, x: torch.Tensor, y: torch.Tensor,
             leaves: Dict[int, torch.Tensor] = None) -> torch.Tensor:
    """`expr` on tensors, as the emitted function computes it: each distinct
    subexpression once (as `statements` shares them), at the shape its own
    operands broadcast to; a node in `leaves` (by ``id``) is the tensor it
    maps to, not computed. `tools.opcount` counts a twin's kernel function
    through it."""
    return evaluate_many([expr], x, y, leaves)[0]


def evaluate_many(roots, x: torch.Tensor, y: torch.Tensor,
                  leaves: Dict[int, torch.Tensor] = None) -> List[torch.Tensor]:
    """`evaluate` of several roots at once, their shared subexpressions
    once (as `statements_of` emits them)."""
    memo: Dict[str, torch.Tensor] = {}
    leaves = leaves or {}

    def ev(e: Expr):
        if id(e) in leaves:
            return leaves[id(e)], f"leaf{id(e)}"
        if e.op == "var":
            return (x if e.args[0] == "x" else y), e.args[0]
        if e.op == "const":
            v = e.args[0]
            return torch.tensor(v, dtype=x.dtype, device=x.device), repr(v)
        if e.op == "int":
            return e.args[0], f"int{e.args[0]}"
        vals, keys = zip(*(ev(a) for a in e.args))
        key = f"{e.op}({','.join(keys)})"
        if key not in memo:
            memo[key] = _TORCH_OPS[e.op](*vals)
        return memo[key], key

    shape = torch.broadcast_shapes(x.shape, y.shape)
    out = []
    for r in roots:
        v, _ = ev(r)
        out.append(v.expand(torch.broadcast_shapes(shape, v.shape)))
    return out


def includes(expr: Expr) -> List[str]:
    """The csrc headers the emitted function needs: common.cuh, and
    special_functions.cuh where the trace calls one of `_SPECIAL_OPS` (so
    that no other unit's text changes)."""
    seen, stack, special = set(), [expr], False
    while stack and not special:
        e = stack.pop()
        if id(e) in seen or e.op in ("var", "const", "int"):
            continue
        seen.add(id(e))
        special = e.op in _SPECIAL_OPS
        stack.extend(e.args)
    return ["common.cuh", "special_functions.cuh"] if special else ["common.cuh"]


def device_source(expr: Expr, literal: Callable[[float], str]) -> str:
    """The device function ``cloudy_kernel_gen`` of `expr` (csrc/
    numerical_coalescence.cu calls it for ``KT_GEN``)."""
    body, result = statements(expr, literal)
    return "\n".join([
        "template <typename T>",
        "__device__ __forceinline__ T cloudy_kernel_gen(T x, T y) {",
        *(f"  {ln}" for ln in body),
        f"  return {result};",
        "}",
    ])


# --------------------------------------------------------------------------
# the factored form: separable terms and a remainder
# --------------------------------------------------------------------------

#: the most y-only values per outer node the factored arm keeps in shared
#: memory for its remainder (csrc/numerical_coalescence.cu, the KT_GEN arm):
#: past it the remainder recomputes the others from y per pair. Measured on
#: an NVIDIA H100 80GB HBM3 at 700 W (tools/traced_tune.py, PERF.md):
#: tabling `special`'s nine values gains it 1.3 % over recomputing them,
#: tabling `coverage`'s four cheap ones (an add each, but for y/(1+y))
#: costs it 1.0 %: a tabled value is worth about one shared load per pair.
#: The budget keeps the table from setting the occupancy: the traced units
#: take 60-80 registers in f32 and 128-188 in f64, so at most 8 (f32) or 5
#: (f64) blocks of the bench's 96 threads fit an SM, and at 16 values and
#: the two modes' WX F_j a block takes 6.75 KiB (f32) or 13.5 KiB (f64) of
#: its 228 KiB
TABLE_BUDGET = 16

_ONE = Expr("const", (1.0,))


@dataclasses.dataclass(frozen=True)
class Factored:
    """K(x, y) = sum_i f_i(x) g_i(y) + r(x, y), as `factor` splits a trace.

    `terms` are the separable terms (f_i, g_i): f_i depends on x alone (or
    is a constant), g_i on y alone (or is 1); terms with equal g are summed
    into one, then terms with equal f. `remainder` is the mixed rest (None
    where K is separable). The remainder reads `x_values` (its x-only
    operands, computed once per outer node) and `y_values` (its y-only
    operands): the first `TABLE_BUDGET` of these are tabled per node
    (`tabled`), the rest recomputed per pair from y, which is then tabled
    too."""

    terms: Tuple[Tuple[Expr, Expr], ...]
    remainder: Optional[Expr]
    x_values: Tuple[Expr, ...]
    y_values: Tuple[Expr, ...]
    #: the y-only values kept in shared memory per outer node
    tabled: Tuple[Expr, ...]
    #: distinct mixed operations the remainder computes per pair
    remainder_nodes: int


def _key(e: Expr, memo: dict) -> str:
    """A structural key: equal for equal expressions (`memo` by ``id``,
    holding the node so that its ``id`` is not reused)."""
    if id(e) not in memo:
        if e.op in ("var", "const", "int"):
            k = f"{e.op}:{e.args[0]!r}"
        else:
            k = f"{e.op}({','.join(_key(a, memo) for a in e.args)})"
        memo[id(e)] = (k, e)
    return memo[id(e)][0]


def _deps(e: Expr, memo: dict) -> frozenset:
    """The variables `e` depends on (`memo` as `_key`'s)."""
    if id(e) not in memo:
        if e.op == "var":
            d = frozenset(e.args)
        elif e.op in ("const", "int"):
            d = frozenset()
        else:
            d = frozenset().union(*(_deps(a, memo) for a in e.args))
        memo[id(e)] = (d, e)
    return memo[id(e)][0]


def _neg(e: Expr) -> Expr:
    return const(-e.args[0]) if e.op == "const" else Expr("neg", (e,))


def factor(expr: Expr) -> Factored:
    """The separable terms and the mixed remainder of a trace.

    The split goes through ``+``, ``-``, unary minus, and a product with
    (or a quotient by) a constant or a factor of one variable, which
    multiplies (divides) each term's f or g; a product or quotient of two
    mixed factors, or any other mixed operation, is a remainder term whole.
    It never expands a product of sums or a power of a sum, so (x - y)**2
    and sqrt(x*y) stay in the remainder, and nothing cancels across terms
    that the written K did not cancel within one: each block sum
    sum_y g_i(y) WX F_j(y) adds values of one sign where g_i keeps one."""
    deps: dict = {}
    keys: dict = {}
    X, Y = frozenset("x"), frozenset("y")

    def one_var(e):
        d = _deps(e, deps)
        return d <= X or d == Y

    def split(e):
        d = _deps(e, deps)
        if d <= X:
            return [(e, _ONE)], None
        if d == Y:
            return [(_ONE, e)], None
        if e.op in ("add", "sub"):
            (ta, ra), (tb, rb) = split(e.args[0]), split(e.args[1])
            if not ta and not tb:
                return [], e
            if e.op == "sub":
                tb = [(_neg(f), g) for f, g in tb]
                rb = None if rb is None else _neg(rb)
            rem = rb if ra is None else (ra if rb is None else _bin("add", ra, rb))
            return ta + tb, rem
        if e.op == "neg":
            t, r = split(e.args[0])
            if not t:
                return [], e
            return [(_neg(f), g) for f, g in t], None if r is None else _neg(r)
        if e.op in ("mul", "div"):
            a, b = e.args
            if e.op == "div" and one_var(b):
                s, o = b, a
            elif e.op == "mul" and one_var(a):
                s, o = a, b
            elif e.op == "mul" and one_var(b):
                s, o = b, a
            else:
                return [], e
            t, r = split(o)
            if not t:
                return [], e

            def scale(v):
                return _bin("div", v, s) if e.op == "div" else _bin("mul", s, v)

            on_x = _deps(s, deps) <= X
            t = [(scale(f), g) if on_x else (f, scale(g)) for f, g in t]
            return t, None if r is None else scale(r)
        return [], e

    terms, rem = split(expr)

    def group(pairs, by_g):
        out: Dict[str, list] = {}
        for f, g in pairs:
            k = _key(g if by_g else f, keys)
            if k in out:
                i = 0 if by_g else 1
                out[k][i] = _bin("add", out[k][i], f if by_g else g)
            else:
                out[k] = [f, g]
        return [tuple(v) for v in out.values()]

    terms = group(group(terms, True), False)

    # the remainder's one-variable operands
    x_vals: Dict[str, Expr] = {}
    y_vals: Dict[str, Expr] = {}
    mixed: set = set()
    seen: set = set()
    stack = [] if rem is None else [rem]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        mixed.add(_key(e, keys))
        for a in e.args if isinstance(e, Expr) and e.op not in ("var", "const", "int") else ():
            d = _deps(a, deps)
            if not d:
                continue
            if d == X:
                x_vals.setdefault(_key(a, keys), a)
            elif d == Y:
                y_vals.setdefault(_key(a, keys), a)
            else:
                stack.append(a)
    y_values = tuple(y_vals.values())
    if len(y_values) > TABLE_BUDGET:
        y_var = Expr("var", ("y",))
        tabled = (y_var,) + tuple(v for v in y_values if v.op != "var")[:TABLE_BUDGET - 1]
    else:
        tabled = y_values
    return Factored(terms=tuple(terms), remainder=rem, x_values=tuple(x_vals.values()),
                    y_values=y_values, tabled=tabled, remainder_nodes=len(mixed))


def slot_ids(fac: Factored) -> Tuple[Dict[int, int], Dict[int, int]]:
    """The remainder's operands that the pair body reads instead of
    computing: by ``id``, each node equal to an x value (its index in
    `x_values`), and each equal to a tabled y value (its index in
    `tabled`)."""
    keys: dict = {}
    x_index = {_key(v, keys): i for i, v in enumerate(fac.x_values)}
    y_index = {_key(v, keys): i for i, v in enumerate(fac.tabled)}
    xs, ys, seen, stack = {}, {}, set(), [fac.remainder]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        k = _key(e, keys)
        if k in x_index:
            xs[id(e)] = x_index[k]
        elif k in y_index:
            ys[id(e)] = y_index[k]
        elif e.op not in ("var", "const", "int"):
            stack.extend(e.args)
    return xs, ys


def factored_r_sums(fac: Factored):
    """R's inner sums A_j(X) = sum_y K(X, y) WX F_j(y) as the KT_GEN arm
    takes them from `fac`, on a twin's ``[G, B]`` tiles: the separable terms
    as sums over the nodes of g_i(y) WX F_j(y) times f_i(X), the remainder
    over every pair from the x values and tabled y values computed once per
    node. ``r_sums(X, WX, F) -> [A_j]`` (`numerical_coalescence.
    numerical_soa_plain`'s `r_sums`): `tools.opcount` counts the kernel's
    work through it."""
    xs, ys = slot_ids(fac) if fac.remainder is not None else ({}, {})

    def r_sums(X, WX, F):
        WF = [WX * f for f in F]
        n = len(fac.terms)
        gy = evaluate_many([g for _, g in fac.terms] + list(fac.tabled), X, X)
        fx = evaluate_many([f for f, _ in fac.terms] + list(fac.x_values), X, X)
        A = []
        for wf in WF:
            a = None
            for i in range(n):
                term = fx[i] * torch.sum(gy[i] * wf, dim=0, keepdim=True)
                a = term if a is None else a + term
            A.append(torch.zeros_like(X) if a is None else a)
        if fac.remainder is not None:
            xv, tab = fx[n:], gy[n:]
            for y in range(X.shape[0]):
                leaves = {**{k: xv[i] for k, i in xs.items()},
                          **{k: tab[i][y:y + 1] for k, i in ys.items()}}
                K = evaluate(fac.remainder, X, X[y:y + 1], leaves)
                A = [a + wf[y:y + 1] * K for a, wf in zip(A, WF)]
        return A

    return r_sums


def factored_source(fac: Factored, literal: Callable[[float], str]) -> str:
    """The factored form's device functions, beside ``cloudy_kernel_gen``
    (csrc/numerical_coalescence.cu's KT_GEN arm takes R from them):
    ``cloudy_gen_y`` (per outer node as y: the g_i and the tabled y
    values), ``cloudy_gen_x`` (per outer node as x: the f_i and the x
    values) and ``cloudy_gen_pair`` (the remainder of one pair from them,
    the tabled values read at a stride; 0 where K is separable)."""

    def body(roots, outs, leaves=None):
        lines, refs = statements_of(roots, literal, leaves)
        return [*(f"  {ln}" for ln in lines),
                *(f"  {o} = {r};" for o, r in zip(outs, refs))]

    n_terms, n_x, n_y = len(fac.terms), len(fac.x_values), len(fac.tabled)
    if fac.remainder is None:
        pair = ["  return T(0);"]
    else:
        xs, ys = slot_ids(fac)
        slots = {**{k: f"xv[{i}]" for k, i in xs.items()},
                 **{k: f"yv[{i} * ys]" for k, i in ys.items()}}
        lines, (ref,) = statements_of([fac.remainder], literal, slots)
        pair = [*(f"  {ln}" for ln in lines), f"  return {ref};"]
    return "\n".join([
        "// K(x, y) = sum_i f_i(x) g_i(y) + r(x, y) (ops/kernel_expr.py `factor`):",
        f"// separable terms {n_terms}; the remainder's operations per pair "
        f"{fac.remainder_nodes}, x values {n_x}, tabled y values {n_y}",
        f"constexpr int kGenTerms = {n_terms};",
        f"constexpr int kGenXValues = {n_x};",
        f"constexpr int kGenYValues = {n_y};",
        f"constexpr bool kGenRemainder = {'true' if fac.remainder is not None else 'false'};",
        "template <typename T>",
        "__device__ __forceinline__ void cloudy_gen_y(T y, T* g, T* yv) {",
        *body([g for _, g in fac.terms] + list(fac.tabled),
              [f"g[{i}]" for i in range(n_terms)] + [f"yv[{i}]" for i in range(n_y)]),
        "}",
        "template <typename T>",
        "__device__ __forceinline__ void cloudy_gen_x(T x, T* f, T* xv) {",
        *body([f for f, _ in fac.terms] + list(fac.x_values),
              [f"f[{i}]" for i in range(n_terms)] + [f"xv[{i}]" for i in range(n_x)]),
        "}",
        "template <typename T>",
        "__device__ __forceinline__ T cloudy_gen_pair(const T* xv, const T* yv, int ys) {",
        *pair,
        "}",
    ])
