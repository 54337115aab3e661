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
`evaluate` computes a trace on tensors as that function does, for
`tools.opcount`'s count of the operations it needs.

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
  angle (of a real), relu, selu, celu (also as `torch.nn.functional`'s
  relu, selu, celu), ndtr; the masks isnan, isinf, isfinite, isposinf,
  isneginf, signbit (bool, usable in `where` and ``& | ~``) and
  nan_to_num (its defaults the traced type's largest and lowest values);
- torch's special functions, its own algorithms copied into
  csrc/special_functions.cuh: log_ndtr, digamma (psi), polygamma,
  zeta (Hurwitz), igamma/igammac (gammainc/gammaincc), mvlgamma
  (multigammaln, as torch's sum of lgammas), i0, i0e, i1, i1e,
  modified_bessel_i0/i1, bessel_j0/j1. polygamma's n and mvlgamma's p are
  a Python int or a 0-d integer tensor, compile-time constants of the
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
- a Python branch on an operand's value, reductions (``x.sum()``,
  `torch.cumsum`), indexing and shape changes, in-place methods
  (``x.add_``), dtype changes (``x.double()``, `torch.float_power`), random
  draws, losses, `torch.isclose` / `torch.isin`, ``alpha`` scaling of
  add/sub/rsub, an operand as polygamma's n or mvlgamma's p;
- `torch.nn.functional`'s forms outside the `torch` namespace (softplus,
  gelu, ...), and any other function not listed.
"""

from __future__ import annotations

import contextvars
import functools
import math
from typing import Callable, Dict, List, Tuple

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
#: the elementwise functions emitted as a call of a csrc/common.cuh (or
#: special_functions.cuh) helper, ``d<op>`` but for jnp's and torch's
#: NaN-propagating min/max (``vmin``, ``vmax``), torch.round's half to even
#: (``drint``), ``dfloordiv``, digamma (``dpsi``), the incomplete gammas
#: (``dgammainc``, ``dgammaincc``) and modified_bessel_i0, which is i0's
#: arithmetic; ``logit`` takes an ``eps``, ``celu`` its alpha and 1/alpha,
#: ``nan_to_num`` its three replacements, ``polygamma`` its order as a
#: template argument
_CALL_C = {**{op: f"d{op}" for op in _UNARY_CALLS + _BINARY_CALLS + _MASK_CALLS
              + ("pow", "logit", "celu", "nan_to_num", "polygamma")},
           "min": "vmin", "max": "vmax", "round": "drint", "floor_divide": "dfloordiv",
           "digamma": "dpsi", "igamma": "dgammainc", "igammac": "dgammaincc",
           "modified_bessel_i0": "di0"}
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


#: the torch.nn.functional forms of covered torch functions (the others,
#: such as softplus or gelu, stay refused)
_FUNCTIONAL = {"relu": _no_inplace(_unary("relu")), "selu": _no_inplace(_unary("selu")),
               "celu": _no_inplace(_celu)}


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
    for name in _FUNCTIONAL:
        f = getattr(torch.nn.functional, name)
        rules[f], names[f] = _FUNCTIONAL[name], f"torch.nn.functional.{name}"
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
    lines: List[str] = []
    names: Dict[str, str] = {}
    memo: Dict[int, str] = {}

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

    return lines, emit(expr)


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
              "polygamma": torch.polygamma}


def evaluate(expr: Expr, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`expr` on tensors, as the emitted function computes it: each distinct
    subexpression once (as `statements` shares them), at the shape its own
    operands broadcast to. `tools.opcount` counts a twin's kernel function
    through it."""
    memo: Dict[str, torch.Tensor] = {}

    def ev(e: Expr):
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

    out, _ = ev(expr)
    return out.expand(torch.broadcast_shapes(x.shape, y.shape, out.shape))


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
