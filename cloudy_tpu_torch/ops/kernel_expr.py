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

What the operands cover: ``+ - * / **`` and their reflected forms, unary
minus, ``abs``, the comparisons and ``& | ~`` on their results (the masks of
`torch.where`), and through `__torch_function__` the torch functions in
`TORCH_FUNCTIONS`. Integer powers become products. A numpy scalar on the
left (`kernels.CoalescenceTensor.__call__` multiplies a ``numpy.float64``
coefficient by ``x**a``) hands the operation to the operand's reflected
method, because the operand sets ``__array_ufunc__ = None``. Anything else,
and any Python branch on an operand's value, raises `KernelTraceError`
naming the operation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


class KernelTraceError(NotImplementedError):
    """The kernel function used an operation the tracer does not cover."""


def _unsupported(what: str) -> KernelTraceError:
    return KernelTraceError(
        f"the kernel-function tracer does not cover {what}: the CUDA quadrature "
        "kernel evaluates K(x, y) from a trace of + - * / **, abs, comparisons, "
        "& | ~ and " + ", ".join(f"torch.{n}" for n in sorted(_TORCH_NAMES)))


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

    def __neg__(self):
        return Expr("neg", (self,))

    def __pos__(self):
        return self

    def __abs__(self):
        return Expr("abs", (self,))

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
        if not self.boolean:
            raise _unsupported("~ on a value that is not a mask")
        return Expr("not", (self,), True)

    # ---- what a trace cannot follow ----------------------------------------
    def __bool__(self):
        raise _unsupported("a Python branch on the value of x or y (use torch.where)")

    def __float__(self):
        raise _unsupported("float() of x or y")

    def __index__(self):
        raise _unsupported("an integer from x or y")

    def __mod__(self, o):
        raise _unsupported("%")

    __rmod__ = __mod__

    def __floordiv__(self, o):
        raise _unsupported("//")

    __rfloordiv__ = __floordiv__

    def __matmul__(self, o):
        raise _unsupported("@")

    __rmatmul__ = __matmul__

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise _unsupported(f"the attribute or method .{name}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", repr(func))
        rule = TORCH_FUNCTIONS.get(name)
        if rule is None or getattr(torch, name, None) is not func:
            raise _unsupported(f"torch.{name}")
        return rule(*args, **kwargs)


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


def _cmp(op: str, a, b) -> Expr:
    a, b = _wrap(a), _wrap(b)
    return Expr(op, (a, b), True)


def _logic(op: str, a, b) -> Expr:
    a, b = _wrap(a), _wrap(b)
    if not (a.boolean and b.boolean):
        raise _unsupported(f"{'&' if op == 'and' else '|'} on values that are not masks")
    return Expr(op, (a, b), True)


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
    return Expr("pow", (a, b))


def _where(cond, a, b) -> Expr:
    cond = _wrap(cond)
    if not cond.boolean:
        raise _unsupported("torch.where on a condition that is not a mask")
    return Expr("where", (cond, _wrap(a), _wrap(b)))


def _clamp(x, min=None, max=None):
    out = _wrap(x)
    if min is not None:
        out = Expr("max", (out, _wrap(min)))
    if max is not None:
        out = Expr("min", (out, _wrap(max)))
    return out


def _unary(op):
    return lambda x, **kw: Expr(op, (_wrap(x),))


#: the torch functions a kernel function may call on x and y, by name
TORCH_FUNCTIONS: Dict[str, Callable] = {
    "exp": _unary("exp"),
    "log": _unary("log"),
    "sqrt": _unary("sqrt"),
    "abs": _unary("abs"),
    "pow": lambda a, b: _pow(a, b),
    "where": _where,
    "minimum": lambda a, b: Expr("min", (_wrap(a), _wrap(b))),
    "maximum": lambda a, b: Expr("max", (_wrap(a), _wrap(b))),
    "clamp": _clamp,
    "broadcast_tensors": lambda *xs: tuple(xs),
    "full_like": lambda x, fill_value, **kw: const(fill_value),
}
_TORCH_NAMES = tuple(TORCH_FUNCTIONS)


def trace(kernel_func: Callable) -> Expr:
    """K(x, y) as an expression of the variables ``x`` and ``y``."""
    out = kernel_func(Expr("var", ("x",)), Expr("var", ("y",)))
    out = _wrap(out)
    if out.boolean:
        raise _unsupported("a mask as the kernel's value")
    return out


# --------------------------------------------------------------------------
# emission
# --------------------------------------------------------------------------

_BINARY_C = {"add": "+", "sub": "-", "mul": "*", "div": "/",
             "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
             "and": "&&", "or": "||"}
_CALL_C = {"exp": "dexp", "log": "dlog", "sqrt": "dsqrt", "abs": "dabs",
           "pow": "dpow", "min": "vmin", "max": "vmax"}


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
        else:
            args = [emit(a) for a in e.args]
            if e.op in _BINARY_C:
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


_TORCH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
              "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
              "eq": torch.eq, "ne": torch.ne, "and": torch.logical_and,
              "or": torch.logical_or, "not": torch.logical_not, "neg": torch.neg,
              "abs": torch.abs, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
              "pow": torch.pow, "min": torch.minimum, "max": torch.maximum,
              "where": torch.where}


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
        vals, keys = zip(*(ev(a) for a in e.args))
        key = f"{e.op}({','.join(keys)})"
        if key not in memo:
            memo[key] = _TORCH_OPS[e.op](*vals)
        return memo[key], key

    out, _ = ev(expr)
    return out.expand(torch.broadcast_shapes(x.shape, y.shape, out.shape))


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
