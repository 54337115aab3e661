"""Count the arithmetic a plain twin does, for a kernel's roofline bound.

A twin (`ops.fused_coalescence.*_soa_plain`, `ops.numerical_coalescence.
numerical_soa_plain`) repeats its kernel's arithmetic as a sequence of
elementwise torch operations. `count_ops` runs a function under a dispatch
mode and adds up, over every operation that returns a floating-point tensor
and is not a pure copy or reshape, the number of elements it produces: one
operation per output element, a transcendental or a divide counted as one
like an add (a sum counts the elements it reads). Divided by the number of
lanes (or boxes) of the input it is the operation count per lane that
`bound_ms` uses:

    bound_ms = max(bytes / memory rate, operations / peak rate)

with each input read once and each output written once. The count does not
depend on the device, so it can be taken on a few lanes and scaled.

`count_ops_by_class` splits the same count by the primitive operation
classes of the chain benchmark (B6: mul, add, div, exp, log, sqrt, sel),
so that `tools.op_microbench.predict_ms` can price a twin's arithmetic at
the card's measured cost per class; an operation of no class (the
trigonometric, error-function, rounding and modulus functions a traced
kernel function may call, `ops.kernel_expr`, each one operation) stands
under ``other`` by its aten name.

The twins evaluate each lane's series or continued fraction (the
incomplete gamma, and erf through P(½, z²)) only where the lane selects it,
so a count covers what the data needs. The twin of a wrapper whose kernel
stops the lower series early (its `series_exit`: a generated reference-tier
unit) is counted with each lane's series stopped where the kernel stops it
(`fused_coalescence.series_exit`); every other twin runs its fixed count.
Run as a script it prints the count
per box of the numerical bench's twin and its split between the Q/S inner
loop, the R loop and the rest, fitted from counts at other node budgets
(no device needed):

    python -m cloudy_tpu_torch.tools.opcount
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): the device
#: memory rate in bytes/s and the float32 rate outside the tensor cores in
#: operations/s
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
#: the float64 rate outside the tensor cores (the same data sheet)
H100_F64_OPS_PER_S = 34e12

#: operations that move or reinterpret data without arithmetic
_NO_ARITHMETIC = (
    "view", "reshape", "slice", "select", "expand", "permute", "transpose", "t.",
    "clone", "copy", "_to_copy", "cat", "stack", "unsqueeze", "squeeze", "alias",
    "detach", "empty", "zeros", "ones", "full", "as_strided", "unbind", "split",
    "lift_fresh", "contiguous", "scalar_tensor", "arange", "index", "roll",
)


#: aten operations by the primitive class of the chain benchmark
#: (`ops.op_chains.PRIMITIVE_CLASSES`); add counts sub, neg, min, max and
#: clamp as the JAX tool's comment on its chains does, and a sum one add
#: per element it reads
_CLASS_OF = {
    "mul": "mul",
    "add": "add", "sub": "add", "rsub": "add", "neg": "add", "minimum": "add",
    "maximum": "add", "fmin": "add", "fmax": "add", "clamp": "add", "clamp_min": "add",
    "clamp_max": "add",
    "sum": "add",
    "div": "div", "reciprocal": "div",
    "exp": "exp",
    "log": "log",
    "sqrt": "sqrt",
    "where": "sel",
}


#: operations whose result does not depend on the values of their arguments
_FACTORIES = ("empty", "zeros", "ones", "full", "scalar_tensor", "arange")


class _Counter(TorchDispatchMode):
    def __init__(self, data=None):
        super().__init__()
        self.ops = 0
        self.by_op = {}
        self.predicates = {}
        # with `data`: the tensors that depend on it by id, held so that no
        # other tensor takes their id; only operations on them are counted
        self.data = None if data is None else {id(t): t for t in data}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        if self.data is not None:
            if name.startswith(_FACTORIES) or not any(
                    id(a) in self.data for a in tree_leaves((args, kwargs))):
                return out
            self.data.update((id(t), t) for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor))
        # copysign starts as a copy does, and is arithmetic
        if not isinstance(out, torch.Tensor) or (name.startswith(_NO_ARITHMETIC)
                                                 and not name.startswith("copysign")):
            return out
        op = name.split(".")[0].rstrip("_")
        if out.is_floating_point():
            # a sum does one add per element it reads
            reads = name.startswith("sum") and isinstance(args[0], torch.Tensor)
            n = args[0].numel() if reads else out.numel()
            self.ops += n
            self.by_op[op] = self.by_op.get(op, 0) + n
        elif out.dtype == torch.bool:
            self.predicates[op] = self.predicates.get(op, 0) + out.numel()
        return out


def _run(fn, args, data_only: bool, series_exit=None) -> _Counter:
    from cloudy_tpu_torch.ops import fused_coalescence as fc

    if series_exit is None:  # a wrapper's twin: as its kernel sums the series
        series_exit = getattr(getattr(fn, "__self__", None), "series_exit", False)
    data = [a for a in args if isinstance(a, torch.Tensor)] if data_only else None
    with fc.series_exit() if series_exit else contextlib.nullcontext():
        with _Counter(data) as counter:
            fn(*args)
    return counter


def count_ops(fn, *args, data_only: bool = False, series_exit: bool = None) -> int:
    """Floating-point elements produced by the arithmetic operations of
    ``fn(*args)``. `data_only` counts only the operations whose result
    depends on the tensors of `args`: an operation on constants alone (a
    scalar parameter broadcast to the data's shape) is one a kernel does
    once, not per element. `series_exit` counts the lower series stopped
    lane by lane (`fused_coalescence.series_exit`); by default it follows
    the wrapper of which `fn` is the bound twin (its `series_exit`), and is
    off for any other callable."""
    return _run(fn, args, data_only, series_exit).ops


def count_ops_by_class(fn, *args, data_only: bool = False, series_exit: bool = None) -> dict:
    """`count_ops` split by the chain benchmark's primitive classes (mul,
    add, div, exp, log, sqrt, sel): ``{class: n, ..., "other": {op: n},
    "predicate": {op: n}}``. The classes and ``other`` (the floating-point
    operations of no class, by aten name) add up to `count_ops`;
    ``predicate`` holds the operations with a boolean result (comparisons,
    logical operations), which `count_ops` does not count and the class model
    prices as adds. `data_only` and `series_exit` as in `count_ops`."""
    from cloudy_tpu_torch.ops.op_chains import PRIMITIVE_CLASSES

    counter = _run(fn, args, data_only, series_exit)
    out = {c: 0 for c in PRIMITIVE_CLASSES}
    other = {}
    for op, n in sorted(counter.by_op.items()):
        if op in _CLASS_OF:
            out[_CLASS_OF[op]] += n
        else:
            other[op] = n
    out["other"] = other
    out["predicate"] = dict(sorted(counter.predicates.items()))
    return out


def count_ops_traced(fn, mom: torch.Tensor) -> int:
    """`count_ops` of the twin of a B5 wrapper whose kernel function is
    traced (``KT_GEN``), with the work its kernel does: the kernel function
    evaluated as the device functions emitted from the trace compute it
    (`kernel_expr.evaluate`: the twin calls the callable as written, a
    tensor's ``x**0``, its multiply by one, a product computed again in
    each term, which the emitted functions fold or share), and R from the
    factored form (`kernel_expr.factored_r_sums`): each one-variable value
    once per outer node, the separable terms as block sums, the remainder
    alone per pair. Q/S evaluates the whole K at each inner node."""
    import dataclasses

    from cloudy_tpu_torch.ops import kernel_expr
    from cloudy_tpu_torch.ops import numerical_coalescence as nc

    expr = kernel_expr.trace(fn.plan.kernel_func, fn.dtype)
    plan = dataclasses.replace(fn.plan,
                               kernel_func=lambda x, y: kernel_expr.evaluate(expr, x, y))
    r_sums = kernel_expr.factored_r_sums(kernel_expr.factor(expr))
    return count_ops(lambda m: nc.numerical_soa_plain(m, plan, r_sums), mom)


def bound_ms(n_bytes: float, n_ops: float, f64: bool = False):
    """(bound in ms, "bytes" or "operations"): the least time one H100 could
    take to move `n_bytes` or to do `n_ops` float32 (`f64`: float64)
    operations."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / (H100_F64_OPS_PER_S if f64 else H100_F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def numerical_bench_shares(n_boxes: int = 64) -> dict:
    """Operations per box of the numerical bench's twin and their shares:
    the count is c0 + l·G + r·G² + q·G·g with G outer and g inner nodes, so
    counts at two inner and three outer budgets give q (the Q/S loop), r
    (the R loop) and the rest."""
    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    kf = bench.numerical_fn("cpu").plan.kernel_func
    mom = torch.as_tensor(bench.numerical_moments(n_boxes).T.copy(), dtype=torch.float32)

    def count(n_outer, n_inner):
        fn = nc.make_numerical_fn(spec, kf, n_outer, n_inner, device="cpu")
        plan = fn.plan
        return (count_ops(fn.plain, mom) / n_boxes, plan.g_total,
                plan.n_pi * plan.g_inner)

    total, G, g = count(96, 48)
    half_inner, _, g2 = count(96, 24)
    qs = (total - half_inner) / (g - g2) * g
    rows, rhs = [[1.0, G, G * G]], [total - qs]
    for n_outer in (48, 24):
        t, Gn, _ = count(n_outer, 48)
        rows.append([1.0, Gn, Gn * Gn])
        rhs.append(t - qs * Gn / G)
    _, _, r = np.linalg.solve(np.asarray(rows), np.asarray(rhs))
    return {"operations_per_box": total, "outer_nodes": G, "inner_nodes": g,
            "qs_loop_share": qs / total, "r_loop_share": r * G * G / total,
            "rest_share": 1.0 - (qs + r * G * G) / total}


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps(numerical_bench_shares()))
