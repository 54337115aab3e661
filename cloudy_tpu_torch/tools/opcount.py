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

The twins evaluate each lane's series or continued fraction (the
incomplete gamma, and erf through P(½, z²)) only where the lane selects it,
so a count covers what the data needs. Run as a script it prints the count
per box of the numerical bench's twin and its split between the Q/S inner
loop, the R loop and the rest, fitted from counts at other node budgets
(no device needed):

    python -m cloudy_tpu_torch.tools.opcount
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and not name.startswith(_NO_ARITHMETIC)):
            # a sum does one add per element it reads
            reads = name.startswith("sum") and isinstance(args[0], torch.Tensor)
            self.ops += args[0].numel() if reads else out.numel()
        return out


def count_ops(fn, *args) -> int:
    """Floating-point elements produced by the arithmetic operations of
    ``fn(*args)``."""
    with _Counter() as counter:
        fn(*args)
    return counter.ops


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
