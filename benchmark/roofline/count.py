"""The operation counter of the rooflines: a dispatch mode that adds up,
over every operation of a plain function that returns a floating-point
tensor and is not a pure copy or reshape, the number of elements it
produces (a sum: the elements it reads). A transcendental or a divide
counts as one, like an add. Copied from the port's tools/opcount.py
(`_Counter`, `count_ops`) and applied here to the benchmark's own frozen
reference, so that a kernel's bound counts the same work whatever
implements it. The count does not depend on the device or the type."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
        if not isinstance(out, torch.Tensor) or (name.startswith(_NO_ARITHMETIC)
                                                 and not name.startswith("copysign")):
            return out
        if out.is_floating_point():
            reads = name.startswith("sum") and isinstance(args[0], torch.Tensor)
            self.ops += args[0].numel() if reads else out.numel()
        return out


def count_ops(fn, *args) -> int:
    """Floating-point elements produced by the arithmetic of ``fn(*args)``."""
    with _Counter() as counter:
        fn(*args)
    return counter.ops
