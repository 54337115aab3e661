"""Debugging aids: a call counter and a NaN check on every operation.

Port of `cloudy_tpu.utils.debug` where it has an eager-torch meaning.
`trace_counter` counts calls of a function. `debug_nans` is the counterpart
of `jax_debug_nans`: under it, the first operation whose floating output
holds a NaN raises. (`torch.autograd.set_detect_anomaly` checks only the
backward pass.) The JAX module's retrace guard and HLO probes have no
eager-torch meaning and are not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_CHECKING = contextvars.ContextVar("cloudy_tpu_torch_debug_nans", default=False)


def trace_counter(fn: Callable):
    """Wrap `fn` so its calls are counted: returns (wrapped, counts) with
    ``counts["n"]`` the number of calls so far."""
    counts = {"n": 0}

    def wrapped(*args, **kwargs):
        counts["n"] += 1
        return fn(*args, **kwargs)

    return wrapped, counts


class _NanCheck(TorchDispatchMode):
    """Runs each operation, then raises `FloatingPointError` if a floating
    output holds a NaN (while `_CHECKING` is set)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _CHECKING.get():
            for leaf in tree_leaves(out):
                if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                        and bool(torch.isnan(leaf).any())):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the block, raise `FloatingPointError` at the first operation
    whose floating output holds a NaN (``enable=False``: check nothing, also
    inside an enclosing ``debug_nans()``); the previous state returns on
    exit. Every operation's outputs are read on the host, so on the card
    each operation synchronises: a debugging aid, not a production mode."""
    token = _CHECKING.set(enable)
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _CHECKING.reset(token)
