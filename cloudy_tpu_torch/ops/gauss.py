"""Fixed-node Gauss quadrature rules (host-side numpy nodes, torch mapping).

Port of `cloudy_tpu.ops.gauss`: static Gauss–Legendre panels, optionally in
log space.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def gauss_legendre(n: int):
    """Nodes/weights on [-1, 1] (cached, numpy)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


def nodes_on_interval(n: int, a, b):
    """GL nodes/weights mapped to [a, b]; a, b are tensors (broadcast against
    the node axis appended last)."""
    x, w = gauss_legendre(n)
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    x = torch.as_tensor(x, dtype=a.dtype, device=a.device)
    w = torch.as_tensor(w, dtype=a.dtype, device=a.device)
    half = 0.5 * (b[..., None] - a[..., None])
    return a[..., None] + half * (x + 1.0), half * w


def log_nodes(n: int, x_lo, x_hi):
    """GL nodes/weights for ∫ f(x) dx with substitution x = e^u,
    u ∈ [log x_lo, log x_hi]: returns (x_nodes, weights) with the Jacobian x
    folded into the weights."""
    u, wu = nodes_on_interval(n, torch.log(torch.as_tensor(x_lo)),
                              torch.log(torch.as_tensor(x_hi)))
    x = torch.exp(u)
    return x, wu * x
