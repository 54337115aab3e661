"""Fixed-grid Simpson integration on evenly spaced points.

Port of `cloudy_tpu.ops.simpson`: the reference's `integrate_SimpsonEvenFast`
(src/ParticleDistributions/ParticleDistributions.jl:698-710) with
17/59/43/49-weight endpoint corrections, as a static numpy weight vector and
as a dynamic masked torch weight vector over a fixed-size grid. Both keep the
reference's quirk that the last grid point ``j = n_bins + 1`` is weighted
17/48 while its integrand is defined to be zero.
"""

from __future__ import annotations

import numpy as np
import torch


def simpson_even_fast_weights(n_bins: int) -> np.ndarray:
    """Static weights w (length n_bins + 1) such that
    ``integral = dx * sum_j w[j] * y[j]`` matches the reference rule."""
    if n_bins < 3:
        raise ValueError("n_bins must be at least 3")
    e = n_bins + 1  # number of points, 1-based last index
    w = np.zeros(e, dtype=np.float64)
    for j in range(5, n_bins - 3 + 1):
        w[j - 1] += 1.0
    for j, c in ((1, 17.0), (2, 59.0), (3, 43.0), (4, 49.0)):
        w[j - 1] += c / 48.0
    for j, c in ((e, 17.0), (e - 1, 59.0), (e - 2, 43.0), (e - 3, 49.0)):
        w[j - 1] += c / 48.0
    return w


def simpson_even_fast_weights_dynamic(n_points_max: int, n_bins, dtype=torch.float64):
    """Dynamic-`n_bins` masked weights over a fixed grid of `n_points_max`
    points (1-based j = 1..n_points_max); entries with j > n_bins + 1 get
    weight zero. `n_bins` is an integer tensor (any batch shape)."""
    nb = torch.as_tensor(n_bins)[..., None]
    j = torch.arange(1, n_points_max + 1, device=nb.device)
    e = nb + 1
    w = ((j >= 5) & (j <= nb - 3)).to(dtype)
    for jj, c in ((1, 17.0), (2, 59.0), (3, 43.0), (4, 49.0)):
        w = w + ((j == jj).to(torch.float64) * (c / 48.0)).to(dtype)
    for off, c in ((0, 17.0), (1, 59.0), (2, 43.0), (3, 49.0)):
        w = w + ((j == e - off).to(torch.float64) * (c / 48.0)).to(dtype)
    return w


def integrate_simpson_even_fast(y, dx, weights):
    """``dx * sum(w * y)`` along the last axis."""
    return dx * torch.sum(weights * y, dim=-1)
