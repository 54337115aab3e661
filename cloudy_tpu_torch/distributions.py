"""Particle mass distributions: the moment closure (reference layer L2).

Port of `cloudy_tpu.distributions` for the families the fixed-threshold
gamma path runs (gamma, exponential, monodisperse). A spectrum is a static
`SpectrumSpec` plus a dense parameter tensor

    params : [..., n_modes, 3]

whose columns mean (n, θ, k) for gamma and (n, θ, ·) for exponential /
monodisperse. Every function is branch-free over arbitrary leading batch
axes, with the JAX package's operation order.
"""

from __future__ import annotations

import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.ops import special

# Default shape-parameter clipping range for the gamma closure inversion
# (reference param_range, src/ParticleDistributions/ParticleDistributions.jl:459).
GAMMA_K_RANGE = (None, 10.0)  # (eps(dtype), 10.0)

LOGNORMAL_TODO = "lognormal modes are not ported yet (ROADMAP A.7)"


def _eps(dtype):
    return torch.finfo(dtype).eps


# --------------------------------------------------------------------------
# closure inversion: moments -> parameters
# --------------------------------------------------------------------------


def _invert_exponential(m):
    """(M0, M1) -> (n, θ): n = M0, θ = M1/M0, zero-dist fallback for
    degenerate moments (reference :512-523)."""
    m0, m1 = m[..., 0], m[..., 1]
    eps = _eps(m0.dtype)
    valid = (m0 > eps) & (m1 > eps)
    m0s = special.select(valid, m0, 1.0)
    m1s = special.select(valid, m1, 1.0)
    n = special.select(valid, m0, 0.0)
    theta = special.select(valid, m1s / m0s, 1.0)
    return torch.stack([n, theta, torch.zeros_like(n)], dim=-1)


def _invert_gamma(m, k_range=GAMMA_K_RANGE):
    """(M0, M1, M2) -> (n, θ, k) with k = (M1/M0)/(M2/M1 − M1/M0) clipped to
    `k_range` and θ = (M1/M0)/k (reference :456-476)."""
    m0, m1, m2 = m[..., 0], m[..., 1], m[..., 2]
    eps = _eps(m0.dtype)
    k_lo = eps if k_range[0] is None else k_range[0]
    k_hi = float("inf") if k_range[1] is None else k_range[1]
    valid = (m0 > eps) & (m1 > eps)
    m0s = special.select(valid, m0, 1.0)
    m1s = special.select(valid, m1, 1.0)
    m2s = special.select(valid, m2, 2.0)
    mean = m1s / m0s
    denom = m2s / m1s - mean
    denom = special.select(torch.abs(denom) > 0, denom, eps)
    k = torch.clamp(mean / denom, k_lo, k_hi)
    theta = mean / k
    n = special.select(valid, m0, 0.0)
    theta = special.select(valid, theta, 1.0)
    k = special.select(valid, k, 1.0)
    return torch.stack([n, theta, k], dim=-1)


def params_from_moments(
    spec: SpectrumSpec, mom_flat, gamma_k_range=GAMMA_K_RANGE
) -> torch.Tensor:
    """Closure inversion: flat prognostic moments ``[..., n_tot]`` ->
    parameters ``[..., n_modes, 3]`` (reference `update_dist_from_moments`,
    src/ParticleDistributions/ParticleDistributions.jl:456-541)."""
    parts = []
    for i, fam in enumerate(spec.families):
        o, n = spec.offsets[i], spec.nprogmoms[i]
        block = mom_flat[..., o : o + n]
        if fam == Family.GAMMA:
            parts.append(_invert_gamma(block, gamma_k_range))
        elif fam in (Family.EXPONENTIAL, Family.MONODISPERSE):
            parts.append(_invert_exponential(block))  # same algebra (:530-541)
        else:
            raise NotImplementedError(LOGNORMAL_TODO)
    return torch.stack(parts, dim=-2)


def get_moments(spec: SpectrumSpec, params) -> torch.Tensor:
    """Parameters -> flat prognostic moments ``[..., n_tot]``: the inverse of
    `params_from_moments` (reference `get_moments`,
    src/ParticleDistributions/ParticleDistributions.jl:293-315)."""
    out = []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (params[..., i, j] for j in range(3))
        if fam == Family.EXPONENTIAL or fam == Family.MONODISPERSE:
            out.extend([n, n * p1])
        elif fam == Family.GAMMA:
            out.extend([n, n * p2 * p1, n * p2 * (p2 + 1.0) * p1**2])
        else:
            raise NotImplementedError(LOGNORMAL_TODO)
    return torch.stack(out, dim=-1)


# --------------------------------------------------------------------------
# analytic moments
# --------------------------------------------------------------------------


def _integer_moments_one_mode(fam: Family, n, p1, p2, n_cols: int):
    """Moments of integer orders 0..n_cols-1 by multiplicative recurrence:
    exp M_{o+1} = M_o θ (o+1); gamma M_{o+1} = M_o θ (k+o); mono
    M_{o+1} = M_o θ. Returns [..., n_cols]."""
    cols = [n]
    m = n
    for o in range(n_cols - 1):
        if fam == Family.EXPONENTIAL:
            m = m * p1 * (o + 1.0)
        elif fam == Family.GAMMA:
            m = m * p1 * (p2 + o)
        elif fam == Family.MONODISPERSE:
            m = m * p1
        else:
            raise NotImplementedError(LOGNORMAL_TODO)
        cols.append(m)
    return torch.stack(cols, dim=-1)


def moments_matrix(spec: SpectrumSpec, params, n_cols: int) -> torch.Tensor:
    """Dense diagnostic moment matrix ``[..., n_modes, n_cols]`` (reference
    `get_moments_matrix`, src/Sources/Coalescence.jl:187-198)."""
    rows = [
        _integer_moments_one_mode(
            fam, params[..., i, 0], params[..., i, 1], params[..., i, 2], n_cols
        )
        for i, fam in enumerate(spec.families)
    ]
    return torch.stack(rows, dim=-2)


def moment(spec: SpectrumSpec, params, q) -> torch.Tensor:
    """Real-order q-th moment per mode, ``[..., n_modes]``: exp n θ^q Γ(q+1);
    gamma n θ^q Γ(q+k)/Γ(k); mono n θ^q (reference `moment_func`,
    src/ParticleDistributions/ParticleDistributions.jl:177-218)."""
    q = torch.as_tensor(q, dtype=params.dtype, device=params.device)
    out = []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (params[..., i, j] for j in range(3))
        if fam == Family.EXPONENTIAL:
            m = n * special.exp(q * torch.log(p1) + special.lgamma(q + 1.0))
        elif fam == Family.GAMMA:
            m = n * special.exp(
                q * torch.log(p1) + special.lgamma(q + p2) - special.lgamma(p2)
            )
        elif fam == Family.MONODISPERSE:
            m = n * special.powx(p1, q)
        else:
            raise NotImplementedError(LOGNORMAL_TODO)
        out.append(m)
    return torch.stack(out, dim=-1)


# --------------------------------------------------------------------------
# the autoconversion log grid
# --------------------------------------------------------------------------


def threshold_log_grid(x_threshold, n_points_max: int, dtype=torch.float64,
                       n_bins_per_log_unit: int = 15):
    """Log-spaced grid replicating the reference's discretization
    (src/ParticleDistributions/ParticleDistributions.jl:579-585):
    ``x_lo = min(1e-5, 1e-5 T)``, ``n_bins = floor(15 log10(T / x_lo))``,
    even spacing in log x, static length `n_points_max`.

    Returns (x [..., n_points_max], dx [...], n_bins [...] int32)."""
    t = torch.as_tensor(x_threshold, dtype=dtype)
    x_lo = torch.clamp(1e-5 * t, max=1e-5)
    ratio = torch.log10(t / x_lo)
    n_bins = torch.floor(n_bins_per_log_unit * ratio).to(torch.int32)
    n_bins = torch.clamp(n_bins, max=n_points_max - 1)
    x_min = torch.log(x_lo)
    dx = (torch.log(t) - x_min) / n_bins.to(dtype)
    j = torch.arange(1, n_points_max + 1, dtype=dtype, device=t.device)
    x = torch.exp(x_min[..., None] + (j - 1.0) * dx[..., None])
    return x, dx, n_bins
