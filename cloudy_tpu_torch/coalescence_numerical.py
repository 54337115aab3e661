"""Collision–coalescence via direct numerical quadrature (validation path).

Port of `cloudy_tpu.coalescence_numerical` (reference
`get_coal_ints(::NumericalCoalStyle, …)`, src/Sources/Coalescence.jl:470-708,
a doubly nested adaptive quadrature with an arbitrary kernel *function*).
Fixed-node Gauss–Legendre panels replace the adaptive rule: a log-spaced
outer grid spanning the distributions' support and a scaled inner grid
(y = s·x for the triangular gain integrals). Everything is batched einsums
over ``[..., Gx, Gs]`` intermediates held in device memory; the CUDA kernel
of `ops.numerical_coalescence` computes the same quadrature fused, one
block per box.

Integral structure (0-based mode indices, m = moment order):
  Q[m,j,k] (j<k) = ∫₀^∞ x^m ∫₀^x ½K(x−y,y)[f_j(x−y)f_k(y)+f_k(x−y)f_j(y)] dy dx
  R[m,j,k]       = ∫₀^∞ x^m f_k(x) ∫₀^∞ K(x,y) f_j(y) dy dx
  S1/S2[m,k]     = ∫₀^∞ x^m w_k(x) / (1−w_k(x)) · ½∫₀^x K(x−y,y) f_k(x−y) f_k(y) dy dx
with w_k the normalized-density weighting function (reference :624-642).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import distributions as pdists
from cloudy_tpu_torch.ops import special
from cloudy_tpu_torch.ops.gauss import gauss_legendre


def support_bounds(spec: SpectrumSpec, params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch (x_lo, x_hi) covering the numerically relevant support of
    every mode (tail quantiles from closed forms; generous margins)."""
    dtype = params.dtype
    inf = torch.tensor(float("inf"), dtype=dtype, device=params.device)
    los, his = [], []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (params[..., i, j] for j in range(3))
        if fam == Family.EXPONENTIAL:
            lo, hi = p1 * 1e-8, p1 * 40.0
        elif fam == Family.GAMMA:
            log_eps = torch.log(torch.tensor(1e-12, dtype=dtype, device=params.device))
            lo = p1 * torch.exp(log_eps / torch.clamp(p2, min=0.05))
            lo = torch.maximum(lo, p1 * 1e-12)
            hi = p1 * (p2 + 30.0 * torch.sqrt(p2) + 40.0)
        elif fam == Family.LOGNORMAL:
            lo, hi = torch.exp(p1 - 8.0 * p2), torch.exp(p1 + 8.0 * p2)
        else:  # MONODISPERSE
            lo, hi = p1 * 0.5, p1 * 2.5
        # inactive modes (n = 0) must not drag the bounds
        active = n > 0.0
        los.append(torch.where(active, lo, inf))
        his.append(special.select(active, hi, 0.0))
    x_lo = torch.clamp(torch.stack(los, -1).amin(-1), max=1e30)
    x_hi = torch.clamp(torch.stack(his, -1).amax(-1), min=1e-30)
    x_lo = torch.minimum(x_lo, x_hi * 1e-12)
    # keep the log grid finite in f32 for all-empty states (no-op in f64)
    tiny = torch.finfo(dtype).tiny
    return torch.clamp(x_lo, min=tiny), torch.clamp(2.0 * x_hi, min=4.0 * tiny)


def _densities_all(spec, params, x, normed: bool = False):
    """Density of every mode at x[..., G...]: returns [..., N, G...]."""
    extra = (None,) * (x.ndim - params.ndim + 2)
    mats = []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (params[..., i, j][(..., *extra)] for j in range(3))
        mats.append(pdists._density_one_mode(fam, n, p1, p2, x, normed=normed))
    return torch.stack(mats, dim=params.ndim - 2)


def weighting_fn(spec: SpectrumSpec, params, x, k: int) -> torch.Tensor:
    """Fraction of total *normalized* density in modes ≤ k at particle mass x
    (reference `weighting_fn`, src/Sources/Coalescence.jl:624-642)."""
    if not 0 <= k < spec.n_modes:
        raise ValueError("k out of range")
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    nd = _densities_all(spec, params, x, normed=True)
    axis = -2 if nd.ndim > 1 else 0
    denom = torch.sum(nd, dim=axis)
    num = torch.sum(nd[..., : k + 1, :] if nd.ndim > 1 else nd[: k + 1], dim=axis)
    return special.select(denom == 0.0, 0.0, num / denom)


def get_coal_ints_numerical(
    spec: SpectrumSpec,
    params,
    kernel_func,
    n_outer: int = 256,
    n_inner: int = 96,
) -> torch.Tensor:
    """Tendencies of all prognostic moments, shape [..., n_tot].

    Fixed-node counterpart of reference Coalescence.jl:470-489; `kernel_func`
    is a `kernels.KernelFunction` (or any callable K(x, y) on tensors).
    `n_outer`/`n_inner` are the TOTAL node budgets: with a kinked kernel
    they are divided among the panels split at each kink and at twice each
    kink.
    """
    n_modes = spec.n_modes
    dtype, dev = params.dtype, params.device
    n_mom = max(spec.nprogmoms)

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    kinks = tuple(float(t) for t in getattr(kernel_func, "x_kinks", ()))
    x_lo, x_hi = support_bounds(spec, params)

    # outer log grid: x = exp(u), Jacobian folded into the weights
    lo, hi = torch.log(x_lo)[..., None], torch.log(x_hi)[..., None]
    if kinks:
        outer_cuts = sorted({c for t in kinks for c in (t, 2.0 * t)})
        n_po = len(outer_cuts) + 1
        xu, wu = (const(v) for v in gauss_legendre(max(n_outer // n_po, 8)))
        edges = (
            [lo]
            + [torch.minimum(torch.maximum(torch.log(const(c)), lo), hi)
               for c in outer_cuts]
            + [hi]
        )
        Xp, Wp = [], []
        for a, b in zip(edges[:-1], edges[1:]):
            u = a + 0.5 * (b - a) * (xu + 1.0)
            Xp.append(torch.exp(u))
            Wp.append(0.5 * (b - a) * wu * torch.exp(u))
        X = torch.cat(Xp, dim=-1)  # [..., Gx]
        WX = torch.cat(Wp, dim=-1)
    else:
        xu, wu = (const(v) for v in gauss_legendre(n_outer))
        U = lo + 0.5 * (hi - lo) * (xu + 1.0)
        X = torch.exp(U)  # [..., Gx]
        WX = 0.5 * (hi - lo) * wu * X

    # inner scaled grid s ∈ (0, 1): y = s x. With kinks the inner integrand
    # breaks at s = t/x and 1 − t/x: per-x panel edges.
    if kinks:
        n_pi = 2 * len(kinks) + 1
        su, ws = gauss_legendre(max(n_inner // n_pi, 8))
        su = const(0.5 * (np.asarray(su) + 1.0))  # (0, 1)
        ws = const(0.5 * np.asarray(ws))
        cuts = torch.sort(
            torch.stack(
                [torch.clamp(c, 0.0, 1.0)
                 for t in kinks for c in (special.rdiv(t, X), 1.0 - special.rdiv(t, X))],
                dim=-1,
            ),
            dim=-1,
        ).values  # [..., Gx, 2·n_kinks]
        zeros = torch.zeros_like(X)[..., None]
        iedges = torch.cat([zeros, cuts, zeros + 1.0], dim=-1)
        Sp, Wsp = [], []
        for pidx in range(n_pi):
            a = iedges[..., pidx, None]
            b = iedges[..., pidx + 1, None]
            Sp.append(a + (b - a) * su)
            Wsp.append((b - a) * ws)
        S = torch.cat(Sp, dim=-1)  # [..., Gx, Gs]
        WS = torch.cat(Wsp, dim=-1)
    else:
        su, ws = gauss_legendre(n_inner)
        S = const(0.5 * (su + 1.0))  # (0, 1)
        WS = const(0.5 * ws)

    F = _densities_all(spec, params, X)  # [..., N, Gx]
    NF = _densities_all(spec, params, X, normed=True)
    denom = torch.sum(NF, dim=-2)
    cum = torch.cumsum(NF, dim=-2)
    wfrac = special.select(denom[..., None, :] == 0.0, 0.0, cum / denom[..., None, :])

    Xpow = torch.stack([X ** m for m in range(n_mom)], dim=-2)  # [..., n_mom, Gx]

    # ---- R: inner ∫ K(x,y) f_j(y) dy on the same log grid -----------------
    Kxy = kernel_func(X[..., :, None], X[..., None, :])  # [..., Gx, Gy]
    A = torch.einsum("...xy,...jy,...y->...jx", Kxy, F, WX)  # [..., N, Gx]
    R = torch.einsum("...x,...mx,...kx,...jx->...mjk", WX, Xpow, F, A)

    # ---- Q and S: triangular inner integrals y = s·x ----------------------
    XS = X[..., :, None] * S  # y nodes      [..., Gx, Gs]
    XR = X[..., :, None] * (1.0 - S)  # x − y  [..., Gx, Gs]
    Kq = kernel_func(XR, XS)
    D = _densities_all(spec, params, XR)  # [..., N, Gx, Gs]
    E = _densities_all(spec, params, XS)
    KW = 0.5 * Kq * WS  # half-kernel with the inner weights

    # cross-mode gain: G[j,k,x] symmetric under j<->k by construction
    Gjk = torch.einsum("...xs,...jxs,...kxs->...jkx", KW, D, E)
    Gjk = Gjk + Gjk.transpose(-3, -2)
    # Σ_x WX x^{m+1} G   (extra x = inner Jacobian)
    Q = torch.einsum("...x,...mx,...x,...jkx->...mjk", WX, Xpow, X, Gjk)

    # self-collision gain per mode
    Gkk = torch.einsum("...xs,...kxs,...kxs->...kx", KW, D, E)
    S1 = torch.einsum("...x,...mx,...x,...kx,...kx->...mk", WX, Xpow, X, wfrac, Gkk)
    Stot = torch.einsum("...x,...mx,...x,...kx->...mk", WX, Xpow, X, Gkk)
    S2 = Stot - S1

    # ---- gated assembly (reference :479-488 + zero-structure :503-622) ----
    out = []
    for k in range(n_modes):
        for m in range(spec.nprogmoms[k]):
            acc = -torch.sum(R[..., m, :, k], dim=-1)
            if k > 0:
                acc = acc + torch.sum(Q[..., m, :k, k], dim=-1)
            acc = acc + S1[..., m, k]
            if k > 0:
                acc = acc + S2[..., m, k - 1]
            out.append(acc)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# reference-shaped integrand probes (for structural tests; reference :644-708)
# ---------------------------------------------------------------------------


def _gl01(n, like):
    su, ws = gauss_legendre(n)
    return (torch.as_tensor(0.5 * (su + 1.0), dtype=like.dtype, device=like.device),
            torch.as_tensor(0.5 * ws, dtype=like.dtype, device=like.device))


def q_integrand_inner(spec, params, x, y, j, k, kernel_func):
    if j == k:
        raise AssertionError("q_integrand called on j==k, should call s instead")
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    y = torch.as_tensor(y, dtype=params.dtype, device=params.device)
    d = _densities_all(spec, params, torch.stack(torch.broadcast_tensors(x - y, y)))
    return 0.5 * kernel_func(x - y, y) * (d[j, 0] * d[k, 1] + d[k, 0] * d[j, 1])


def q_integrand_outer(spec, params, x, j, k, kernel_func, moment_order, n_inner=96):
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    s, w = _gl01(n_inner, x)
    vals = q_integrand_inner(spec, params, x, x * s, j, k, kernel_func)
    return x ** moment_order * x * torch.sum(w * vals)


def r_integrand_inner(spec, params, x, y, j, k, kernel_func):
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    y = torch.as_tensor(y, dtype=params.dtype, device=params.device)
    d = _densities_all(spec, params, torch.stack([x, y]))
    return kernel_func(x, y) * d[k, 0] * d[j, 1]


def r_integrand_outer(spec, params, x, j, k, kernel_func, moment_order, n_nodes=256):
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    x_lo, x_hi = support_bounds(spec, params)
    xu, wu = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
              for v in gauss_legendre(n_nodes))
    u = torch.log(x_lo) + 0.5 * (torch.log(x_hi) - torch.log(x_lo)) * (xu + 1.0)
    y = torch.exp(u)
    wy = 0.5 * (torch.log(x_hi) - torch.log(x_lo)) * wu * y
    d = _densities_all(spec, params, y)
    inner = torch.sum(wy * kernel_func(x, y) * d[j], dim=-1)
    dx = _densities_all(spec, params, x)
    return x ** moment_order * dx[k] * inner


def s_integrand_inner(spec, params, x, k, kernel_func, moment_order, n_inner=96):
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    s, w = _gl01(n_inner, x)
    y = x * s
    d1 = _densities_all(spec, params, x - y)
    d2 = _densities_all(spec, params, y)
    vals = 0.5 * kernel_func(x - y, y) * d1[k] * d2[k]
    return x ** moment_order * x * torch.sum(w * vals)


def s_integrand1(spec, params, x, k, kernel_func, moment_order):
    return weighting_fn(spec, params, x, k) * s_integrand_inner(
        spec, params, x, k, kernel_func, moment_order
    )


def s_integrand2(spec, params, x, k, kernel_func, moment_order):
    return (1.0 - weighting_fn(spec, params, x, k)) * s_integrand_inner(
        spec, params, x, k, kernel_func, moment_order
    )
