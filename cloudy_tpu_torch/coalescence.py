"""Collision–coalescence moment tendencies (analytical path).

Port of `cloudy_tpu.coalescence` (reference src/Sources/Coalescence.jl:45-455).
The whole Q/R/S assembly is folded at init (numpy, host side, identical to
the JAX package) into two static weight tensors, so the per-step work is one
batched bilinear form

    coal_ints[o] =  Σ_{jp,kq} WB[o, jp, kq] · Mf[jp] · Mf[kq]
                  + Σ_{i,p,q} WF[o, i, p, q] · F2[i, p, q]

with Mf the flattened diagnostic moment matrix and F2 the per-mode clamped
autoconversion matrices. This module is the torch reference (AoS) path; the
hand-written CUDA kernels in `ops.fused_coalescence` run the same physics on
the flat structure-of-arrays layout.

Coverage: gamma and exponential thresholded modes (the Simpson tier
`_msh_matrix_gamma` and the exact-F2 fast tier `_msh_matrix_gamma_exact`),
lognormal modes (the Φ grid `_msh_matrix_lognormal` and the recentred GL
window `_msh_matrix_lognormal_window`), the monodisperse closed form, under
FixedThreshold and MovingThreshold (per-column percentile thresholds from
`distributions.compute_thresholds`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import distributions as pdists
from cloudy_tpu_torch.kernels import CoalescenceTensor
from cloudy_tpu_torch.ops import special
from cloudy_tpu_torch.ops.simpson import simpson_even_fast_weights_dynamic

@dataclasses.dataclass(frozen=True)
class CoalescenceData:
    """Init-time precompute for the analytical path — the same fields as
    `cloudy_tpu.coalescence.CoalescenceData` (numpy members)."""

    spec: SpectrumSpec
    #: polynomial order + 1 of the kernel tensors
    P: int
    #: number of diagnostic moment columns per mode (= P + 2)
    M: int
    #: normalized per-pair kernel tensors, shape [N, N, P, P]
    kernels: np.ndarray
    #: FixedThreshold: normalized mass thresholds [N] (np.inf = no threshold)
    #: MovingThreshold: percentiles [N]
    thresholds: np.ndarray
    #: whether thresholds are runtime percentiles (reference MovingThreshold)
    moving: bool
    #: reference N_2d_ints (src/Sources/Coalescence.jl:70-76)
    n_2d_ints: Tuple[int, ...]
    #: reference N_mom_max
    n_mom_max: int
    #: bilinear assembly weights [n_out, N*M, N*M]
    wb: np.ndarray
    #: finite-2d-int assembly weights [n_out, N, M, M]
    wf: np.ndarray
    #: Simpson grid points per thresholded mode (static shape)
    n_points_max: int
    #: iterations for the series/CF incomplete-gamma evaluation
    gammainc_iters: int
    #: gamma/exponential F2 by the exact factorization (the fast tier)
    f2_exact: bool = False
    #: > 0: F2 incomplete gammas by the fixed Gauss–Legendre scheme
    gammainc_gl_nodes: int = 0
    #: > 0: lognormal F2 by the density-recentered GL window rule
    lognorm_gl_nodes: int = 0


def from_numpy(fields: dict) -> CoalescenceData:
    """Build the port's `CoalescenceData` from the fields of a
    `CoalescenceData` of either package (e.g. ``{f.name: getattr(d, f.name)
    for f in dataclasses.fields(d)}``, or `dataclasses.asdict`). ``spec`` may
    be a `SpectrumSpec` of either package, a dict with ``families``, or a
    sequence of families."""
    f = dict(fields)
    spec = f["spec"]
    families = spec["families"] if isinstance(spec, dict) else getattr(spec, "families", spec)
    f["spec"] = SpectrumSpec(tuple(Family(int(x)) for x in families))
    for name in ("kernels", "thresholds", "wb", "wf"):
        f[name] = np.array(f[name], dtype=np.float64)
    f["n_2d_ints"] = tuple(int(x) for x in f["n_2d_ints"])
    for name in ("P", "M", "n_mom_max", "n_points_max", "gammainc_iters",
                 "gammainc_gl_nodes", "lognorm_gl_nodes"):
        if name in f:
            f[name] = int(f[name])
    for name in ("moving", "f2_exact"):
        if name in f:
            f[name] = bool(f[name])
    return CoalescenceData(**f)


def _build_assembly_weights(spec: SpectrumSpec, kernels: np.ndarray, M: int):
    """Fold the reference's Q/R/S nested sums into dense weight tensors."""
    N = spec.n_modes
    P = kernels.shape[-1]
    n_out = spec.n_tot
    D = N * M
    wb = np.zeros((n_out, D, D))
    wf = np.zeros((n_out, N, M, M))

    def fl(j, p):
        return j * M + p

    for k in range(N):
        for m in range(spec.nprogmoms[k]):
            o = spec.offsets[k] + m
            # Q: gain into k from collisions of modes j < k with k
            for j in range(k):
                for a in range(P):
                    for b in range(P):
                        kc = kernels[j, k, a, b]
                        if kc == 0.0:
                            continue
                        for c in range(m + 1):
                            wb[o, fl(j, a + c), fl(k, b + m - c)] += kc * math.comb(m, c)
            # R: loss of k by collision with every mode j (incl. j = k)
            for j in range(N):
                for a in range(P):
                    for b in range(P):
                        wb[o, fl(j, a), fl(k, b + m)] -= kernels[j, k, a, b]
            # S_1k: self-collision gain staying in mode k
            for a in range(P):
                for b in range(P):
                    kc = kernels[k, k, a, b]
                    if kc == 0.0:
                        continue
                    for c in range(m + 1):
                        wf[o, k, a + c, b + m - c] += 0.5 * kc * math.comb(m, c)
            # S_2,k−1: promotion gain from mode k−1's self-collisions
            if k >= 1:
                for a in range(P):
                    for b in range(P):
                        kc = kernels[k - 1, k - 1, a, b]
                        if kc == 0.0:
                            continue
                        for c in range(m + 1):
                            wb[o, fl(k - 1, a + c), fl(k - 1, b + m - c)] += (
                                0.5 * kc * math.comb(m, c)
                            )
                            wf[o, k - 1, a + c, b + m - c] -= 0.5 * kc * math.comb(m, c)
    return wb, wf


def build_coalescence_data(
    spec: SpectrumSpec,
    kernel: Union[CoalescenceTensor, Sequence[Sequence[CoalescenceTensor]]],
    dist_thresholds: Sequence[float],
    norms: Tuple[float, float] = (1.0, 1.0),
    moving: bool = False,
    n_points_max: Optional[int] = None,
    gammainc_iters: Optional[int] = None,
    f2_exact: bool = False,
    gammainc_gl_nodes: Optional[int] = None,
    lognorm_gl_nodes: Optional[int] = None,
    fast_tier: bool = False,
) -> CoalescenceData:
    """Precompute everything static for `get_coal_ints`, exactly as
    `cloudy_tpu.coalescence.build_coalescence_data` does (same arrays,
    bit for bit). ``fast_tier=True`` is shorthand for ``f2_exact=True,
    gammainc_gl_nodes=12, gammainc_iters=12, lognorm_gl_nodes=16``;
    explicitly passed values win."""
    if fast_tier:
        f2_exact = True
        gammainc_gl_nodes = 12 if gammainc_gl_nodes is None else gammainc_gl_nodes
        lognorm_gl_nodes = 16 if lognorm_gl_nodes is None else lognorm_gl_nodes
        gammainc_iters = 12 if gammainc_iters is None else gammainc_iters
    else:
        gammainc_gl_nodes = 0 if gammainc_gl_nodes is None else gammainc_gl_nodes
        lognorm_gl_nodes = 0 if lognorm_gl_nodes is None else lognorm_gl_nodes
        gammainc_iters = 128 if gammainc_iters is None else gammainc_iters
    N = spec.n_modes
    if isinstance(kernel, CoalescenceTensor):
        kmat = [[kernel for _ in range(N)] for _ in range(N)]
    else:
        kmat = [list(row) for row in kernel]
    P = kmat[0][0].array.shape[0]
    kernels = np.stack(
        [
            np.stack([kmat[j][k].normalized(norms).array for k in range(N)])
            for j in range(N)
        ]
    )  # [j, k, P, P]

    thresholds = np.asarray(list(dist_thresholds), dtype=np.float64)
    if len(thresholds) != N:
        raise ValueError("need one threshold per mode")
    if not moving:
        thresholds = thresholds / norms[1]

    M = P + 2
    nprog = spec.nprogmoms
    n_mom_max = max(nprog) + (P - 1)
    n_2d = tuple(
        (P - 1) + (max(nprog[i], nprog[i + 1]) if i < N - 1 else nprog[i])
        for i in range(N)
    )
    wb, wf = _build_assembly_weights(spec, kernels, M)

    if n_points_max is None:
        finite = thresholds[np.isfinite(thresholds)]
        if moving or finite.size == 0:
            n_points_max = 128
        else:
            tmax = float(np.max(finite))
            x_lo = min(1e-5, 1e-5 * tmax)
            n_points_max = int(np.floor(15 * np.log10(tmax / x_lo))) + 1

    return CoalescenceData(
        spec=spec,
        P=P,
        M=M,
        kernels=kernels,
        thresholds=thresholds,
        moving=moving,
        n_2d_ints=n_2d,
        n_mom_max=n_mom_max,
        wb=wb,
        wf=wf,
        n_points_max=n_points_max,
        gammainc_iters=gammainc_iters,
        f2_exact=f2_exact,
        gammainc_gl_nodes=gammainc_gl_nodes,
        lognorm_gl_nodes=lognorm_gl_nodes,
    )


# --------------------------------------------------------------------------
# finite 2-D integrals (the autoconversion partial integrals)
# --------------------------------------------------------------------------


def _gammainc_top(a, x, iters: int, gl_nodes: int, log_x=None, gln=None):
    """Top-order incomplete gamma of the F2 downward recurrences: GL scheme
    when `gl_nodes` > 0, else the series/CF pair at `iters` iterations."""
    if gl_nodes:
        return special.gammainc_gl(a, x, n_nodes=gl_nodes, gln=gln)
    return special.gammainc_impl(a, x, n_iters=iters, log_x=log_x)


def _msh_matrix_gamma(n, theta, k, thr, M: int, n_points_max: int, iters: int,
                      gl_nodes: int = 0):
    """Simpson/incomplete-gamma evaluation of the M×M matrix of
    ∫∫ x^p x'^q f f' over the triangle x + x' < thr for one gamma-family
    mode (reference ParticleDistributions.jl:567-612), with the
    forward-stable downward recurrence P(a, x) = P(a+1, x) + x^a e^{−x}/Γ(a+1)
    from the top order. Returns [..., M, M]."""
    dtype = theta.dtype
    x, dx, n_bins = pdists.threshold_log_grid(thr, n_points_max, dtype)
    w = simpson_even_fast_weights_dynamic(n_points_max, n_bins, dtype)
    j = torch.arange(1, n_points_max + 1, device=theta.device)
    mask = (j <= n_bins[..., None]).to(dtype)

    th = theta[..., None]
    rem = torch.clamp(thr[..., None] - x, min=0.0) / th
    logx = torch.log(x)

    a0 = k[..., None]
    log_rem = torch.log(torch.clamp(rem, min=torch.finfo(dtype).tiny))
    delta = special.exp(a0 * log_rem - rem - special.lgamma(a0 + 1.0))
    delta = torch.where(rem > 0.0, delta, torch.zeros_like(delta))
    deltas = [delta]
    for q in range(1, M - 1):
        deltas.append(deltas[-1] * rem / (a0 + q))
    gi = _gammainc_top(a0 + (M - 1.0), rem, iters, gl_nodes, log_x=log_rem)
    gis = [gi]
    for q in range(M - 2, -1, -1):
        gi = torch.clamp(gi + deltas[q], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()
    GI = torch.stack(gis, dim=-2)  # [..., M(q), G]

    base = special.exp(k[..., None] * logx - x / th) * w * mask
    ys = [base]
    for _ in range(1, M):
        ys.append(ys[-1] * x)
    Y = torch.stack(ys, dim=-2)  # [..., M(p), G]

    raw = torch.einsum("...pg,...qg->...pq", Y, GI) * dx[..., None, None]

    # prefactor per q: n² θ^{q−k} Γ(q+k) / Γ(k)²
    q = torch.arange(M, dtype=dtype, device=theta.device)
    logth = torch.log(th)
    lgk = special.lgamma(k)[..., None]
    pref = (n[..., None] ** 2) * special.exp(
        (q - k[..., None]) * logth
        + special.lgamma(q + k[..., None])
        - 2.0 * lgk
    )
    return raw * pref[..., None, :]


def _msh_matrix_gamma_exact(n, theta, k, thr, M: int, iters: int,
                            gl_nodes: int = 0):
    """Exact closed form of the gamma/exponential autoconversion matrix,
    F2(p, q) = M_p · M_q · P(p + q + 2k, T/θ): one incomplete gamma at the
    top order 2k + 2M − 2 plus the downward recurrence (the fast tier's F2).
    Returns [..., M, M]."""
    dtype = theta.dtype
    tiny = torch.finfo(dtype).tiny
    x = torch.clamp(thr / theta, max=1e6)
    log_x = torch.log(torch.clamp(x, min=tiny))
    a0 = 2.0 * k
    lgam = special.lgamma_stirling if gl_nodes else special.lgamma
    lga01 = lgam(a0 + 1.0)
    d = special.exp(a0 * log_x - x - lga01)
    d = torch.where(x > 0.0, d, torch.zeros_like(d))
    ds = [d]
    prod = None
    for j in range(1, 2 * M - 2):
        ds.append(ds[-1] * x / (a0 + j))
        prod = (a0 + j) if prod is None else prod * (a0 + j)
    gi = _gammainc_top(
        a0 + (2.0 * M - 2.0), x, iters, gl_nodes, log_x=log_x,
        gln=None if prod is None else lga01 + torch.log(prod),
    )
    gis = [gi]
    for j in range(2 * M - 3, -1, -1):
        gi = torch.clamp(gi + ds[j], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()  # gis[s] = P(2k + s, T/θ)

    ms = [n]
    for p in range(1, M):
        ms.append(ms[-1] * theta * (k + p - 1.0))
    mp = torch.stack(ms, dim=-1)  # [..., M]
    gpq = torch.stack(
        [torch.stack([gis[p + q] for q in range(M)], dim=-1) for p in range(M)],
        dim=-2,
    )  # [..., M, M]
    return mp[..., :, None] * mp[..., None, :] * gpq


def _msh_matrix_lognormal(n, mu, sig, thr, M: int, n_points_max: int,
                          erf_iters: int = 128, erf_fast: bool = False):
    """Lognormal autoconversion matrix on the reference log grid: the inner
    integral is the exact partial moment n exp(qμ + q²σ²/2)
    Φ((ln(T−x) − μ − qσ²)/σ), Φ through `special.erf_impl` (or the rational
    `special.erf_approx` with `erf_fast`). Returns [..., M, M]."""
    dtype = mu.dtype
    dev = mu.device
    x, dx, n_bins = pdists.threshold_log_grid(thr, n_points_max, dtype)
    w = simpson_even_fast_weights_dynamic(n_points_max, n_bins, dtype)
    j = torch.arange(1, n_points_max + 1, device=dev)
    mask = (j <= n_bins[..., None]).to(dtype)

    mu_, sig_ = mu[..., None], sig[..., None]
    tiny = torch.finfo(dtype).tiny
    logx = torch.log(torch.clamp(x, min=tiny))
    dlx = logx - mu_
    fx = special.exp(-(dlx * dlx) / (2.0 * (sig_ * sig_))) / (
        x * sig_ * float(np.sqrt(2.0 * np.pi))
    )
    rem = torch.clamp(thr[..., None] - x, min=0.0)
    logrem = torch.log(torch.clamp(rem, min=tiny))

    q = torch.arange(M, dtype=dtype, device=dev)[:, None]  # [M, 1]
    s_ = sig_[..., None, :]
    z = (logrem[..., None, :] - mu_[..., None, :] - q * (s_ * s_)) / (
        s_ * float(np.sqrt(2.0))
    )
    erf_z = (special.erf_approx(z) if erf_fast
             else special.erf_impl(z, n_iters=erf_iters))
    pm = special.exp(
        q * mu_[..., None, :] + 0.5 * (q * q) * (s_ * s_)
    ) * 0.5 * (1.0 + erf_z)
    pm = torch.where(rem[..., None, :] > 0.0, pm, torch.zeros_like(pm))

    ys = [x * fx * w * mask]
    for _ in range(1, M):
        ys.append(ys[-1] * x)
    Y = torch.stack(ys, dim=-2)  # [..., M(p), G]
    raw = torch.einsum("...pg,...qg->...pq", Y, pm) * dx[..., None, None]
    return raw * (n * n)[..., None, None]


#: half-width of the lognormal window rule in σ units
LOGNORM_WINDOW_SIGMA = 6.0


def _msh_matrix_lognormal_window(n, mu, sig, thr, M: int, gl_nodes: int):
    """Density-recentred Gauss–Legendre evaluation of the lognormal
    autoconversion matrix (the fast tier): in u = log x the order-p outer
    integrand is a Gaussian of known centre and width times a bounded
    monotone factor, integrated by GL-`gl_nodes` on the window
    [μ − Wσ, min(log T, μ + Mσ² + Wσ)], W = 6. Returns [..., M, M]."""
    dtype = mu.dtype
    dev = mu.device
    tiny = torch.finfo(dtype).tiny
    vg_np, wg_np = np.polynomial.legendre.leggauss(gl_nodes)
    vg = torch.as_tensor(vg_np, dtype=dtype, device=dev)
    wg = torch.as_tensor(wg_np, dtype=dtype, device=dev)
    W = LOGNORM_WINDOW_SIGMA

    s2 = sig * sig
    lo = mu - W * sig
    hi = torch.minimum(torch.log(torch.clamp(thr, min=tiny)), mu + M * s2 + W * sig)
    half = torch.clamp(hi - lo, min=0.0) * 0.5
    center = lo + half

    u = center[..., None] + half[..., None] * vg  # [..., G]
    x = special.exp(u)
    sig_, mu_ = sig[..., None], mu[..., None]
    du = u - mu_
    g0 = (
        half[..., None]
        * wg
        * special.exp(-(du * du) / (2.0 * (sig_ * sig_)))
        / (sig_ * float(np.sqrt(2.0 * np.pi)))
    )
    rem = torch.clamp(thr[..., None] - x, min=0.0)
    logrem = torch.log(torch.clamp(rem, min=tiny))
    q = torch.arange(M, dtype=dtype, device=dev)[:, None]  # [M, 1]
    s_ = sig_[..., None, :]
    z = (logrem[..., None, :] - mu_[..., None, :] - q * (s_ * s_)) / (
        s_ * float(np.sqrt(2.0))
    )
    pm = special.exp(
        q * mu_[..., None, :] + 0.5 * (q * q) * (s_ * s_)
    ) * 0.5 * (1.0 + special.erf_approx(z))
    pm = torch.where(rem[..., None, :] > 0.0, pm, torch.zeros_like(pm))

    ys = [g0]
    for _ in range(1, M):
        ys.append(ys[-1] * x)
    Y = torch.stack(ys, dim=-2)  # [..., M(p), G]
    raw = torch.einsum("...pg,...qg->...pq", Y, pm)
    return raw * (n * n)[..., None, None]


def get_finite_2d_integrals(data: CoalescenceData, params, mom_matrix,
                            thresholds=None) -> torch.Tensor:
    """Per-mode clamped autoconversion matrices, shape [..., N, M, M]
    (reference `get_finite_2d_integrals`, src/Sources/Coalescence.jl:200-244):
    entry (p, q) of mode i is 0 if M_p·M_q < eps or p,q ≥ N_2d_ints[i];
    M_p·M_q for the last mode or thr = ∞; min(M_p·M_q, msh(i, p', q'))
    otherwise, (p', q') = sorted (p, q). `thresholds` ([..., N]) overrides
    the static ones: the MovingThreshold path."""
    spec = data.spec
    N, M = spec.n_modes, data.M
    dtype = params.dtype
    dev = params.device
    eps = torch.finfo(dtype).eps

    mm = mom_matrix[..., :, :, None] * mom_matrix[..., :, None, :]  # [..., N, M, M]

    p_idx = np.arange(M)[:, None]
    q_idx = np.arange(M)[None, :]
    upper_sel = torch.as_tensor(p_idx <= q_idx, device=dev)

    out = []
    for i in range(N):
        mmi = mm[..., i, :, :]
        in_range = torch.as_tensor(
            (p_idx < data.n_2d_ints[i]) & (q_idx < data.n_2d_ints[i]), device=dev
        )
        static_no_thr = (not data.moving) and not np.isfinite(data.thresholds[i])
        if i == N - 1 or static_no_thr:
            # last mode, or no threshold: the M_p·M_q fallback
            f2 = mmi
        else:
            if thresholds is not None:
                thr = thresholds[..., i]
            else:
                thr = torch.full(mmi.shape[:-2], float(data.thresholds[i]),
                                 dtype=dtype, device=dev)
            # finite positive threshold for the integrals, masked after
            thr_finite = torch.isfinite(thr) & (thr > 0.0)
            thr = special.select(thr_finite, thr, 1.0)
            fam = spec.families[i]
            n, p1, p2 = (params[..., i, j] for j in range(3))
            if fam in (Family.EXPONENTIAL, Family.GAMMA):
                kk = p2 if fam == Family.GAMMA else torch.ones_like(n)
                if data.f2_exact:
                    msh = _msh_matrix_gamma_exact(
                        n, p1, kk, thr, M, data.gammainc_iters,
                        gl_nodes=data.gammainc_gl_nodes,
                    )
                else:
                    msh = _msh_matrix_gamma(
                        n, p1, kk, thr, M, data.n_points_max,
                        data.gammainc_iters, gl_nodes=data.gammainc_gl_nodes,
                    )
            elif fam == Family.MONODISPERSE:
                pq = torch.as_tensor(p_idx + q_idx, dtype=dtype, device=dev)
                msh = torch.where(
                    p1[..., None, None] < thr[..., None, None] / 2.0,
                    (n[..., None, None] ** 2) * p1[..., None, None] ** pq,
                    torch.zeros((), dtype=dtype, device=dev),
                )
            elif data.lognorm_gl_nodes:  # LOGNORMAL, the fast tier
                msh = _msh_matrix_lognormal_window(
                    n, p1, p2, thr, M, data.lognorm_gl_nodes)
            else:  # LOGNORMAL on the reference grid
                msh = _msh_matrix_lognormal(
                    n, p1, p2, thr, M, data.n_points_max,
                    erf_iters=data.gammainc_iters,
                    erf_fast=data.gammainc_gl_nodes > 0,
                )
            upper = torch.where(upper_sel, msh, msh.transpose(-1, -2))
            f2 = torch.minimum(mmi, upper)
            f2 = torch.where(thr_finite[..., None, None], f2, mmi)
        f2 = torch.where((mmi < eps) | ~in_range, torch.zeros_like(f2), f2)
        out.append(f2)
    return torch.stack(out, dim=-3)


# --------------------------------------------------------------------------
# the per-step tendency
# --------------------------------------------------------------------------


def get_coal_ints(data: CoalescenceData, params, wb=None, wf=None) -> torch.Tensor:
    """Coalescence tendencies of all prognostic moments, shape [..., n_tot],
    from the dense parameter tensor ``[..., n_modes, 3]`` (reference
    `get_coal_ints(::AnalyticalCoalStyle, …)`,
    src/Sources/Coalescence.jl:115-150), with the MovingThreshold variant
    (:152-185) when ``data.moving``: percentile thresholds per column.

    `wb`/`wf` optionally override the static assembly weights with tensors
    of the same shapes, which may carry autograd: the hook
    `make_kernel_diff_coal_fn` differentiates through."""
    spec = data.spec
    dtype = params.dtype
    mom = pdists.moments_matrix(spec, params, data.M)  # [..., N, M]
    thresholds = None
    if data.moving:
        thresholds = pdists.compute_thresholds(
            spec, params, tuple(data.thresholds),
            fast_gl_nodes=data.gammainc_gl_nodes,
        )
    f2 = get_finite_2d_integrals(data, params, mom, thresholds)

    batch = mom.shape[:-2]
    D = spec.n_modes * data.M
    mf = mom.reshape(batch + (D,))
    outer = mf[..., :, None] * mf[..., None, :]
    wb = torch.as_tensor(data.wb if wb is None else wb, dtype=dtype, device=params.device)
    wf = torch.as_tensor(data.wf if wf is None else wf, dtype=dtype, device=params.device)
    wb = wb.reshape(spec.n_tot, D * D).T
    wf = wf.reshape(spec.n_tot, spec.n_modes * data.M * data.M).T
    out = outer.reshape(batch + (D * D,)) @ wb
    out = out + f2.reshape(batch + (-1,)) @ wf
    return out


def make_kernel_diff_coal_fn(data: CoalescenceData):
    """Coalescence tendencies differentiable in the kernel coefficients (the
    calibration surface; `cloudy_tpu.coalescence.make_kernel_diff_coal_fn`).

    `_build_assembly_weights` is linear in the normalized per-pair kernel
    coefficients ``kernels [N, N, P, P]``, so the folded weights are
    re-contracted from a one-hot basis built here once (numpy):

        wb(kernels) = Σ_{jkab} kernels[j,k,a,b] · WB_basis[j,k,a,b]

    Returns ``fn(params, kernels) -> [..., n_tot]``; `kernels` is a tensor in
    NORMALIZED units (what `CoalescenceData.kernels` stores) and autograd
    reaches every coefficient."""
    spec = data.spec
    N, P, M = spec.n_modes, data.P, data.M
    wb_basis = np.zeros((N, N, P, P) + data.wb.shape)
    wf_basis = np.zeros((N, N, P, P) + data.wf.shape)
    for idx in np.ndindex(N, N, P, P):
        onehot = np.zeros((N, N, P, P))
        onehot[idx] = 1.0
        wb_basis[idx], wf_basis[idx] = _build_assembly_weights(spec, onehot, M)
    wb_basis = wb_basis.reshape(N * N * P * P, -1)
    wf_basis = wf_basis.reshape(N * N * P * P, -1)

    def fn(params, kernels):
        kflat = torch.as_tensor(kernels).reshape(-1)
        basis = dict(dtype=kflat.dtype, device=kflat.device)
        wb = (kflat @ torch.as_tensor(wb_basis, **basis)).reshape(data.wb.shape)
        wf = (kflat @ torch.as_tensor(wf_basis, **basis)).reshape(data.wf.shape)
        return get_coal_ints(data, params, wb=wb, wf=wf)

    return fn


def make_coal_rhs(data: CoalescenceData, norms: Tuple[float, float] = (1.0, 1.0)):
    """RHS over *physical* flat moments ``[..., n_tot]``: normalize → invert
    the closure → tendencies → denormalize (reference box driver
    `rhs_coal!`, test/examples/utils/box_model_helpers.jl:29-53)."""
    from cloudy_tpu_torch.spec import get_moments_normalizing_factors

    mom_norms = get_moments_normalizing_factors(data.spec.nprogmoms, norms)

    def rhs(mom_flat):
        mom_flat = torch.as_tensor(mom_flat)
        norm = torch.as_tensor(mom_norms, dtype=mom_flat.dtype, device=mom_flat.device)
        params = pdists.params_from_moments(data.spec, mom_flat / norm)
        return get_coal_ints(data, params) * norm

    return rhs
