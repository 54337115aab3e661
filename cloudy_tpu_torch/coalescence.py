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

Coverage of this slice: gamma and exponential thresholded modes (the Simpson
tier `_msh_matrix_gamma` and the exact-F2 fast tier
`_msh_matrix_gamma_exact`), monodisperse closed form, FixedThreshold only.
Lognormal modes (ROADMAP A.7) and MovingThreshold (ROADMAP A.7) raise
`NotImplementedError`.
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

MOVING_TODO = "MovingThreshold is not ported yet (ROADMAP A.7)"


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


def get_finite_2d_integrals(data: CoalescenceData, params, mom_matrix) -> torch.Tensor:
    """Per-mode clamped autoconversion matrices, shape [..., N, M, M]
    (reference `get_finite_2d_integrals`, src/Sources/Coalescence.jl:200-244):
    entry (p, q) of mode i is 0 if M_p·M_q < eps or p,q ≥ N_2d_ints[i];
    M_p·M_q for the last mode or thr = ∞; min(M_p·M_q, msh(i, p', q'))
    otherwise, (p', q') = sorted (p, q)."""
    if data.moving:
        raise NotImplementedError(MOVING_TODO)
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
        t_i = float(data.thresholds[i])
        if i == N - 1 or not (np.isfinite(t_i) and t_i > 0.0):
            # last mode, or no (usable) threshold: the M_p·M_q fallback
            f2 = mmi
        else:
            thr = torch.full(mmi.shape[:-2], t_i, dtype=dtype, device=dev)
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
            else:
                raise NotImplementedError(pdists.LOGNORMAL_TODO)
            upper = torch.where(upper_sel, msh, msh.transpose(-1, -2))
            f2 = torch.minimum(mmi, upper)
        f2 = torch.where((mmi < eps) | ~in_range, torch.zeros_like(f2), f2)
        out.append(f2)
    return torch.stack(out, dim=-3)


# --------------------------------------------------------------------------
# the per-step tendency
# --------------------------------------------------------------------------


def get_coal_ints(data: CoalescenceData, params) -> torch.Tensor:
    """Coalescence tendencies of all prognostic moments, shape [..., n_tot],
    from the dense parameter tensor ``[..., n_modes, 3]`` (reference
    `get_coal_ints(::AnalyticalCoalStyle, …)`,
    src/Sources/Coalescence.jl:115-150)."""
    spec = data.spec
    dtype = params.dtype
    mom = pdists.moments_matrix(spec, params, data.M)  # [..., N, M]
    f2 = get_finite_2d_integrals(data, params, mom)

    batch = mom.shape[:-2]
    D = spec.n_modes * data.M
    mf = mom.reshape(batch + (D,))
    outer = mf[..., :, None] * mf[..., None, :]
    wb = torch.as_tensor(data.wb, dtype=dtype, device=params.device)
    wf = torch.as_tensor(data.wf, dtype=dtype, device=params.device)
    wb = wb.reshape(spec.n_tot, D * D).T
    wf = wf.reshape(spec.n_tot, spec.n_modes * data.M * data.M).T
    out = outer.reshape(batch + (D * D,)) @ wb
    out = out + f2.reshape(batch + (-1,)) @ wf
    return out
