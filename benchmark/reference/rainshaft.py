"""Plain reference of the pod rainshaft: one SSPRK33 step of an ensemble of
1-D columns, coalescence and sedimentation, in plain PyTorch.

A frozen copy of the arithmetic of the port's plain twin of the whole-step
kernel (the fast tier: two gamma modes, exact F2 with the Gauss–Legendre
incomplete gamma, the Stirling ratio of the sedimentation flux), written
against the configuration file alone. Everything the port derives at set-up
is derived here again from the file's physical parameters: the polynomial
fit of the kernel, the Q/R/S assembly weights, the normalisation, the
thresholds, the quadrature nodes and the velocity law. It imports nothing
of the program. The same expressions as the twin, in the same order, so
that the operation count of `benchmark/roofline` is the work the kernel
must do.

It runs in any floating type: float64 is the reference, a lower type the
control. The thresholds of the algorithm (a moment counts as present above
the type's epsilon, a logarithm's argument is clamped at the type's least
normal number) are a type's, given to `build_tables`: the reference runs
float64 arithmetic with the thresholds of the type the configuration
states, which are part of what the configuration computes (below them the
program and a float64 reference would follow different rules); the
control, the program as it would be in a lower type, runs that type's
arithmetic with that type's thresholds. Layout: the flat structure-of-arrays ``[n_tot, B]``, lanes = one
level of one column, z fastest within a column.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

_HALF_LOG_2PI = 0.9189385332046727


# --------------------------------------------------------------------------
# set-up: the kernel tensor, the assembly weights, the tables
# --------------------------------------------------------------------------


def polyfit_golovin(rate: float, order: int, limit: float, norms, npoints: int = 10):
    """Least-squares fit of the Golovin kernel K = rate·(x + y) by a
    symmetric polynomial Σ c[a,b] x^a y^b on the triangular sample grid of
    Cloudy.jl's KernelTensors.jl, in physical units."""
    scaled = rate * norms[0] * norms[1]

    def kfn(x, y):
        return scaled * (x + y)

    limit_n = limit / norms[1]
    delta = limit_n / (npoints - 1)
    idx = np.arange(npoints * npoints)
    x_ = (idx % npoints) * delta
    y_ = np.floor(idx / npoints) * delta
    keep = (y_ >= 0.0) & (y_ - x_ >= 0)
    xk, yk = x_[keep], y_[keep]
    c00 = max(np.finfo(np.float64).eps, float(np.asarray(kfn(0.0, 0.0))))
    P = order + 1
    X = xk[:, None]
    Y = yk[None, :]
    target = (np.asarray(kfn(X, Y)) - c00).ravel()
    pairs = [(a, b) for b in range(P) for a in range(b + 1) if (a, b) != (0, 0)]
    design = np.stack(
        [(X**a * Y**b + (X**b * Y**a if a != b else 0.0)).ravel() for (a, b) in pairs],
        axis=1)
    coef, *_ = np.linalg.lstsq(design, target, rcond=None)
    c = np.zeros((P, P))
    c[0, 0] = c00
    for (a, b), v in zip(pairs, coef):
        c[a, b] = v
        c[b, a] = v
    denorm = norms[0] * norms[1] ** (np.add.outer(np.arange(P), np.arange(P)).astype(np.float64))
    return c / denorm


def normalized_tensor(c: np.ndarray, norms) -> np.ndarray:
    P = c.shape[0]
    scale = norms[0] * norms[1] ** (np.add.outer(np.arange(P), np.arange(P)).astype(np.float64))
    return np.asarray(c, dtype=np.float64) * scale


def assembly_weights(nprog: Sequence[int], kernels: np.ndarray, M: int):
    """The Q/R/S sums of Coalescence.jl folded into a bilinear weight over
    the diagnostic moments (wb) and one over the F2 integrals (wf)."""
    N = len(nprog)
    P = kernels.shape[-1]
    offsets = np.concatenate([[0], np.cumsum(nprog)[:-1]]).astype(int)
    n_out = int(sum(nprog))
    D = N * M
    wb = np.zeros((n_out, D, D))
    wf = np.zeros((n_out, N, M, M))

    def fl(j, p):
        return j * M + p

    for k in range(N):
        for m in range(nprog[k]):
            o = offsets[k] + m
            for j in range(k):  # Q: gain into k from j < k
                for a in range(P):
                    for b in range(P):
                        kc = kernels[j, k, a, b]
                        if kc == 0.0:
                            continue
                        for c in range(m + 1):
                            wb[o, fl(j, a + c), fl(k, b + m - c)] += kc * math.comb(m, c)
            for j in range(N):  # R: loss of k to every mode
                for a in range(P):
                    for b in range(P):
                        wb[o, fl(j, a), fl(k, b + m)] -= kernels[j, k, a, b]
            for a in range(P):  # S_1k: self-collisions that stay in k
                for b in range(P):
                    kc = kernels[k, k, a, b]
                    if kc == 0.0:
                        continue
                    for c in range(m + 1):
                        wf[o, k, a + c, b + m - c] += 0.5 * kc * math.comb(m, c)
            if k >= 1:  # S_2,k-1: promotion from k-1's self-collisions
                for a in range(P):
                    for b in range(P):
                        kc = kernels[k - 1, k - 1, a, b]
                        if kc == 0.0:
                            continue
                        for c in range(m + 1):
                            wb[o, fl(k - 1, a + c), fl(k - 1, b + m - c)] += 0.5 * kc * math.comb(m, c)
                            wf[o, k - 1, a + c, b + m - c] -= 0.5 * kc * math.comb(m, c)
    return wb, wf


@dataclasses.dataclass(frozen=True)
class Tables:
    """Everything one step needs besides the state, in host double."""

    nprog: Tuple[int, ...]
    offsets: Tuple[int, ...]
    thr_flag: Tuple[int, ...]
    thr: Tuple[float, ...]
    M: int
    wb_nz: Tuple[Tuple[int, int, int, float], ...]
    wf_nz: Tuple[Tuple[int, int, int, int, float], ...]
    gl_nodes: int
    mom_norms: Tuple[float, ...]
    vel_n: Tuple[Tuple[float, float], ...]
    nz: int
    inv_dz: float
    dt: float
    #: the stated type's epsilon and least normal number
    eps: float
    tiny: float

    @property
    def n_tot(self) -> int:
        return sum(self.nprog)


def build_tables(physics: dict, dtype: str) -> Tables:
    """The tables of one configuration from its ``physics`` block: two or
    more gamma modes, a Golovin kernel fitted by a polynomial, fixed
    thresholds, the exact F2 with the Gauss–Legendre incomplete gamma;
    `dtype` ("float32", "float64") is the type the configuration states."""
    fi = torch.finfo(getattr(torch, dtype))
    modes = physics["modes"]
    if any(m != "gamma" for m in modes):
        raise ValueError(f"this reference covers gamma modes only, not {modes}")
    kern = physics["kernel"]
    if kern["kind"] != "golovin":
        raise ValueError(f"this reference covers the Golovin kernel only, not {kern['kind']}")
    norms = tuple(float(v) for v in physics["norms"])
    N = len(modes)
    nprog = tuple(3 for _ in modes)
    offsets = tuple(3 * i for i in range(N))
    c = polyfit_golovin(float(kern["rate"]), int(kern["fit_order"]), float(kern["fit_limit"]),
                        tuple(float(v) for v in kern["fit_norms"]))
    kn = normalized_tensor(c, norms)
    P = kn.shape[0]
    kernels = np.stack([np.stack([kn for _ in range(N)]) for _ in range(N)])
    M = P + 2
    wb, wf = assembly_weights(nprog, kernels, M)
    thresholds = np.asarray([np.inf if t is None else float(t) for t in physics["thresholds"]],
                            dtype=np.float64) / norms[1]
    n_2d = tuple((P - 1) + (max(nprog[i], nprog[i + 1]) if i < N - 1 else nprog[i])
                 for i in range(N))
    wb_nz = tuple((o, i, j, float(wb[o, i, j])) for o in range(wb.shape[0])
                  for i in range(wb.shape[1]) for j in range(wb.shape[2]) if wb[o, i, j] != 0.0)
    wf_nz = []
    for o in range(wf.shape[0]):
        for k in range(N):
            for p in range(M):
                for q in range(M):
                    v = wf[o, k, p, q]
                    if v == 0.0 or p >= n_2d[k] or q >= n_2d[k]:
                        continue
                    wf_nz.append((o, k, min(p, q), max(p, q), float(v)))
    thr_flag = tuple(int(i < N - 1 and np.isfinite(thresholds[i])) for i in range(N))
    thr = tuple(float(thresholds[i]) if thr_flag[i] else 0.0 for i in range(N))
    mom_norms = tuple(float(v) for v in np.concatenate(
        [norms[0] * norms[1] ** np.arange(n, dtype=np.float64) for n in nprog]))
    vel_n = tuple((float(cv) * norms[1] ** float(e), float(e)) for (cv, e) in physics["velocity"])
    nz = int(physics["levels"])
    dz = float(physics["zmax"]) / nz
    return Tables(nprog=nprog, offsets=offsets, thr_flag=thr_flag, thr=thr, M=M,
                  wb_nz=wb_nz, wf_nz=tuple(wf_nz), gl_nodes=int(physics["gl_nodes"]),
                  mom_norms=mom_norms, vel_n=vel_n, nz=nz, inv_dz=1.0 / float(dz),
                  dt=float(physics["dt"]), eps=float(fi.eps), tiny=float(fi.tiny))


def initial_column(physics: dict) -> np.ndarray:
    """The top-hat column of rainshaft_helpers.jl, ``[n_tot, nz]``: mode 1
    at the configured amplitudes in z ∈ [0.5, 0.75)·zmax (cell centres,
    the bounds shifted by half a cell), every other mode empty."""
    nz = int(physics["levels"])
    dz = float(physics["zmax"]) / nz
    z = (np.arange(nz) + 0.5) * dz
    zmax = z.max()
    at = ((z >= 0.5 * zmax - dz / 2) & (z < 0.75 * zmax - dz / 2)).astype(np.float64)
    amp = np.asarray(physics["initial_amplitudes"], dtype=np.float64)
    col = np.zeros((3 * len(physics["modes"]), nz))
    col[:3] = amp[:, None] * at[None, :]
    return col


# --------------------------------------------------------------------------
# special functions
# --------------------------------------------------------------------------


#: 0-d constants by (value, type, device): made once, so that a step makes
#: no host-to-device copy and can be captured in a CUDA graph
_CONSTS: dict = {}


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    key = (float(c), like.dtype, like.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    return _CONSTS[key]


def _sel(cond, a, b):
    ref = a if isinstance(a, torch.Tensor) else b
    return torch.where(cond, _const(a, ref) if not isinstance(a, torch.Tensor) else a,
                       _const(b, ref) if not isinstance(b, torch.Tensor) else b)


def lgamma_stirling(x, tiny: float):
    """log Γ(x), x > 0: Stirling's series at z = x + 4, the shift removed."""
    z = x + 4.0
    log_z = torch.log(z)
    iz = 1.0 / z
    iz2 = iz * iz
    iz3 = iz * iz2
    tail = (iz * (1.0 / 12.0) - iz3 * (1.0 / 360.0) + iz3 * iz2 * (1.0 / 1260.0)
            - iz3 * iz2 * iz2 * (1.0 / 1680.0))
    lg_z = _HALF_LOG_2PI + (z - 0.5) * log_z - z + tail
    shift = torch.clamp(x * (x + 1.0) * (x + 2.0) * (x + 3.0), min=tiny)
    return lg_z - torch.log(shift)


def gamma_ratio(k, e: float):
    """Γ(k+e)/Γ(k), k > 0, e ∈ [0, 1]: the Stirling difference at k + 3."""
    z = k + 3.0
    ze = z + e
    log_z = torch.log(z)
    log_ze = torch.log(ze)
    iz, ize = 1.0 / z, 1.0 / ze
    iz2, ize2 = iz * iz, ize * ize
    tail = (ize - iz) * (1.0 / 12.0) \
        - (ize * ize2 - iz * iz2) * (1.0 / 360.0) \
        + (ize * ize2 * ize2 - iz * iz2 * iz2) * (1.0 / 1260.0)
    d = (ze - 0.5) * log_ze - (z - 0.5) * log_z - e + tail
    front = (k * (k + 1.0) * (k + 2.0)) / ((k + e) * (k + 1.0 + e) * (k + 2.0 + e))
    return torch.exp(d) * front


def gammainc_gl(a, x, n_nodes: int, gln, tiny: float):
    """P(a, x) by fixed Gauss–Legendre integration of the gamma density
    between x and a point deep in the far tail (Numerical Recipes'
    gammpapprox); ``gln`` is ln Γ(a)."""
    x = torch.clamp(x, max=1e6)
    y, w = np.polynomial.legendre.leggauss(n_nodes)
    a1 = a - 1.0
    sqa = torch.sqrt(torch.clamp(a1, min=tiny))
    xu_hi = torch.maximum(a1 + 11.5 * sqa, x + 6.0 * sqa)
    xu_lo = torch.clamp(torch.minimum(a1 - 7.5 * sqa, x - 5.0 * sqa), min=0.0)
    above = x > a1
    xu = torch.where(above, xu_hi, xu_lo)
    half = 0.5 * (xu - x)
    s = None
    for yj, wj in zip(y.tolist(), w.tolist()):
        t = torch.clamp(x + half * (yj + 1.0), min=tiny)
        f = torch.exp(a1 * torch.log(t) - t - gln)
        s = wj * f if s is None else s + wj * f
    s = s * half
    out = torch.clamp(torch.where(above, 1.0 - s, -s), 0.0, 1.0)
    return torch.where(x > 0.0, out, torch.zeros_like(out))


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------


def invert_gamma(rows, eps: float):
    """(n, θ, k) of a gamma mode from its moments (k clipped to [eps, 10])."""
    m0, m1 = rows[0], rows[1]
    valid = (m0 > eps) & (m1 > eps)
    m0s = _sel(valid, m0, 1.0)
    m1s = _sel(valid, m1, 1.0)
    m2s = _sel(valid, rows[2], 2.0)
    mean = m1s / m0s
    denom = m2s / m1s - mean
    denom = _sel(torch.abs(denom) > 0, denom, eps)
    k = torch.clamp(mean / denom, eps, 10.0)
    theta = mean / k
    n = _sel(valid, m0, 0.0)
    return n, _sel(valid, theta, 1.0), _sel(valid, k, 1.0)


def f2_gis(t: Tables, thr: float, theta, k):
    """P(2k + s, T/θ), s = 0..2M−2: the top order by Gauss–Legendre with
    the Stirling lgamma, the rest by the clipped downward recurrence."""
    M = t.M
    tiny = t.tiny
    x = torch.clamp(torch.div(_const(thr, theta), theta), max=1e6)
    log_x = torch.log(torch.clamp(x, min=tiny))
    a0 = 2.0 * k
    lga01 = lgamma_stirling(a0 + 1.0, tiny)
    d = torch.exp(a0 * log_x - x - lga01)
    d = _sel(x > 0.0, d, 0.0)
    ds = [d]
    prod = None
    for j in range(1, 2 * M - 2):
        ds.append(ds[-1] * x / (a0 + j))
        prod = (a0 + j) if prod is None else prod * (a0 + j)
    gi = gammainc_gl(a0 + (2.0 * M - 2.0), x, t.gl_nodes, lga01 + torch.log(prod), tiny)
    gis = [gi]
    for j in range(2 * M - 3, -1, -1):
        gi = torch.clamp(gi + ds[j], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()
    return gis


def coal_rows(t: Tables, mom_rows):
    """Coalescence tendencies of normalised rows, and the closure of each
    mode: (acc, params), acc[o] None where no term lands."""
    eps = t.eps
    M = t.M
    params, mf, gis = [], [], {}
    for i in range(len(t.nprog)):
        o = t.offsets[i]
        n, p1, p2 = invert_gamma(mom_rows[o:o + t.nprog[i]], eps)
        params.append((n, p1, p2))
        rows = [n]
        m = n
        for q in range(M - 1):
            m = m * p1 * (p2 + q)
            rows.append(m)
        mf.append(rows)
        if t.thr_flag[i]:
            gis[i] = f2_gis(t, t.thr[i], p1, p2)
    f2_cache = {}

    def f2(k, a, b):
        key = (k, a, b)
        if key not in f2_cache:
            mm = mf[k][a] * mf[k][b]
            val = torch.minimum(mm, mm * gis[k][a + b]) if k in gis else mm
            f2_cache[key] = _sel(mm < eps, 0.0, val)
        return f2_cache[key]

    acc = [None] * t.n_tot
    flat = [row for rows in mf for row in rows]
    for (o, i, j, c) in t.wb_nz:
        term = c * flat[i] * flat[j]
        acc[o] = term if acc[o] is None else acc[o] + term
    for (o, k, a, b, c) in t.wf_nz:
        term = c * f2(k, a, b)
        acc[o] = term if acc[o] is None else acc[o] + term
    return acc, params


def flux_rows(t: Tables, params):
    """Normalised sedimentation flux −Σ_k c_k·M_{m+e_k} of each moment."""
    out = [None] * t.n_tot
    for i in range(len(t.nprog)):
        n, p1, p2 = params[i]
        logp1 = torch.log(torch.clamp(p1, min=t.tiny))
        flux = [None] * t.nprog[i]
        for (c, e) in t.vel_n:
            v = n * torch.exp(e * logp1) * gamma_ratio(p2, e)
            for m in range(t.nprog[i]):
                if m > 0:
                    v = v * p1 * (p2 + (m - 1.0) + e)
                term = c * v
                flux[m] = term if flux[m] is None else flux[m] + term
        for m in range(t.nprog[i]):
            out[t.offsets[i] + m] = -flux[m]
    return out


def rhs_rows(t: Tables, y_rows):
    """Per-level coalescence tendencies and sedimentation fluxes of
    physical rows: clip negatives, normalise, skip empty levels."""
    eps = t.eps
    mom_rows, empty = [], None
    for o in range(t.n_tot):
        r = torch.clamp(y_rows[o], min=0.0) * (1.0 / t.mom_norms[o])
        mom_rows.append(r)
        lo = r < eps
        empty = lo if empty is None else (empty & lo)
    acc, params = coal_rows(t, mom_rows)
    flux = flux_rows(t, params)
    zero = torch.zeros_like(y_rows[0])
    coal = [torch.where(empty, zero, zero if acc[o] is None else acc[o]) * t.mom_norms[o]
            for o in range(t.n_tot)]
    return coal, [flux[o] * t.mom_norms[o] for o in range(t.n_tot)]


def step(t: Tables, mom: torch.Tensor) -> torch.Tensor:
    """One SSPRK33 step of length ``t.dt`` of a state ``[n_tot, B]``."""
    n_tot, nz = t.n_tot, t.nz
    B = mom.shape[1]
    if B % nz != 0:
        raise ValueError(f"B={B} is not a multiple of nz={nz}")
    top = (torch.arange(B, device=mom.device) % nz) == (nz - 1)
    zero = torch.zeros_like(mom[0])

    def shift_up(row):
        return torch.where(top, zero, torch.roll(row, -1))

    def rhs(y_rows):
        coal, flux = rhs_rows(t, y_rows)
        return [coal[o] - (shift_up(flux[o]) - flux[o]) * t.inv_dz for o in range(n_tot)]

    dt = t.dt
    y = [mom[o] for o in range(n_tot)]
    f0 = rhs(y)
    u1 = [y[o] + dt * f0[o] for o in range(n_tot)]
    f1 = rhs(u1)
    u2 = [0.75 * y[o] + 0.25 * (u1[o] + dt * f1[o]) for o in range(n_tot)]
    f2 = rhs(u2)
    return torch.stack([torch.div(y[o], _const(3.0, y[o])) + (2.0 / 3.0) * (u2[o] + dt * f2[o])
                        for o in range(n_tot)])


def _stepper(t: Tables, y: torch.Tensor):
    """``advance()`` → the next state of a block, starting from `y`. On a
    CUDA device the step is captured once in a CUDA graph and replayed: a
    step is some five thousand small launches, whose dispatch would
    otherwise take most of the reference's time."""
    if not y.is_cuda:
        box = [y]

        def advance():
            box[0] = step(t, box[0])
            return box[0]

        return advance
    static_in = y.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(t, static_in)  # makes the constants, warms the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = step(t, static_in)

    def advance():
        graph.replay()
        static_in.copy_(static_out)
        return static_in

    return advance


def run(t: Tables, y0: torch.Tensor, n_steps: int, save_every: int,
        block_lanes: int = 1 << 17):
    """`n_steps` steps from `y0` ``[n_tot, B]``; returns the states after
    every `save_every` steps, ``[n_steps // save_every, n_tot, B]``, in
    blocks of whole columns of at most `block_lanes` lanes."""
    B = y0.shape[1]
    per = max(block_lanes // t.nz, 1) * t.nz
    out = torch.empty((n_steps // save_every,) + tuple(y0.shape), dtype=y0.dtype,
                      device=y0.device)
    for lo in range(0, B, per):
        advance = _stepper(t, y0[:, lo:lo + per].contiguous())
        for n in range(1, n_steps + 1):
            y = advance()
            if n % save_every == 0:
                out[n // save_every - 1, :, lo:lo + per] = y
    return out
