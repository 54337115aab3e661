"""Hand-written CUDA kernels for the coalescence RHS and the whole rainshaft
step, with their plain PyTorch twins.

Counterpart of `cloudy_tpu.ops.pallas_coalescence`:

- `make_coal_fn` (kernel ``cloudy_coal_*`` in csrc/fused_coalescence.cu)
  replaces `make_pallas_coal_fn`: normalized moments → coalescence
  tendencies, the RHS that bench.py measures;
- `make_rainshaft_step_fn` (kernel ``cloudy_step_*``) replaces
  `make_pallas_rainshaft_step_fn`: one whole SSPRK33 rainshaft step (three
  RHS evaluations of clip → normalize → empty mask → coalescence →
  sedimentation flux → upwind stencil, then the RK combinations), reading and
  writing the state once.

Both kernels share the device physics of csrc/coal_body.cuh, the counterpart
of `_make_coal_body`, `_invert_rows` and `_sedi_flux_rows`. The kernels are
table-driven: the host packs one configuration (`FusedPlan`) into a small
byte buffer that each block copies into shared memory.

Layout: the flat structure-of-arrays ``[n_tot, B]``, one CUDA thread per
lane (one level of one column), z contiguous within each column.

Beside each kernel sits its plain twin (`coal_soa_plain`,
`rainshaft_step_soa_plain`): the same operations in the same order on the
same rows, in PyTorch. A wrapper runs the twin only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. It never falls back.

Coverage: GAMMA and EXPONENTIAL modes, FixedThreshold, exact F2 on the
Gauss–Legendre tier (``f2_exact=True``, ``gammainc_gl_nodes > 0``) — the
pod ``fixed2gamma`` configuration and bench.py's. Anything else raises
`NotImplementedError` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, get_moments_normalizing_factors
from cloudy_tpu_torch.coalescence import CoalescenceData
from cloudy_tpu_torch.ops import special

# Capacities of csrc/coal_body.cuh and the int32 header slots of the packed
# configuration; the library exports its own (`cloudy_layout`) and
# `_build.load_library` refuses a library whose values differ from `LAYOUT`.
MAX_MODES = 3
MAX_NTOT = 9
MAX_M = 5
CFG_MAX_BYTES = 12288
HEADER_INTS = 8
LAYOUT = (MAX_MODES, MAX_NTOT, MAX_M, CFG_MAX_BYTES, HEADER_INTS)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Host-side tables of one kernel configuration, shared by the CUDA
    kernels (packed by `pack_config`) and by the plain twins."""

    families: Tuple[int, ...]
    offsets: Tuple[int, ...]
    nprog: Tuple[int, ...]
    #: per mode: normalized fixed threshold, or None (no F2 quadrature)
    thresholds: Tuple[object, ...]
    M: int
    #: (o, i, j, c): acc[o] += c · Mf[i] · Mf[j], flat index i = mode·M + p
    wb_nz: Tuple[Tuple[int, int, int, float], ...]
    #: (o, k, a, b, c): acc[o] += c · F2[k][a, b], a ≤ b, only in-range entries
    wf_nz: Tuple[Tuple[int, int, int, int, float], ...]
    gl_nodes: int
    mom_norms: Tuple[float, ...] = ()
    #: normalized velocity (c · m_norm^e, e) pairs
    vel_n: Tuple[Tuple[float, float], ...] = ()
    nz: int = 1
    inv_dz: float = 0.0
    dt: float = 0.0

    @property
    def n_tot(self) -> int:
        return sum(self.nprog)

    @property
    def n_modes(self) -> int:
        return len(self.families)


def _wb_nonzeros(data: CoalescenceData):
    """Static sparse view of the bilinear weights: [(out, i, j, coeff)]."""
    out = []
    n_out, D, _ = data.wb.shape
    for o in range(n_out):
        for i in range(D):
            for j in range(D):
                c = data.wb[o, i, j]
                if c != 0.0:
                    out.append((o, i, j, float(c)))
    return out


def _wf_nonzeros(data: CoalescenceData):
    out = []
    n_out, N, M, _ = data.wf.shape
    for o in range(n_out):
        for k in range(N):
            for p in range(M):
                for q in range(M):
                    c = data.wf[o, k, p, q]
                    if c != 0.0:
                        out.append((o, k, p, q, float(c)))
    return out


def check_supported(data: CoalescenceData) -> None:
    """Raise `NotImplementedError` for a configuration the CUDA kernels do not
    cover yet, naming the ROADMAP item that ports it."""
    fams = data.spec.families
    if data.moving:
        raise NotImplementedError(
            "MovingThreshold is not ported to the CUDA kernels yet (ROADMAP A.7, B-arms)"
        )
    for fam in fams:
        if fam not in (Family.GAMMA, Family.EXPONENTIAL):
            raise NotImplementedError(
                f"{fam.name} modes are not ported to the CUDA kernels yet "
                "(ROADMAP A.7, B-arms)"
            )
    if not (data.f2_exact and data.gammainc_gl_nodes > 0):
        raise NotImplementedError(
            "only the exact-F2 Gauss–Legendre tier (f2_exact=True, "
            "gammainc_gl_nodes > 0) is ported to the CUDA kernels; the "
            "quadrature and series/CF tiers are ROADMAP B-arms"
        )
    if len(fams) > MAX_MODES or data.spec.n_tot > MAX_NTOT or data.M > MAX_M:
        raise NotImplementedError(
            f"configuration exceeds the kernels' capacities (modes ≤ {MAX_MODES}, "
            f"n_tot ≤ {MAX_NTOT}, M ≤ {MAX_M}); per-configuration code "
            "generation is ROADMAP B-codegen"
        )


def build_plan(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]] = (),
    norms: Tuple[float, float] = (1.0, 1.0),
    nz: int = 1,
    dz: float = 1.0,
    dt: float = 0.0,
) -> FusedPlan:
    """Tables of one configuration; `vel`, `norms`, `nz`, `dz`, `dt` matter
    for the whole-step kernel only."""
    check_supported(data)
    spec = data.spec
    N = spec.n_modes
    thresholds = tuple(
        float(data.thresholds[i])
        if i < N - 1 and np.isfinite(data.thresholds[i]) else None
        for i in range(N)
    )
    wf_nz = []
    for (o, k, p, q, c) in _wf_nonzeros(data):
        if p >= data.n_2d_ints[k] or q >= data.n_2d_ints[k]:
            continue  # structurally zero F2 entry (`f2_lookup` → None)
        wf_nz.append((o, k, min(p, q), max(p, q), c))
    mom_norms = tuple(
        float(v) for v in get_moments_normalizing_factors(spec.nprogmoms, norms)
    )
    vel_n = tuple((float(c) * norms[1] ** float(e), float(e)) for (c, e) in vel)
    return FusedPlan(
        families=tuple(int(f) for f in spec.families),
        offsets=spec.offsets,
        nprog=spec.nprogmoms,
        thresholds=thresholds,
        M=data.M,
        wb_nz=tuple(_wb_nonzeros(data)),
        wf_nz=tuple(wf_nz),
        gl_nodes=int(data.gammainc_gl_nodes),
        mom_norms=mom_norms,
        vel_n=vel_n,
        nz=int(nz),
        inv_dz=1.0 / float(dz),
        dt=float(dt),
    )


def pack_config(plan: FusedPlan, dtype: torch.dtype) -> np.ndarray:
    """The byte buffer the kernels read (layout: csrc/coal_body.cuh,
    `Config::bind`). Real constants are computed in double on the host and
    rounded once to the kernel's type, as JAX folds Python floats."""
    real_t = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    N = plan.n_modes
    gl_y, gl_w = np.polynomial.legendre.leggauss(plan.gl_nodes)

    def per_mode(vals, fill=0):
        return list(vals) + [fill] * (MAX_MODES - len(vals))

    # header; slot 7 becomes the byte offset of the reals
    ints = [N, plan.n_tot, plan.M, plan.gl_nodes, len(plan.wb_nz),
            len(plan.wf_nz), len(plan.vel_n), 0]
    ints += per_mode(plan.families)
    ints += per_mode(plan.offsets)
    ints += per_mode(plan.nprog)
    ints += per_mode([0 if t is None else 1 for t in plan.thresholds])
    for (o, i, j, _) in plan.wb_nz:
        ints += [o, i, j]
    for (o, k, a, b, _) in plan.wf_nz:
        ints += [o, k, a, b]
    if len(ints) % 2:
        ints.append(0)  # 8-byte align the real section
    real_offset = 4 * len(ints)

    norms = list(plan.mom_norms) or [1.0] * plan.n_tot
    reals = per_mode([0.0 if t is None else t for t in plan.thresholds], 0.0)
    reals += norms + [1.0] * (MAX_NTOT - plan.n_tot)
    reals += [1.0 / v for v in norms] + [1.0] * (MAX_NTOT - plan.n_tot)
    reals += [c for (*_, c) in plan.wb_nz]
    reals += [c for (*_, c) in plan.wf_nz]
    reals += [c for (c, _) in plan.vel_n]
    reals += [e for (_, e) in plan.vel_n]
    reals += [math.gamma(1.0 + e) for (_, e) in plan.vel_n]
    # m + e for the exponential flux ladder, m = 0..2 (Python-double sum)
    for (_, e) in plan.vel_n:
        reals += [m + e for m in range(3)]
    reals += [float(y) + 1.0 for y in gl_y]
    reals += [float(w) for w in gl_w]
    reals += [plan.dt, plan.inv_dz, 2.0 / 3.0]

    ints[7] = real_offset
    total = real_offset + np.dtype(real_t).itemsize * len(reals)
    total += (-total) % 16
    if total > CFG_MAX_BYTES:
        raise NotImplementedError(
            f"configuration tables need {total} bytes > {CFG_MAX_BYTES}; "
            "per-configuration code generation is ROADMAP B-codegen"
        )
    buf = np.zeros(total, np.uint8)
    buf[:real_offset] = np.asarray(ints, np.int32).view(np.uint8)
    rb = np.asarray(reals, np.float64).astype(real_t).view(np.uint8)
    buf[real_offset:real_offset + rb.size] = rb
    return buf


# --------------------------------------------------------------------------
# plain twins (the same arithmetic as the kernels, on [B] rows)
# --------------------------------------------------------------------------


def _invert_rows(fam: int, rows, eps: float):
    """Closure inversion on rows (mirrors
    `cloudy_tpu.ops.pallas_numerical._invert_rows` for gamma and
    exponential; k clipped to [eps, 10], distributions.GAMMA_K_RANGE)."""
    m0, m1 = rows[0], rows[1]
    valid = (m0 > eps) & (m1 > eps)
    m0s = special.select(valid, m0, 1.0)
    m1s = special.select(valid, m1, 1.0)
    if fam == Family.EXPONENTIAL:
        n = special.select(valid, m0, 0.0)
        p1 = special.select(valid, m1s / m0s, 1.0)
        return n, p1, torch.zeros_like(p1)
    m2s = special.select(valid, rows[2], 2.0)
    mean = m1s / m0s
    denom = m2s / m1s - mean
    denom = special.select(torch.abs(denom) > 0, denom, eps)
    k = torch.clamp(mean / denom, eps, 10.0)
    theta = mean / k
    n = special.select(valid, m0, 0.0)
    return n, special.select(valid, theta, 1.0), special.select(valid, k, 1.0)


def _gis_exact(thr: float, theta, k, M: int, gl_nodes: int):
    """P(2k + s, T/θ), s = 0..2M−2: one GL incomplete gamma at the top order
    and the clipped downward Poisson recurrence (`_f2_gamma_exact`)."""
    tiny = torch.finfo(theta.dtype).tiny
    x = torch.clamp(special.rdiv(thr, theta), max=1e6)
    log_x = torch.log(torch.clamp(x, min=tiny))
    a0 = 2.0 * k
    lga01 = special.lgamma_stirling(a0 + 1.0)
    d = special.exp(a0 * log_x - x - lga01)
    d = special.select(x > 0.0, d, 0.0)
    ds = [d]
    prod = None
    for j in range(1, 2 * M - 2):
        ds.append(ds[-1] * x / (a0 + j))
        prod = (a0 + j) if prod is None else prod * (a0 + j)
    gi = special.gammainc_gl(
        a0 + (2.0 * M - 2.0), x, n_nodes=gl_nodes, gln=lga01 + torch.log(prod)
    )
    gis = [gi]
    for j in range(2 * M - 3, -1, -1):
        gi = torch.clamp(gi + ds[j], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()
    return gis


def _coal_body_rows(plan: FusedPlan, mom_rows):
    """The shared physics on NORMALIZED rows: closure → integer moments →
    exact F2 → clamp → Q/R/S sparse FMAs. Returns (acc, params); acc[o] is
    None where no term lands."""
    dtype = mom_rows[0].dtype
    eps = torch.finfo(dtype).eps
    M = plan.M
    params, mf, gis = [], [], {}
    for i, fam in enumerate(plan.families):
        o = plan.offsets[i]
        n, p1, p2 = _invert_rows(fam, mom_rows[o:o + plan.nprog[i]], eps)
        params.append((n, p1, p2))
        rows = [n]
        m = n
        for q in range(M - 1):
            if fam == Family.EXPONENTIAL:
                m = m * p1 * (q + 1.0)
            else:
                m = m * p1 * (p2 + q)
            rows.append(m)
        mf.append(rows)
        if plan.thresholds[i] is not None:
            kk = p2 if fam == Family.GAMMA else torch.ones_like(p1)
            gis[i] = _gis_exact(plan.thresholds[i], p1, kk, M, plan.gl_nodes)

    f2_cache = {}

    def f2(k, a, b):
        key = (k, a, b)
        if key not in f2_cache:
            mm = mf[k][a] * mf[k][b]
            val = torch.minimum(mm, mm * gis[k][a + b]) if k in gis else mm
            f2_cache[key] = special.select(mm < eps, 0.0, val)
        return f2_cache[key]

    acc = [None] * plan.n_tot
    flat = [row for rows in mf for row in rows]
    for (o, i, j, c) in plan.wb_nz:
        term = c * flat[i] * flat[j]
        acc[o] = term if acc[o] is None else acc[o] + term
    for (o, k, a, b, c) in plan.wf_nz:
        term = c * f2(k, a, b)
        acc[o] = term if acc[o] is None else acc[o] + term
    return acc, params


def _sedi_flux_rows(plan: FusedPlan, params):
    """Normalized sedimentation flux rows ``−Σ_k c_k·M_{m+e_k}`` from the
    closure parameters (`_sedi_flux_rows` with ``fast_ratio=True``)."""
    out = [None] * plan.n_tot
    for i, fam in enumerate(plan.families):
        n, p1, p2 = params[i]
        logp1 = torch.log(torch.clamp(p1, min=torch.finfo(p1.dtype).tiny))
        flux = [None] * plan.nprog[i]
        for (c, e) in plan.vel_n:
            if fam == Family.GAMMA:
                t = n * special.exp(e * logp1) * special.gamma_ratio(p2, e)
            else:
                t = n * math.gamma(1.0 + e) * special.exp(e * logp1)
            for m in range(plan.nprog[i]):
                if m > 0:
                    if fam == Family.GAMMA:
                        t = t * p1 * (p2 + (m - 1.0) + e)
                    else:
                        t = t * p1 * (m + e)
                term = c * t
                flux[m] = term if flux[m] is None else flux[m] + term
        for m in range(plan.nprog[i]):
            out[plan.offsets[i] + m] = -flux[m]
    return out


def coal_soa_plain(mom: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Plain twin of the coalescence kernel: normalized ``[n_tot, B]`` →
    tendencies ``[n_tot, B]``."""
    acc, _ = _coal_body_rows(plan, [mom[o] for o in range(plan.n_tot)])
    zero = torch.zeros_like(mom[0])
    return torch.stack([zero if a is None else a for a in acc])


def rainshaft_step_soa_plain(mom: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Plain twin of the whole-step kernel: physical ``[n_tot, B]`` state →
    the state one SSPRK33 step of length ``plan.dt`` later."""
    n_tot, nz = plan.n_tot, plan.nz
    B = mom.shape[1]
    if B % nz != 0:
        raise ValueError(f"B={B} is not a multiple of nz={nz}")
    eps = torch.finfo(mom.dtype).eps
    top = (torch.arange(B, device=mom.device) % nz) == (nz - 1)
    zero = torch.zeros_like(mom[0])

    def shift_up(row):
        # level i's upstream flux F[i+1]; zero influx at each column's top
        return torch.where(top, zero, torch.roll(row, -1))

    def rhs(y_rows):
        mom_rows, empty = [], None
        for o in range(n_tot):
            r = torch.clamp(y_rows[o], min=0.0) * (1.0 / plan.mom_norms[o])
            mom_rows.append(r)
            lo = r < eps
            empty = lo if empty is None else (empty & lo)
        acc, params = _coal_body_rows(plan, mom_rows)
        flux = _sedi_flux_rows(plan, params)
        rows = []
        for o in range(n_tot):
            coal = zero if acc[o] is None else acc[o]
            coal = torch.where(empty, zero, coal) * plan.mom_norms[o]
            f = flux[o] * plan.mom_norms[o]
            rows.append(coal - (shift_up(f) - f) * plan.inv_dz)
        return rows

    dt = plan.dt
    y = [mom[o] for o in range(n_tot)]
    f0 = rhs(y)
    u1 = [y[o] + dt * f0[o] for o in range(n_tot)]
    f1 = rhs(u1)
    u2 = [0.75 * y[o] + 0.25 * (u1[o] + dt * f1[o]) for o in range(n_tot)]
    f2 = rhs(u2)
    return torch.stack(
        [y[o] / 3.0 + (2.0 / 3.0) * (u2[o] + dt * f2[o]) for o in range(n_tot)]
    )


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


class _KernelFn:
    """Dispatch shared by the two wrappers: the plain twin for a CPU tensor,
    the CUDA kernel for a CUDA tensor; `launches` counts kernel launches."""

    _symbol = ""

    def __init__(self, plan: FusedPlan, device, dtype: torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, not {dtype}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.plan = plan
        self.device = device
        self.dtype = dtype
        self.launches = 0
        self._cfg = None

    def _check(self, mom: torch.Tensor) -> None:
        if mom.device != self.device:
            raise ValueError(f"tensor on {mom.device}, wrapper built for {self.device}")
        if mom.dtype != self.dtype:
            raise ValueError(f"tensor of {mom.dtype}, wrapper built for {self.dtype}")
        if mom.ndim != 2 or mom.shape[0] != self.plan.n_tot or mom.shape[1] == 0:
            raise ValueError(
                f"expected [n_tot={self.plan.n_tot}, B > 0], got {tuple(mom.shape)}"
            )
        if not mom.is_contiguous():
            raise ValueError("expected a contiguous [n_tot, B] tensor")

    def _launch(self, mom: torch.Tensor, *extra) -> torch.Tensor:
        from cloudy_tpu_torch.ops import _build

        lib = _build.load_library()
        if self._cfg is None:
            buf = pack_config(self.plan, self.dtype)
            self._cfg = torch.from_numpy(buf).to(self.device)
        out = torch.empty_like(mom)
        tag = "f32" if self.dtype == torch.float32 else "f64"
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = getattr(lib, f"{self._symbol}_{tag}")(
                mom.data_ptr(), out.data_ptr(), self._cfg.data_ptr(),
                self._cfg.numel(), mom.shape[1], *extra, stream,
            )
        if err != 0:
            raise RuntimeError(
                f"{self._symbol}_{tag} launch failed: cudaError {err} "
                f"({lib.cloudy_error_string(err).decode()})"
            )
        self.launches += 1
        return out


class CoalFn(_KernelFn):
    """Coalescence RHS (replaces `make_pallas_coal_fn`): ``fn(mom [B, n_tot])``
    and ``fn.soa(mom [n_tot, B])`` on normalized moments."""

    _symbol = "cloudy_coal"

    def soa(self, mom: torch.Tensor) -> torch.Tensor:
        self._check(mom)
        if mom.device.type == "cpu":
            return coal_soa_plain(mom, self.plan)
        return self._launch(mom)

    def __call__(self, mom: torch.Tensor) -> torch.Tensor:
        return self.soa(mom.T.contiguous()).T

    def plain(self, mom: torch.Tensor) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        return coal_soa_plain(mom, self.plan)


class RainshaftStepFn(_KernelFn):
    """Whole SSPRK33 rainshaft step (replaces
    `make_pallas_rainshaft_step_fn`): ``fn(mom [n_tot, B])``, physical
    moments, ``B % nz == 0``."""

    _symbol = "cloudy_step"

    def __call__(self, mom: torch.Tensor) -> torch.Tensor:
        self._check(mom)
        if mom.shape[1] % self.plan.nz != 0:
            raise ValueError(f"B={mom.shape[1]} is not a multiple of nz={self.plan.nz}")
        if mom.device.type == "cpu":
            return rainshaft_step_soa_plain(mom, self.plan)
        return self._launch(mom, self.plan.nz)

    def plain(self, mom: torch.Tensor) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        return rainshaft_step_soa_plain(mom, self.plan)


def make_coal_fn(data: CoalescenceData, device="cuda",
                 dtype: torch.dtype = torch.float32) -> CoalFn:
    """Coalescence RHS on `device` in `dtype`; see `CoalFn`."""
    return CoalFn(build_plan(data), device, dtype)


def make_rainshaft_step_fn(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]],
    norms: Tuple[float, float],
    nz: int,
    dz: float,
    dt: float,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> RainshaftStepFn:
    """Whole SSPRK33 rainshaft step on `device` in `dtype`; see
    `RainshaftStepFn`. `vel` is the PHYSICAL power-law velocity."""
    if nz < 2 or nz > 1024:
        raise ValueError(f"nz={nz} must lie in [2, 1024] (one block holds a column)")
    return RainshaftStepFn(build_plan(data, vel, norms, nz, dz, dt), device, dtype)
