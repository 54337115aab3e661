"""Hand-written CUDA kernels for the coalescence RHS and the whole rainshaft
step, with their plain PyTorch twins.

Counterpart of `cloudy_tpu.ops.pallas_coalescence`:

- `make_coal_fn` (kernel ``cloudy_coal_*`` in csrc/fused_coalescence.cu)
  replaces `make_pallas_coal_fn`: normalized moments → coalescence
  tendencies, the RHS that bench.py measures;
- `make_rainshaft_rhs_fn` (kernel ``cloudy_rhs_*``) replaces
  `make_pallas_rainshaft_rhs_fn`: the fused per-level RHS, physical moments
  → ``[coal; flux]`` (``[2·n_tot, B]``), the stencil left to the caller;
- `make_rainshaft_step_fn` (kernel ``cloudy_step_*``) replaces
  `make_pallas_rainshaft_step_fn`: one whole SSPRK33 rainshaft step (three
  RHS evaluations of clip → normalize → empty mask → coalescence →
  sedimentation flux → upwind stencil, then the RK combinations), reading and
  writing the state once; with ``kernel_scale=True`` (its ``fn_scaled``,
  kernel ``cloudy_step_scaled_*``) the call is ``fn(mom, scale)`` and each
  lane's coalescence tendency is multiplied by its entry of the `scale` row,
  the calibration hook.

The kernels share the device physics of csrc/coal_body.cuh, the counterpart
of `_make_coal_body`, `_invert_rows` and `_sedi_flux_rows`, and reach it by
one of two routes, chosen from the plan alone (the wrapper's `route`):

- ``"generated"``: the whole step and the fused RHS of every plan, and the
  coalescence RHS of a fast-tier plan, run a kernel generated for that
  configuration and type (`ops.codegen`, csrc/gen_kernels.cuh), every
  table compiled in; a reference-tier plan's switches (quadrature rule,
  iteration counts, F2 kinds) with them;
- ``"table"``: the coalescence RHS of a reference-tier plan runs the
  table-driven kernels (csrc/fused_coalescence.cu): the host packs the
  configuration (`pack_config`) into a byte buffer that each block copies
  into shared memory. A plan within the prebuilt capacities (`CAPS`: 3
  modes, 9 moments, M 5) runs the prebuilt library; a plan past them runs
  units built at first use with capacities of its own (`plan_caps`,
  `codegen.ref_unit`).

The whole step with a per-lane kernel scale (B1s) takes the same route as
the whole step. The table-driven instances of the whole step, the scaled
step and the fused RHS (both tiers) and of the fast coalescence RHS are
still built, reachable only through the constructors' private ``_table``
argument: `chip_smoke.py` times them beside the generated kernels.

Layout: the flat structure-of-arrays ``[n_tot, B]``, one CUDA thread per
lane (one level of one column), z contiguous within each column. The
reference tier's coalescence RHS gives each box a warp instead at small
batches (`coal_layout`, from B and the card: its quadrature grid's nodes
strided across the lanes).

Beside each kernel sits its plain twin (`coal_soa_plain`,
`rainshaft_rhs_soa_plain`, `rainshaft_step_soa_plain`): the same operations
in the same order on the same rows, in PyTorch. A wrapper runs the twin
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises. It never falls back.

Coverage: all four families (GAMMA, EXPONENTIAL, LOGNORMAL, MONODISPERSE)
under FixedThreshold and MovingThreshold, with the per-call overrides of
`make_pallas_coal_fn` (`quad_rule`, `gauss_nodes`, `gammainc_iters`,
`thr_newton_iters`, `thr_gammainc_iters`, `f2_exact`, `gammainc_gl_nodes`;
the same defaults):

- the fast tier: exact gamma/exponential F2 with the Gauss–Legendre
  incomplete gamma (``f2_exact=True``, ``gammainc_gl_nodes > 0``; moving
  gamma thresholds by the GL Halley inverse), lognormal F2 by the recentred
  GL window (``lognorm_gl_nodes > 0``): the pod ``fixed2gamma``, ``moving``
  and ``lognorm`` configurations and bench.py's;
- the reference tier: gamma/exponential F2 on a quadrature grid (the masked
  log-grid Simpson rule of ``quad_rule="reference"`` or Gauss–Legendre on
  the same interval, fixed grids built on the host, moving ones per lane),
  lognormal F2 on the same grids by the exact Φ partial moments (erf by the
  series/CF P(½, z²), or the rational `erf_approx` at ``gammainc_gl_nodes >
  0``; ``lognorm_gl_nodes=0``), the series/continued-fraction incomplete
  gamma (``gammainc_gl_nodes=0``), the damped-Newton percentile inverse, the
  Lanczos-pair flux, and monodisperse modes (closure, recurrence M·θ, moving
  threshold θ, the closed-form F2 where θ < T/2, flux n·θ^e) — the default
  of every JAX kernel factory and the tier of every golden.

Any number of modes and moments runs: the generated kernels are sized from
the configuration, the table-driven ones from their capacities. The packed
tables live in shared memory, up to the card's opt-in limit per block; a
configuration past it raises, saying so. Each kernel is compiled three
times: without the MovingThreshold and lognormal arms, with them, and with
the reference tier besides; `FusedPlan.instance` picks one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, get_moments_normalizing_factors
from cloudy_tpu_torch.coalescence import LOGNORM_WINDOW_SIGMA, CoalescenceData
from cloudy_tpu_torch.ops import special
from cloudy_tpu_torch.ops.simpson import simpson_even_fast_weights
from cloudy_tpu_torch.utils import metrics

# Capacities of the prebuilt table-driven kernels (csrc/coal_body.cuh
# CLOUDY_CAP_*: modes, moments, moment orders M) and the int32 header slots
# of the packed configuration, whose per-mode slots follow the capacities
# (`header_ints`). A plan past them runs units built at first use with its
# own (`plan_caps`). The library and each unit export their layout
# (`cloudy_layout`, `cloudy_ref_layout`); `_build` refuses one whose values
# differ from the host's `layout(caps)`, so that a buffer is never read with
# another layout than it was packed with.
MAX_MODES = 3
MAX_NTOT = 9
MAX_M = 5
CAPS = (MAX_MODES, MAX_NTOT, MAX_M)


def header_ints(caps=CAPS) -> int:
    """Int32 slots before the per-mode family slots: 16 header slots and
    the per-mode F2 kinds and grid lengths (csrc/coal_body.cuh I_FAM)."""
    return 16 + 2 * caps[0]


HEADER_INTS = header_ints()


def layout(caps=CAPS) -> tuple:
    """(modes, moments, M, header ints) of the kernels at `caps`, as their
    library or unit exports them."""
    return (*caps, header_ints(caps))


LAYOUT = layout()


def plan_caps(plan) -> tuple:
    """The table-driven capacities `plan` runs at: the prebuilt `CAPS`, each
    raised to the plan's own where it exceeds them."""
    return (max(MAX_MODES, plan.n_modes), max(MAX_NTOT, plan.n_tot), max(MAX_M, plan.M))

#: per-mode F2 evaluation (`FusedPlan.f2_kind`; csrc/coal_body.cuh F2_*):
#: none, exact gamma/exponential, the lognormal window rule, a quadrature
#: grid (gamma/exponential or the lognormal Φ grid), the monodisperse
#: closed form
F2_NONE, F2_EXACT, F2_WINDOW, F2_GRID, F2_MONO = 0, 1, 2, 3, 4
QUAD_RULES = ("reference", "gauss")
#: the per-call overrides of `make_pallas_coal_fn` (pallas_coalescence.py:
#: 662-673) and their defaults; None takes the value from the data
COAL_OVERRIDES = {
    "quad_rule": "reference",
    "gauss_nodes": 24,
    "gammainc_iters": None,
    "thr_newton_iters": 32,
    "thr_gammainc_iters": 128,
    "f2_exact": None,
    "gammainc_gl_nodes": None,
}


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Host-side tables of one kernel configuration, shared by the CUDA
    kernels (packed by `pack_config`) and by the plain twins."""

    families: Tuple[int, ...]
    offsets: Tuple[int, ...]
    nprog: Tuple[int, ...]
    #: per mode: 1 where the mode carries an F2 integral (a threshold)
    thr_flag: Tuple[int, ...]
    #: per thresholded mode: FixedThreshold, the normalized threshold;
    #: MovingThreshold, gamma the percentile p, exponential −log1p(−p),
    #: lognormal Φ⁻¹(p) (host double)
    thr_const: Tuple[float, ...]
    #: thresholds are per-column percentiles (MovingThreshold)
    moving: bool
    M: int
    #: (o, i, j, c): acc[o] += c · Mf[i] · Mf[j], flat index i = mode·M + p
    wb_nz: Tuple[Tuple[int, int, int, float], ...]
    #: (o, k, a, b, c): acc[o] += c · F2[k][a, b], a ≤ b, only in-range entries
    wf_nz: Tuple[Tuple[int, int, int, int, float], ...]
    #: Gauss–Legendre nodes of the incomplete gamma; 0: series/CF
    gl_nodes: int
    #: Gauss–Legendre nodes of the lognormal window rule (0: no window mode)
    win_nodes: int = 0
    mom_norms: Tuple[float, ...] = ()
    #: normalized velocity (c · m_norm^e, e) pairs
    vel_n: Tuple[Tuple[float, float], ...] = ()
    nz: int = 1
    inv_dz: float = 0.0
    dt: float = 0.0
    #: per mode: F2_NONE, F2_EXACT, F2_WINDOW, F2_GRID or F2_MONO
    f2_kind: Tuple[int, ...] = ()
    #: quadrature rule of the F2 grids: "reference" (masked Simpson) or "gauss"
    quad_rule: str = "reference"
    #: Gauss–Legendre nodes of a "gauss" grid
    gauss_nodes: int = 24
    #: series/CF iterations of the F2 incomplete gamma
    gammainc_iters: int = 128
    #: MovingThreshold gamma percentile by Newton (gl_nodes = 0): steps and
    #: the series/CF iterations of each step
    thr_newton_iters: int = 32
    thr_gammainc_iters: int = 128
    #: points of a moving Simpson grid (`CoalescenceData.n_points_max`)
    n_points_max: int = 128
    #: per mode: None, or a FixedThreshold grid (x nodes, weights, dx) in
    #: host double (`_static_grid` / `_static_grid_gauss`)
    grids: Tuple = ()

    @property
    def n_tot(self) -> int:
        return sum(self.nprog)

    @property
    def n_modes(self) -> int:
        return len(self.families)

    @property
    def arms(self) -> int:
        """1 where the kernels' MovingThreshold/lognormal instance is
        needed, 0 for a FixedThreshold gamma/exponential configuration."""
        return int(self.moving or Family.LOGNORMAL in self.families)

    @property
    def ref(self) -> bool:
        """Whether the configuration runs reference-tier code: a quadrature
        grid (gamma/exponential, or the lognormal Φ grid), the series/CF
        incomplete gamma (with it the Newton inverse and the Lanczos-pair
        flux), or a monodisperse mode."""
        return (self.gl_nodes == 0 or F2_GRID in self.f2_kind
                or Family.MONODISPERSE in self.families)

    @property
    def instance(self) -> int:
        """The kernel instance the entry points launch: 0 fast tier without
        arms, 1 fast tier with the MovingThreshold and lognormal arms, 2 the
        reference tier (every arm)."""
        return 2 if self.ref else self.arms


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


def _thresholded(data: CoalescenceData, i: int) -> bool:
    """Whether mode i carries an F2 integral: every non-last mode under
    MovingThreshold, finite thresholds under FixedThreshold."""
    if i >= data.spec.n_modes - 1:
        return False
    return bool(data.moving or np.isfinite(data.thresholds[i]))


def _threshold_constants(data: CoalescenceData):
    """(thr_flag, thr_const) per mode; see `FusedPlan`. The lognormal
    percentile constant Φ⁻¹(p) is evaluated in true double on the host and
    rounded once at packing."""
    flags, consts = [], []
    for i, fam in enumerate(data.spec.families):
        flag = _thresholded(data, i)
        flags.append(int(flag))
        t = float(data.thresholds[i])
        if not flag:
            consts.append(0.0)
        elif not data.moving:
            consts.append(t)
        elif fam == Family.EXPONENTIAL:
            consts.append(-float(np.log1p(-t)))
        elif fam == Family.LOGNORMAL:
            consts.append(float(special.ndtri(torch.tensor(t, dtype=torch.float64))))
        else:  # GAMMA: the percentile; Φ⁻¹(p) runs in-kernel in the working type
            consts.append(t)
    return tuple(flags), tuple(consts)


def _static_grid(threshold: float, n_bins_per_log_unit: int = 15):
    """Reference log grid and masked Simpson weights for a fixed threshold
    (pallas_coalescence.py::_static_grid; ParticleDistributions.jl:579-585
    semantics, the last point masked): (x, w, dx) in host double."""
    t = float(threshold)
    x_lo = min(1e-5, 1e-5 * t)
    n_bins = int(np.floor(n_bins_per_log_unit * np.log10(t / x_lo)))
    x_min = np.log(x_lo)
    dx = (np.log(t) - x_min) / n_bins
    j = np.arange(1, n_bins + 2)
    x = np.exp(x_min + (j - 1) * dx)
    w = simpson_even_fast_weights(n_bins)
    mask = (j <= n_bins).astype(np.float64)
    return x, w * mask, float(dx)


def _static_grid_gauss(threshold: float, n_nodes: int = 24):
    """Gauss–Legendre nodes in log x on the reference grid's interval, the
    interval scale folded into the weights, dx = 1
    (pallas_coalescence.py::_static_grid_gauss)."""
    t = float(threshold)
    x_lo = min(1e-5, 1e-5 * t)
    u, wu = np.polynomial.legendre.leggauss(n_nodes)
    a, b = np.log(x_lo), np.log(t)
    x = np.exp(a + 0.5 * (b - a) * (u + 1.0))
    return x, 0.5 * (b - a) * wu, 1.0


def _overrides(data: CoalescenceData, coal_kwargs: dict) -> dict:
    """The effective per-call overrides; an unknown key raises `TypeError`
    as the JAX factories do."""
    unknown = sorted(set(coal_kwargs) - set(COAL_OVERRIDES))
    if unknown:
        raise TypeError(f"unknown kwargs: {unknown}")
    kw = {**COAL_OVERRIDES, **coal_kwargs}
    if kw["quad_rule"] not in QUAD_RULES:
        raise ValueError(f"quad_rule must be one of {QUAD_RULES}, not {kw['quad_rule']!r}")
    kw["gammainc_iters"] = int(kw["gammainc_iters"] or data.gammainc_iters)
    if kw["f2_exact"] is None:
        kw["f2_exact"] = data.f2_exact
    if kw["gammainc_gl_nodes"] is None:
        kw["gammainc_gl_nodes"] = data.gammainc_gl_nodes
    return kw


def build_plan(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]] = (),
    norms: Tuple[float, float] = (1.0, 1.0),
    nz: int = 1,
    dz: float = 1.0,
    dt: float = 0.0,
    **coal_kwargs,
) -> FusedPlan:
    """Tables of one configuration; `vel` and `norms` matter for the kernels
    that compute the sedimentation flux, `nz`, `dz`, `dt` for the whole-step
    kernel only. `coal_kwargs` are the per-call overrides of
    `make_pallas_coal_fn` (`COAL_OVERRIDES`). Every configuration the XLA
    path takes is accepted (`pallas_supported`, pallas_coalescence.py:
    105-108)."""
    kw = _overrides(data, coal_kwargs)
    spec = data.spec
    thr_flag, thr_const = _threshold_constants(data)
    f2_kind, grids = [], []
    for i, fam in enumerate(spec.families):
        grid = None
        # the Pallas body's rule (pallas_coalescence.py:199-219, :556-586)
        if not thr_flag[i]:
            kind = F2_NONE
        elif fam == Family.MONODISPERSE:
            kind = F2_MONO
        elif fam == Family.LOGNORMAL and data.lognorm_gl_nodes:
            kind = F2_WINDOW
        elif kw["f2_exact"] and fam != Family.LOGNORMAL:
            kind = F2_EXACT
        else:
            kind = F2_GRID
            if not data.moving and kw["quad_rule"] == "gauss":
                grid = _static_grid_gauss(data.thresholds[i], kw["gauss_nodes"])
            elif not data.moving:
                grid = _static_grid(data.thresholds[i])
        f2_kind.append(kind)
        grids.append(None if grid is None else
                     (tuple(grid[0].tolist()), tuple(grid[1].tolist()), grid[2]))
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
        thr_flag=thr_flag,
        thr_const=thr_const,
        moving=bool(data.moving),
        M=data.M,
        wb_nz=tuple(_wb_nonzeros(data)),
        wf_nz=tuple(wf_nz),
        gl_nodes=int(kw["gammainc_gl_nodes"]),
        win_nodes=int(data.lognorm_gl_nodes) if F2_WINDOW in f2_kind else 0,
        mom_norms=mom_norms,
        vel_n=vel_n,
        nz=int(nz),
        inv_dz=1.0 / float(dz),
        dt=float(dt),
        f2_kind=tuple(f2_kind),
        quad_rule=kw["quad_rule"],
        gauss_nodes=int(kw["gauss_nodes"]),
        gammainc_iters=kw["gammainc_iters"],
        thr_newton_iters=int(kw["thr_newton_iters"]),
        thr_gammainc_iters=int(kw["thr_gammainc_iters"]),
        n_points_max=int(data.n_points_max),
        grids=tuple(grids),
    )


def _per_mode(vals, fill=0, n=MAX_MODES):
    return list(vals) + [fill] * (n - len(vals))


def config_reals(plan: FusedPlan, caps=CAPS) -> dict:
    """The configuration's real constants in host double, by name, the
    per-mode and per-moment ones padded to `caps`: every kernel rounds each
    once to its type, as JAX folds Python floats. The table-driven kernels
    read them packed (`pack_config`, at the plan's capacities), the
    generated ones as literals (`ops.codegen`)."""
    gl_y, gl_w = (np.polynomial.legendre.leggauss(plan.gl_nodes) if plan.gl_nodes
                  else ((), ()))
    win_v, win_w = (np.polynomial.legendre.leggauss(plan.win_nodes)
                    if plan.win_nodes else ((), ()))
    # the GL base nodes of a moving "gauss" grid (`_moving_grid`), rounded
    # to the kernel's type as the Pallas grid input is
    n_gauss = (plan.gauss_nodes if plan.moving and plan.quad_rule == "gauss"
               and F2_GRID in plan.f2_kind else 0)
    gauss_u, gauss_w = (np.polynomial.legendre.leggauss(n_gauss) if n_gauss
                        else ((), ()))
    grids = [g or ((), (), 0.0) for g in plan.grids]
    norms = list(plan.mom_norms) or [1.0] * plan.n_tot
    pad = [1.0] * (caps[1] - plan.n_tot)
    return {
        "thr": _per_mode(plan.thr_const, 0.0, caps[0]),
        "norm": norms + pad,
        "inv_norm": [1.0 / v for v in norms] + pad,
        "wb_c": [c for (*_, c) in plan.wb_nz],
        "wf_c": [c for (*_, c) in plan.wf_nz],
        "vel_c": [c for (c, _) in plan.vel_n],
        "vel_e": [e for (_, e) in plan.vel_n],
        "vel_g": [math.gamma(1.0 + e) for (_, e) in plan.vel_n],
        # flux ladder orders q = m + e and the lognormal ½q² (Python doubles,
        # as the Pallas body folds `m + e` and `0.5 * q * q`), m = 0..2
        "vel_me": [m + e for (_, e) in plan.vel_n for m in range(3)],
        "vel_hq2": [0.5 * (m + e) * (m + e) for (_, e) in plan.vel_n for m in range(3)],
        "gl_y1": [float(y) + 1.0 for y in gl_y],
        "gl_w": [float(w) for w in gl_w],
        "win_v": [float(v) for v in win_v],
        "win_w": [float(w) for w in win_w],
        "dt": plan.dt,
        "inv_dz": plan.inv_dz,
        "two_thirds": 2.0 / 3.0,
        "grid_dx": _per_mode([g[2] for g in grids], 0.0, caps[0]),
        "gauss_u": [float(u) for u in gauss_u],
        "gauss_w": [float(w) for w in gauss_w],
        "grids": [v for x, w, _ in grids for v in list(x) + list(w)],
    }


def pack_config(plan: FusedPlan, dtype: torch.dtype, caps=None) -> np.ndarray:
    """The byte buffer the table-driven kernels read (layout:
    csrc/coal_body.cuh, `Config::bind`), at capacities `caps` (default the
    plan's own, `plan_caps`: the kernels it runs). Real constants are
    computed in double on the host (`config_reals`) and rounded once to the
    kernel's type, as JAX folds Python floats. The FixedThreshold quadrature
    grids (the Pallas kernels' `grid_inputs`) ride at its end, so each block
    reads them from shared memory: a three-mode configuration with two
    Simpson grids (76 and 86 points) takes 6,032 bytes in f32 and 8,480 in
    f64; the card's opt-in limit per block bounds it (`_KernelFn`)."""
    real_t = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    N = plan.n_modes
    caps = plan_caps(plan) if caps is None else tuple(caps)
    if N > caps[0] or plan.n_tot > caps[1] or plan.M > caps[2]:
        raise ValueError(f"plan (modes {N}, n_tot {plan.n_tot}, M {plan.M}) exceeds the "
                         f"capacities {caps} it is packed for")
    per_mode = lambda vals, fill=0: _per_mode(vals, fill, caps[0])  # noqa: E731
    r = config_reals(plan, caps)
    grids = [g or ((), (), 0.0) for g in plan.grids]

    # header; slot 7 becomes the byte offset of the reals
    ints = [N, plan.n_tot, plan.M, plan.gl_nodes, len(plan.wb_nz),
            len(plan.wf_nz), len(plan.vel_n), 0, int(plan.moving), plan.win_nodes]
    # reference tier: quadrature rule, iteration counts, moving grid sizes,
    # per-mode F2 kind and fixed-grid length
    ints += [int(plan.quad_rule == "gauss"), plan.gammainc_iters,
             plan.thr_newton_iters, plan.thr_gammainc_iters, plan.n_points_max,
             len(r["gauss_u"])]
    ints += per_mode(plan.f2_kind)
    ints += per_mode([len(g[0]) for g in grids])
    assert len(ints) == header_ints(caps)
    ints += per_mode(plan.families)
    ints += per_mode(plan.offsets)
    ints += per_mode(plan.nprog)
    ints += per_mode(plan.thr_flag)
    for (o, i, j, _) in plan.wb_nz:
        ints += [o, i, j]
    for (o, k, a, b, _) in plan.wf_nz:
        ints += [o, k, a, b]
    if len(ints) % 2:
        ints.append(0)  # 8-byte align the real section
    real_offset = 4 * len(ints)

    reals = []
    for key in ("thr", "norm", "inv_norm", "wb_c", "wf_c", "vel_c", "vel_e", "vel_g",
                "vel_me", "vel_hq2", "gl_y1", "gl_w", "win_v", "win_w"):
        reals += r[key]
    reals += [r["dt"], r["inv_dz"], r["two_thirds"]]
    for key in ("grid_dx", "gauss_u", "gauss_w", "grids"):
        reals += r[key]

    ints[7] = real_offset
    total = real_offset + np.dtype(real_t).itemsize * len(reals)
    total += (-total) % 16
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
    `cloudy_tpu.ops.pallas_numerical._invert_rows`; a monodisperse mode
    inverts as an exponential one; gamma k clipped to [eps, 10],
    distributions.GAMMA_K_RANGE)."""
    m0, m1 = rows[0], rows[1]
    valid = (m0 > eps) & (m1 > eps)
    if fam == Family.LOGNORMAL:
        valid = valid & (rows[2] > eps)
    m0s = special.select(valid, m0, 1.0)
    m1s = special.select(valid, m1, 1.0)
    if fam in (Family.EXPONENTIAL, Family.MONODISPERSE):
        n = special.select(valid, m0, 0.0)
        p1 = special.select(valid, m1s / m0s, 1.0)
        return n, p1, torch.zeros_like(p1)
    m2s = special.select(valid, rows[2], 2.0)
    if fam == Family.LOGNORMAL:
        mu = torch.log(m1s * m1s / (m0s ** 1.5 * m2s ** 0.5))
        sig2 = torch.log(torch.clamp(m0s * m2s / (m1s * m1s), min=1.0))
        sigma = torch.clamp(torch.sqrt(sig2), min=eps)
        n = m1s / special.exp(mu + 0.5 * (sigma * sigma))
        return (special.select(valid, n, 0.0), special.select(valid, mu, 1.0),
                special.select(valid, sigma, 1.0))
    mean = m1s / m0s
    denom = m2s / m1s - mean
    denom = special.select(torch.abs(denom) > 0, denom, eps)
    k = torch.clamp(mean / denom, eps, 10.0)
    theta = mean / k
    n = special.select(valid, m0, 0.0)
    return n, special.select(valid, theta, 1.0), special.select(valid, k, 1.0)


#: within `series_exit()`: the twins stop the lower series lane by lane
_SERIES_EXIT = contextvars.ContextVar("cloudy_series_exit", default=False)


@contextlib.contextmanager
def series_exit():
    """Within it the twins' lower series (`_gammainc_sel`) stop each lane
    at the first term that leaves its sum as it was, as the generated
    reference-tier kernels do (csrc/common.cuh `gammainc_sc`, ``kExit``),
    and work on the lanes still summing only. The sums are the fixed
    loop's, bit for bit; what changes is the work, which `tools.opcount`
    counts under it for a kernel that stops early."""
    token = _SERIES_EXIT.set(True)
    try:
        yield
    finally:
        _SERIES_EXIT.reset(token)


def _series_sum_exit(a, x, n_iters: int):
    """`special._gammainc_series_sum` of 1-D `a`, `x` with each lane
    stopped where ``total + term == total``: the terms are positive and
    shrink below a + 1, so no later term changes that lane's sum."""
    term = 1.0 / a
    total = term.clone()
    ap, live, tot = a, torch.arange(a.numel(), device=a.device), term
    for _ in range(n_iters):
        ap = ap + 1.0
        term = term * x / ap
        nxt = tot + term
        keep = nxt != tot
        live, ap, x, term, tot = live[keep], ap[keep], x[keep], term[keep], nxt[keep]
        if live.numel() == 0:
            break
        total[live] = tot
    return total


def _gammainc_sel(a, x, n_iters: int, log_x):
    """P(a, x) of `special.gammainc_impl` (``log_x`` the caller's log of x)
    with each lane's series or continued fraction evaluated only where it
    is selected, as the kernels do: `gammainc_impl` evaluates both at safe
    arguments and keeps one, so the kept values are the same. Zero where
    x ≤ 0. ``lgamma(a)`` and ``log(a + 1)`` are taken at a's own shape."""
    lga = special.lgamma(a)
    log_ap1 = torch.log(a + 1.0)
    shape = torch.broadcast_shapes(a.shape, x.shape)
    a, lga, log_ap1, log_x = (t.expand(shape) for t in (a, lga, log_ap1, log_x))
    x = torch.clamp(x.expand(shape), max=1e6)
    use_series = x < a + 1.0
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for series in (True, False):
        idx = ((use_series if series else ~use_series) & (x > 0.0)).nonzero(as_tuple=True)
        if idx[0].numel() == 0:
            continue
        aa, xx = a[idx], x[idx]
        pre = special.exp(aa * log_x[idx] - xx - lga[idx])
        if series:
            series_sum = _series_sum_exit if _SERIES_EXIT.get() else special._gammainc_series_sum
            v = series_sum(aa, xx, n_iters) * pre
        else:
            v = 1.0 - special._gammainc_contfrac_h(aa, xx, n_iters) * pre
        out[idx] = torch.clamp(v, 0.0, 1.0)
    return out


def _gammaincinv_newton(a, p: float, n_newton: int, n_iters: int):
    """x with P(a, x) = p by `special.gammaincinv_impl` (Wilson–Hilferty
    start, `n_newton` damped Newton steps), its incomplete gamma by
    `_gammainc_sel`."""
    a, p = special._clip_percentile(a, torch.full_like(a, p))
    tiny = special._finfo(a.dtype).tiny
    z = special.ndtri(p)
    t = 1.0 - 1.0 / (9.0 * a) + z * torch.sqrt(1.0 / (9.0 * a))
    x0 = a * t * t * t
    x_small = special.exp((torch.log(p) + special.lgamma(a + 1.0)) / a)
    x0 = torch.where((t > 0.0) & (x0 > 1e3 * tiny), x0, x_small)
    x = torch.clamp(x0, min=tiny)
    lg = special.lgamma(a)
    for _ in range(n_newton):
        log_xc = torch.log(torch.clamp(torch.clamp(x, max=1e6), min=tiny))
        f = _gammainc_sel(a, x, n_iters, log_xc) - p
        logdf = (a - 1.0) * torch.log(torch.clamp(x, min=tiny)) - x - lg
        step = f * special.exp(-logdf)
        step = torch.clamp(step, -9.0 * x, 0.9 * x)
        x = x - step
    return x


def _moving_threshold(plan: FusedPlan, i: int, params):
    """Per-lane threshold of mode i under MovingThreshold (the Pallas
    body's `thr_rows`): gamma θ·P⁻¹(k, p), by the fast GL inverse
    (gl_nodes > 0) or by Newton on the series/CF P (gl_nodes = 0), with the
    percentile and Φ⁻¹(p) in the working type; exponential θ·(−log1p(−p)),
    lognormal exp(μ + σ·Φ⁻¹(p)), monodisperse θ; clamped below at 1e-18."""
    n, p1, p2 = params
    fam, c = plan.families[i], plan.thr_const[i]
    if fam == Family.MONODISPERSE:
        thr = p1
    elif fam == Family.GAMMA and plan.gl_nodes:
        thr = p1 * special.gammaincinv_gl_impl(
            p2, torch.full_like(p1, c), n_iter=3, n_nodes=plan.gl_nodes)
    elif fam == Family.GAMMA:
        thr = p1 * _gammaincinv_newton(p2, c, plan.thr_newton_iters,
                                       plan.thr_gammainc_iters)
    elif fam == Family.EXPONENTIAL:
        thr = p1 * c
    else:  # LOGNORMAL
        thr = special.exp(p1 + p2 * c)
    return torch.clamp(thr, min=1e-18)


def _gis_exact(plan: FusedPlan, thr, theta, k):
    """P(2k + s, T/θ), s = 0..2M−2 (`_f2_gamma_exact`): one incomplete gamma
    at the top order — GL with the Stirling lgamma, or series/CF with the
    Lanczos one (gl_nodes = 0) — and the clipped downward Poisson
    recurrence; `thr` is a constant or a per-lane row."""
    M = plan.M
    tiny = torch.finfo(theta.dtype).tiny
    ratio = special.rdiv(thr, theta) if isinstance(thr, float) else thr / theta
    x = torch.clamp(ratio, max=1e6)
    log_x = torch.log(torch.clamp(x, min=tiny))
    a0 = 2.0 * k
    lga01 = (special.lgamma_stirling(a0 + 1.0) if plan.gl_nodes
             else special.lgamma(a0 + 1.0))
    d = special.exp(a0 * log_x - x - lga01)
    d = special.select(x > 0.0, d, 0.0)
    ds = [d]
    prod = None
    for j in range(1, 2 * M - 2):
        ds.append(ds[-1] * x / (a0 + j))
        prod = (a0 + j) if prod is None else prod * (a0 + j)
    if plan.gl_nodes:
        gi = special.gammainc_gl(a0 + (2.0 * M - 2.0), x, n_nodes=plan.gl_nodes,
                                 gln=lga01 + torch.log(prod))
    else:
        gi = _gammainc_sel(a0 + (2.0 * M - 2.0), x, plan.gammainc_iters, log_x)
    gis = [gi]
    for j in range(2 * M - 3, -1, -1):
        gi = torch.clamp(gi + ds[j], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()
    return gis


def _moving_grid(plan: FusedPlan, thr):
    """Per-lane quadrature grid of a MovingThreshold mode (`_moving_grid`):
    ([G, B] nodes, [G, B] weights, dx). "gauss": the GL base nodes mapped
    onto [log(1e-5·min(T, 1)), log T], dx = 1; "reference": the masked
    Simpson grid of `n_points_max` points over [log min(1e-5, 1e-5·T),
    log T] with nb = min(⌊15·log10(T/x_lo)⌋, G − 1) bins (log10 as
    `jnp.log10`: log times 1/ln 10 in the working type), dx a row."""
    dtype, dev = thr.dtype, thr.device
    if plan.quad_rule == "gauss":
        u, wu = np.polynomial.legendre.leggauss(plan.gauss_nodes)
        u = torch.as_tensor(u, dtype=dtype, device=dev)[:, None]
        wu = torch.as_tensor(wu, dtype=dtype, device=dev)[:, None]
        x_lo = 1e-5 * torch.clamp(thr, max=1.0)
        a, b = torch.log(x_lo), torch.log(thr)
        x = special.exp(a + 0.5 * (b - a) * (u + 1.0))
        return x, 0.5 * (b - a) * wu, 1.0
    G = plan.n_points_max
    j = torch.arange(G, dtype=dtype, device=dev)[:, None] + 1.0
    x_lo = torch.minimum(torch.tensor(1e-5, dtype=dtype, device=dev), 1e-5 * thr)
    ratio = torch.log(thr / x_lo) * 0.4342944819032518
    nb = torch.clamp(torch.floor(15.0 * ratio), max=float(G - 1))
    x_min = torch.log(x_lo)
    dx = (torch.log(thr) - x_min) / nb
    x = special.exp(x_min + (j - 1.0) * dx)
    w = ((j >= 5.0) & (j <= nb - 3.0)).to(dtype)
    for jj, c in ((1.0, 17.0), (2.0, 59.0), (3.0, 43.0), (4.0, 49.0)):
        w = w + special.select(j == jj, c / 48.0, torch.zeros_like(w))
    e = nb + 1.0
    for off, c in ((0.0, 17.0), (1.0, 59.0), (2.0, 43.0), (3.0, 49.0)):
        w = w + special.select(j == e - off, c / 48.0, torch.zeros_like(w))
    return x, w * (j <= nb).to(dtype), dx


def moving_thresholds(plan: FusedPlan, mom: torch.Tensor) -> dict:
    """The twin's per-lane threshold of each thresholded mode under
    MovingThreshold, {mode: [B] row}, from normalized moments ``[n_tot, B]``
    (for reports: the kernels compute their own)."""
    eps = torch.finfo(mom.dtype).eps
    out = {}
    for i, fam in enumerate(plan.families):
        if plan.moving and plan.thr_flag[i]:
            o = plan.offsets[i]
            params = _invert_rows(fam, list(mom[o:o + plan.nprog[i]]), eps)
            out[i] = _moving_threshold(plan, i, params)
    return out


def moving_bins(thr: torch.Tensor) -> torch.Tensor:
    """The moving Simpson grid's bin count per lane, nb (before the cap at
    G − 1), in the order the twin and the kernels compute it."""
    x_lo = torch.minimum(torch.tensor(1e-5, dtype=thr.dtype, device=thr.device),
                         1e-5 * thr)
    return torch.floor(15.0 * (torch.log(thr / x_lo) * 0.4342944819032518))


def _quad_grid(plan: FusedPlan, i: int, thr, like):
    """(x, w, dx, T) of thresholded mode i's F2 grid in `like`'s type and
    device: the per-lane moving grid (`_moving_grid`), or the mode's packed
    fixed grid as [G, 1] columns with its threshold as a tensor."""
    if plan.moving:
        return (*_moving_grid(plan, thr), thr)
    xg, wg, dx = plan.grids[i]
    x, w = (torch.tensor(v, dtype=like.dtype, device=like.device)[:, None] for v in (xg, wg))
    return x, w, dx, torch.tensor(thr, dtype=like.dtype, device=like.device)


def _erf_sel(z, n_iters: int):
    """`special.erf_impl` (sign(z)·P(½, z²)) with the series/CF incomplete
    gamma evaluated only where each lane selects it (`_gammainc_sel`)."""
    x = z * z
    log_x = torch.log(torch.clamp(torch.clamp(x, max=1e6), min=torch.finfo(z.dtype).tiny))
    half = torch.full((1,) * z.ndim, 0.5, dtype=z.dtype, device=z.device)
    return torch.sign(z) * _gammainc_sel(half, x, n_iters, log_x)


def _f2_gamma_grid(plan: FusedPlan, i: int, thr, n, theta, k):
    """Unclamped gamma/exponential F2 {(p, q): row}, p ≤ q < M, on a
    quadrature grid (`_f2_gamma`): Poisson deltas from the Lanczos
    lgamma(k + 1), the top-order incomplete gamma (GL, or series/CF at
    `gammainc_iters`) and the clipped downward recurrence, integrand rows
    exp(k·log x − x·(1/θ))·w, multiplicative prefactors n²θ^{q−k}Γ(q+k)/Γ(k)²,
    the sums over the nodes (`torch.sum` over [G, B] tiles, as `jnp.sum`)
    times dx."""
    tiny = torch.finfo(theta.dtype).tiny
    M = plan.M
    x, w, dx, thr = _quad_grid(plan, i, thr, theta)
    logx = torch.log(x)
    inv_theta = 1.0 / theta
    rem = torch.clamp(thr - x, min=0.0) * inv_theta
    log_rem = torch.log(torch.clamp(rem, min=tiny))
    delta = special.exp(k * log_rem - rem - special.lgamma(k + 1.0))
    delta = special.select(rem > 0.0, delta, 0.0)
    deltas = [delta]
    for q in range(1, M - 1):
        deltas.append(deltas[-1] * rem / (k + q))
    if plan.gl_nodes:
        gi = special.gammainc_gl(k + (M - 1.0), rem, n_nodes=plan.gl_nodes)
    else:
        gi = _gammainc_sel(k + (M - 1.0), rem, plan.gammainc_iters, log_rem)
    gis = [gi]
    for q in range(M - 2, -1, -1):
        gi = torch.clamp(gi + deltas[q], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()
    base = special.exp(k * logx - x * inv_theta) * w
    lgk = special.lgamma(k)
    logth = torch.log(theta)
    prefs = [(n * n) * special.exp(-k * logth - lgk)]
    for q in range(1, M):
        prefs.append(prefs[-1] * theta * (k + q - 1.0))
    out = {}
    ypow = base
    for p in range(M):
        if p > 0:
            ypow = ypow * x
        for q in range(p, M):
            out[(p, q)] = torch.sum(ypow * gis[q], dim=0) * dx * prefs[q]
    return out


def _f2_lognormal_grid(plan: FusedPlan, i: int, thr, n, mu, sig):
    """Unclamped lognormal F2 {(p, q): row}, p ≤ q < M, on a quadrature grid
    by the exact Φ partial moments (`_f2_lognormal`, pallas_coalescence.py:
    458-496): density rows fx = exp(−(log x − μ)²/(2σ²))/(x·σ·√(2π)), the
    partial moments exp(qμ + q²σ²/2)·½(1 + erf(z)) at z = (log(T − x) − μ −
    qσ²)/(σ√2) with erf by the series/CF P(½, z²) at `gammainc_iters`
    (gl_nodes = 0) or the rational `erf_approx`, integrand rows x·fx·w·x^p,
    the sums over the nodes times dx, times n²."""
    tiny = torch.finfo(mu.dtype).tiny
    M = plan.M
    x, w, dx, thr = _quad_grid(plan, i, thr, mu)
    logx = torch.log(torch.clamp(x, min=tiny))
    s2 = sig * sig
    du = logx - mu
    fx = special.exp(-(du * du) / (2.0 * s2)) / (x * sig * float(np.sqrt(2.0 * np.pi)))
    rem = torch.clamp(thr - x, min=0.0)
    logrem = torch.log(torch.clamp(rem, min=tiny))
    pms = []
    for q in range(M):
        z = (logrem - mu - q * s2) / (sig * float(np.sqrt(2.0)))
        erf_z = (special.erf_approx(z) if plan.gl_nodes
                 else _erf_sel(z, plan.gammainc_iters))
        pm = special.exp(q * mu + 0.5 * q ** 2 * s2) * 0.5 * (1.0 + erf_z)
        pms.append(special.select(rem > 0.0, pm, 0.0))
    n2 = n * n
    out = {}
    ypow = x * fx * w
    for p in range(M):
        if p > 0:
            ypow = ypow * x
        for q in range(p, M):
            out[(p, q)] = torch.sum(ypow * pms[q], dim=0) * dx * n2
    return out


def _f2_lognormal_window(plan: FusedPlan, thr, n, mu, sig):
    """Unclamped lognormal F2 {(p, q): row}, p ≤ q, by the recentred GL
    window rule (`_f2_lognormal_window`), accumulated node by node as the
    kernels do (the Pallas body sums the nodes with `jnp.sum`)."""
    dtype = mu.dtype
    tiny = torch.finfo(dtype).tiny
    M = plan.M
    if isinstance(thr, float):
        thr = torch.tensor(thr, dtype=dtype, device=mu.device)
    vg, wg = np.polynomial.legendre.leggauss(plan.win_nodes)
    s2 = sig * sig
    lo = mu - LOGNORM_WINDOW_SIGMA * sig
    hi = torch.minimum(torch.log(torch.clamp(thr, min=tiny)),
                       mu + M * s2 + LOGNORM_WINDOW_SIGMA * sig)
    half = torch.clamp(hi - lo, min=0.0) * 0.5
    center = lo + half
    two_s2 = 2.0 * s2
    sig_c = sig * float(np.sqrt(2.0 * np.pi))
    sig_r2 = sig * float(np.sqrt(2.0))
    e_q = [special.exp(q * mu + 0.5 * q ** 2 * s2) for q in range(M)]
    acc = {}
    for vj, wj in zip(vg.tolist(), wg.tolist()):
        u = center + half * vj
        x = special.exp(u)
        du = u - mu
        g0 = half * wj * special.exp(-(du * du) / two_s2) / sig_c
        rem = torch.clamp(thr - x, min=0.0)
        logrem = torch.log(torch.clamp(rem, min=tiny))
        pm = []
        for q in range(M):
            z = (logrem - mu - q * s2) / sig_r2
            v = e_q[q] * 0.5 * (1.0 + special.erf_approx(z))
            pm.append(special.select(rem > 0.0, v, 0.0))
        ypow = g0
        for p in range(M):
            if p > 0:
                ypow = ypow * x
            for q in range(p, M):
                term = ypow * pm[q]
                acc[(p, q)] = term if (p, q) not in acc else acc[(p, q)] + term
    n2 = n * n
    return {key: v * n2 for key, v in acc.items()}


def _coal_body_rows(plan: FusedPlan, mom_rows):
    """The shared physics on NORMALIZED rows: closure → integer moments →
    thresholds → F2 (exact gamma, a gamma or lognormal quadrature grid, the
    lognormal window, or the monodisperse closed form) → clamp → Q/R/S
    sparse FMAs. Returns (acc, params); acc[o] is
    None where no term lands."""
    dtype = mom_rows[0].dtype
    eps = torch.finfo(dtype).eps
    M = plan.M
    params, mf, gis, tab, below = [], [], {}, {}, {}
    for i, fam in enumerate(plan.families):
        o = plan.offsets[i]
        n, p1, p2 = _invert_rows(fam, mom_rows[o:o + plan.nprog[i]], eps)
        params.append((n, p1, p2))
        rows = [n]
        m = n
        for q in range(M - 1):
            if fam == Family.EXPONENTIAL:
                m = m * p1 * (q + 1.0)
            elif fam == Family.GAMMA:
                m = m * p1 * (p2 + q)
            elif fam == Family.MONODISPERSE:
                m = m * p1
            else:  # LOGNORMAL
                m = m * special.exp(p1 + (2.0 * q + 1.0) * 0.5 * (p2 * p2))
            rows.append(m)
        mf.append(rows)
        if not plan.thr_flag[i]:
            continue
        thr = (_moving_threshold(plan, i, params[i]) if plan.moving
               else plan.thr_const[i])
        kk = p2 if fam == Family.GAMMA else torch.ones_like(p1)
        kind = plan.f2_kind[i]
        if kind == F2_MONO:
            # closed form (pallas_coalescence.py:556-568): M_p·M_q where
            # θ < T/2, else 0; T rounded to the type once, halved exactly
            if isinstance(thr, float):
                thr = torch.tensor(thr, dtype=dtype, device=p1.device)
            below[i] = p1 < thr / 2.0
        elif kind == F2_WINDOW:
            tab[i] = _f2_lognormal_window(plan, thr, n, p1, p2)
        elif kind == F2_GRID and fam == Family.LOGNORMAL:
            tab[i] = _f2_lognormal_grid(plan, i, thr, n, p1, p2)
        elif kind == F2_GRID:
            tab[i] = _f2_gamma_grid(plan, i, thr, n, p1, kk)
        else:
            gis[i] = _gis_exact(plan, thr, p1, kk)

    f2_cache = {}

    def f2(k, a, b):
        key = (k, a, b)
        if key not in f2_cache:
            mm = mf[k][a] * mf[k][b]
            if k in gis:
                val = torch.minimum(mm, mm * gis[k][a + b])
            elif k in below:
                val = torch.minimum(mm, special.select(below[k], mm, 0.0))
            elif k in tab:
                val = torch.minimum(mm, tab[k][(a, b)])
            else:
                val = mm
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
    closure parameters (`_sedi_flux_rows`; the gamma base by ``fast_ratio``
    where gl_nodes > 0, the Lanczos-lgamma pair where gl_nodes = 0; the
    monodisperse ladder n·θ^e, t·θ)."""
    out = [None] * plan.n_tot
    for i, fam in enumerate(plan.families):
        n, p1, p2 = params[i]
        logp1 = torch.log(torch.clamp(p1, min=torch.finfo(p1.dtype).tiny))
        flux = [None] * plan.nprog[i]
        for (c, e) in plan.vel_n:
            if fam == Family.GAMMA and plan.gl_nodes:
                t = n * special.exp(e * logp1) * special.gamma_ratio(p2, e)
            elif fam == Family.GAMMA:
                t = n * special.exp(e * logp1 + special.lgamma(p2 + e)
                                    - special.lgamma(p2))
            elif fam == Family.EXPONENTIAL:
                t = n * math.gamma(1.0 + e) * special.exp(e * logp1)
            elif fam == Family.MONODISPERSE:
                t = n * special.exp(e * logp1)
            for m in range(plan.nprog[i]):
                q = m + e
                if fam == Family.LOGNORMAL:
                    t = n * special.exp(q * p1 + 0.5 * q * q * p2 * p2)
                elif m > 0:
                    if fam == Family.GAMMA:
                        t = t * p1 * (p2 + (m - 1.0) + e)
                    elif fam == Family.MONODISPERSE:
                        t = t * p1
                    else:
                        t = t * p1 * q
                term = c * t
                flux[m] = term if flux[m] is None else flux[m] + term
        for m in range(plan.nprog[i]):
            out[plan.offsets[i] + m] = -flux[m]
    return out


def _rhs_rows(plan: FusedPlan, y_rows):
    """One per-level RHS on physical rows: clip negatives, normalize, empty
    mask, coalescence and flux, both denormalized (B4's rows)."""
    eps = torch.finfo(y_rows[0].dtype).eps
    mom_rows, empty = [], None
    for o in range(plan.n_tot):
        r = torch.clamp(y_rows[o], min=0.0) * (1.0 / plan.mom_norms[o])
        mom_rows.append(r)
        lo = r < eps
        empty = lo if empty is None else (empty & lo)
    acc, params = _coal_body_rows(plan, mom_rows)
    flux = _sedi_flux_rows(plan, params)
    zero = torch.zeros_like(y_rows[0])
    coal = [torch.where(empty, zero, zero if acc[o] is None else acc[o])
            * plan.mom_norms[o] for o in range(plan.n_tot)]
    return coal, [flux[o] * plan.mom_norms[o] for o in range(plan.n_tot)]


def coal_soa_plain(mom: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Plain twin of the coalescence kernel: normalized ``[n_tot, B]`` →
    tendencies ``[n_tot, B]``."""
    acc, _ = _coal_body_rows(plan, [mom[o] for o in range(plan.n_tot)])
    zero = torch.zeros_like(mom[0])
    return torch.stack([zero if a is None else a for a in acc])


def rainshaft_rhs_soa_plain(mom: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Plain twin of the fused per-level RHS kernel: physical ``[n_tot, B]``
    → ``[2·n_tot, B]``, the physical coalescence tendencies over the
    physical sedimentation fluxes."""
    coal, flux = _rhs_rows(plan, [mom[o] for o in range(plan.n_tot)])
    return torch.stack(coal + flux)


def rainshaft_step_soa_plain(mom: torch.Tensor, plan: FusedPlan,
                             scale: torch.Tensor = None) -> torch.Tensor:
    """Plain twin of the whole-step kernel: physical ``[n_tot, B]`` state →
    the state one SSPRK33 step of length ``plan.dt`` later. A ``[B]`` `scale`
    row multiplies each RHS evaluation's coalescence rows after the empty
    mask and the denormalisation, before the flux divergence."""
    n_tot, nz = plan.n_tot, plan.nz
    B = mom.shape[1]
    if B % nz != 0:
        raise ValueError(f"B={B} is not a multiple of nz={nz}")
    top = (torch.arange(B, device=mom.device) % nz) == (nz - 1)
    zero = torch.zeros_like(mom[0])

    def shift_up(row):
        # level i's upstream flux F[i+1]; zero influx at each column's top
        return torch.where(top, zero, torch.roll(row, -1))

    def rhs(y_rows):
        coal, flux = _rhs_rows(plan, y_rows)
        if scale is not None:
            coal = [c * scale for c in coal]
        return [coal[o] - (shift_up(flux[o]) - flux[o]) * plan.inv_dz
                for o in range(n_tot)]

    dt = plan.dt
    y = [mom[o] for o in range(n_tot)]
    f0 = rhs(y)
    u1 = [y[o] + dt * f0[o] for o in range(n_tot)]
    f1 = rhs(u1)
    u2 = [0.75 * y[o] + 0.25 * (u1[o] + dt * f1[o]) for o in range(n_tot)]
    f2 = rhs(u2)
    return torch.stack(
        [special.div(y[o], 3.0) + (2.0 / 3.0) * (u2[o] + dt * f2[o]) for o in range(n_tot)]
    )


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _launching(entry):
    """A wrapper's entry point on a state ``mom``, inside a ``launch`` span
    (`utils.metrics.span`) while the recorder is on and ``mom`` lies on the
    card: the wrapper's host work from its entry to the return of the launch
    call. The span carries the kernel's `label` (its unit's label or the
    prebuilt library's entry point). The plain twin launches nothing and
    records no span."""

    @functools.wraps(entry)
    def call(self, mom, *args):
        if not metrics.recording() or mom.device.type != "cuda":
            return entry(self, mom, *args)
        with metrics.span("launch") as attrs:
            out = entry(self, mom, *args)
        if attrs is not None:
            attrs["label"] = self.kernel
        return out

    return call


class _KernelFn:
    """Dispatch shared by the kernel wrappers: the plain twin for a CPU
    tensor, the CUDA kernel for a CUDA tensor; `launches` counts kernel
    launches and `kernel` is the label of the last one launched. A subclass
    names its entry point (`_name`), may pack its own configuration
    (`_pack`) and puts each entry point on a state under `_launching`."""

    _name = ""
    #: whether the kernel stops the lower series early (`series_exit`)
    series_exit = False

    def __init__(self, plan, device, dtype: torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, not {dtype}")
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device (torch.cuda.is_available() is False): the "
                    "kernel runs on the card only; ask for device='cpu' to run "
                    "its plain twin"
                )
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.plan = plan
        self.device = device
        self.dtype = dtype
        self.launches = 0
        self.kernel = None
        self._cfg = None
        #: the kernel a CUDA call launches: "table" (csrc/fused_coalescence.cu)
        #: or "generated" (`ops.codegen`)
        self.route = "table"

    @property
    def _tag(self) -> str:
        return "f32" if self.dtype == torch.float32 else "f64"

    @property
    def _symbol(self) -> str:
        return f"{self._name}_{self._tag}"

    def _pack(self) -> np.ndarray:
        return pack_config(self.plan, self.dtype)

    def _smem_bytes(self, cfg_bytes: int) -> int:
        """Dynamic shared memory of one launch with a packed configuration
        of `cfg_bytes`: the configuration alone, unless the kernel adds rows
        of its own."""
        return cfg_bytes

    def _config(self) -> torch.Tensor:
        """The packed configuration on the card, packed and checked against
        the card's opt-in limit of shared memory per block once."""
        if self._cfg is None:
            buf = self._pack()
            need = self._smem_bytes(buf.size)
            from cloudy_tpu_torch.ops import _build

            limit = _build.device_smem_optin(self.device.index)
            if need > limit:
                raise RuntimeError(
                    f"{type(self).__name__}: a block needs {need} bytes of shared memory "
                    f"({buf.size} of them the packed configuration: quadrature grids, "
                    f"weight tables), more than the {limit} a block of this card may opt "
                    "into (cudaDevAttrMaxSharedMemoryPerBlockOptin); fewer modes, "
                    "nodes or grid points fit")
            self._cfg = torch.from_numpy(buf).to(self.device)
        return self._cfg

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

    def _done(self, err: int, label: str, error_string) -> None:
        if err != 0:
            raise RuntimeError(
                f"{label} launch failed: cudaError {err} ({error_string(err).decode()})")
        self.launches += 1
        self.kernel = label

    def _launch(self, mom: torch.Tensor, n_out: int, *extra, symbol: str = None,
                lib=None, error_string=None, label: str = None) -> torch.Tensor:
        """Launch a table-driven kernel on ``[n_tot, B]`` into a new
        ``[n_out, B]``: entry point `symbol` (default `_symbol`) of `lib`
        (default the prebuilt library; a unit built at first use gives its
        own `error_string` and its `label`); `extra` are the entry point's
        arguments between B and the stream."""
        from cloudy_tpu_torch.ops import _build

        if lib is None:
            lib = _build.load_library()
            error_string = lib.cloudy_error_string
        symbol = symbol or self._symbol
        cfg = self._config()
        out = torch.empty((n_out, mom.shape[1]), dtype=mom.dtype, device=mom.device)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = getattr(lib, symbol)(
                mom.data_ptr(), out.data_ptr(), cfg.data_ptr(), cfg.numel(),
                mom.shape[1], *extra, stream,
            )
        self._done(err, label or symbol, error_string)
        return out


#: the kernels of a reference-tier unit built at first use, by the wrapper
#: kind and layout that launch them (csrc/fused_coalescence.cu REF_*)
REF_KINDS = ("coal", "warp", "rhs", "step", "step_scaled")


class _GeneratedFn(_KernelFn):
    """A wrapper whose plans launch the kernel generated for the
    configuration (`ops.codegen`), except where its kind's reference tier
    is table-driven (`_ref_generated` False: B3), whose reference-tier
    plans launch the table-driven instance: the prebuilt library's within
    its capacities (`CAPS`), else a unit built at first use at the plan's
    (`plan_caps`, `codegen.ref_unit`); the route follows from the plan
    alone. `_table` (private) forces the table-driven instance (the fast
    one exists at the prebuilt capacities only): the same-call yardstick of
    `chip_smoke.py`, reached by no public entry point."""

    _kind = ""
    _scaled = False
    #: whether a reference-tier plan runs a generated unit
    _ref_generated = True

    def __init__(self, plan, device, dtype: torch.dtype, _table: bool = False):
        super().__init__(plan, device, dtype)
        table = _table or (plan.ref and not self._ref_generated)
        self.route = "table" if table else "generated"
        #: the table-driven capacities (None on the generated route)
        self.caps = plan_caps(plan) if self.route == "table" else None
        if _table and not plan.ref and self.caps != CAPS:
            raise ValueError(
                f"the table-driven fast instances exist at the prebuilt capacities {CAPS} "
                f"only; this plan needs {self.caps} (its route is the generated kernel)")
        self._unit = None
        self._ref_units = {}

    @property
    def series_exit(self) -> bool:
        """A generated reference-tier unit stops the lower series early
        (`codegen` ``kSeriesExit``); a table-driven instance runs every
        term."""
        return self.route == "generated" and self.plan.ref

    @property
    def unit(self):
        """The generated build unit of this wrapper's kernel
        (`codegen.Unit`); None on the table-driven route."""
        if self.route != "generated":
            return None
        if self._unit is None:
            from cloudy_tpu_torch.ops import codegen

            self._unit = codegen.unit(self.plan, self.dtype, self._kind, scaled=self._scaled)
        return self._unit

    def ref_unit(self, kind: str):
        """The reference-tier unit of kernel `kind` (`REF_KINDS`) at this
        plan's capacities; None where the prebuilt library holds the
        kernel."""
        if self.route != "table" or self.caps == CAPS:
            return None
        if kind not in self._ref_units:
            from cloudy_tpu_torch.ops import codegen

            self._ref_units[kind] = codegen.ref_unit(self.caps, self.dtype, kind)
        return self._ref_units[kind]

    def build_units(self) -> list:
        """Every unit built at first use that a CUDA call of this wrapper
        may launch (to build several at once: `_build.build_generated`)."""
        if self.route == "generated":
            return [self.unit]
        return [u for u in (self.ref_unit(k) for k in self._ref_kinds()) if u is not None]

    def _ref_kinds(self):
        return (self._kind,)

    def _launch_generated(self, mom: torch.Tensor, n_out: int, scale=None) -> torch.Tensor:
        from cloudy_tpu_torch.ops import _build

        lib = _build.load_generated(self.unit)
        out = torch.empty((n_out, mom.shape[1]), dtype=mom.dtype, device=mom.device)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = lib.cloudy_gen_launch(mom.data_ptr(), out.data_ptr(), mom.shape[1],
                                        None if scale is None else scale.data_ptr(), stream)
        self._done(err, self.unit.label, lib.cloudy_gen_error_string)
        return out

    def _launch_ref(self, mom: torch.Tensor, n_out: int, kind: str, nz: int = 0,
                    scale=None) -> torch.Tensor:
        """Launch kernel `kind` of the reference-tier unit at this plan's
        capacities (built at first use)."""
        from cloudy_tpu_torch.ops import _build

        unit = self.ref_unit(kind)
        lib = _build.load_ref(unit)
        return self._launch(mom, n_out, nz, None if scale is None else scale.data_ptr(),
                            symbol="cloudy_ref_launch", lib=lib,
                            error_string=lib.cloudy_ref_error_string, label=unit.label)

def coal_layout(plan: FusedPlan, B: int, n_sm: int, threads_per_sm: int) -> str:
    """The coalescence kernel's layout for `plan` at `B` boxes on a card of
    `n_sm` multiprocessors, where the reference tier's thread-per-box
    instance keeps `threads_per_sm` threads resident on each (its
    occupancy): ``"warp"`` (a warp per box, the quadrature grid's nodes
    strided across its lanes) for a reference-tier plan with a grid F2 while
    B ≤ n_sm · threads_per_sm, else ``"thread"`` (a thread per box; a plan
    without a grid has no node loop to share out). Up to one full wave a
    thread per box takes one lane's serial walk over the grid whatever B
    is, 14-31× as long as a warp per box takes; past that wave the 32× as
    many threads a warp per box needs queue up.

    The bound is that model, not the measured crossover, which moves with
    the type and the grid's node count. Measured on an H100 80GB HBM3 at
    700 W (`chip_smoke.py` phase 24, PERF.md §6) at the `rainshaft_128`
    configuration (76 Simpson nodes), the model picks the slower layout in
    f64 at 32,768 boxes (the warp, 0.91×) and in f32 at 131,072-262,144
    (the thread, 1.30-1.36× slower); elsewhere it picks the faster one,
    with bench.py's 12-node grid at 2^20 boxes too (the thread, 13×)."""
    if not plan.ref or F2_GRID not in plan.f2_kind:
        return "thread"
    return "warp" if B <= n_sm * threads_per_sm else "thread"


class CoalFn(_GeneratedFn):
    """Coalescence RHS (replaces `make_pallas_coal_fn`): ``fn(mom [B, n_tot])``
    and ``fn.soa(mom [n_tot, B])`` on normalized moments. A fast-tier plan
    launches the kernel generated for it (`route` ``"generated"``), a
    reference-tier plan the table-driven one, laid out per call by
    `coal_layout` from B and the card (`layout`): a thread per box, or a
    warp per box at small batches. `_layout` (private) forces one: the
    same-call yardstick of `chip_smoke.py`."""

    _name = "cloudy_coal"
    _kind = "coal"
    _ref_generated = False

    def __init__(self, plan, device, dtype: torch.dtype, _table: bool = False,
                 _layout: str = None):
        super().__init__(plan, device, dtype, _table)
        if _layout not in (None, "thread", "warp"):
            raise ValueError(f"layout must be 'thread' or 'warp', not {_layout!r}")
        self._layout = _layout
        self._slots = None

    def _ref_kinds(self):
        return ("coal", "warp") if F2_GRID in self.plan.f2_kind else ("coal",)

    def layout(self, B: int) -> str:
        """The layout of a launch on `B` boxes: ``"warp"`` or ``"thread"``
        (`coal_layout`; always ``"thread"`` on the fast tier and on the
        CPU)."""
        if not self.plan.ref or self.device.type != "cuda":
            return "thread"
        return self._layout or coal_layout(self.plan, B, *self.slots())

    def slots(self) -> Tuple[int, int]:
        """(multiprocessors, resident threads per multiprocessor of the
        reference thread-per-box instance) on this wrapper's card, from the
        runtime (cudaDeviceGetAttribute, the occupancy calculator at this
        configuration's shared memory)."""
        if self._slots is None:
            import ctypes

            from cloudy_tpu_torch.ops import _build

            lib = _build.load_library()
            n_sm, threads = ctypes.c_int(0), ctypes.c_int(0)
            cfg_bytes = self._config().numel()  # packed and checked against the card
            with torch.cuda.device(self.device):
                err = lib.cloudy_device_sms(self.device.index, ctypes.byref(n_sm))
                if self.caps == CAPS:
                    query = getattr(lib, f"cloudy_coal_ref_threads_per_sm_{self._tag}")
                else:
                    query = _build.load_ref(self.ref_unit("coal")).cloudy_ref_threads_per_sm
                err = err or query(cfg_bytes, ctypes.byref(threads))
            if err != 0:
                raise RuntimeError(f"occupancy query failed: cudaError {err}")
            self._slots = (n_sm.value, threads.value)
        return self._slots

    @_launching
    def soa(self, mom: torch.Tensor) -> torch.Tensor:
        self._check(mom)
        if mom.device.type == "cpu":
            return coal_soa_plain(mom, self.plan)
        n_tot = self.plan.n_tot
        if self.route == "generated":
            return self._launch_generated(mom, n_tot)
        warp = self.layout(mom.shape[1]) == "warp"
        if self.caps != CAPS:
            return self._launch_ref(mom, n_tot, "warp" if warp else "coal")
        if warp:
            return self._launch(mom, n_tot, symbol=f"cloudy_coal_warp_{self._tag}")
        return self._launch(mom, n_tot, self.plan.instance)

    def __call__(self, mom: torch.Tensor) -> torch.Tensor:
        return self.soa(mom.T.contiguous()).T

    def plain(self, mom: torch.Tensor) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        return coal_soa_plain(mom, self.plan)


#: threads per block the table-driven whole step aims at (csrc/
#: fused_coalescence.cu STEP_TARGET_THREADS): blocks of whole columns
STEP_TARGET_THREADS = 256


class RainshaftStepFn(_GeneratedFn):
    """Whole SSPRK33 rainshaft step (replaces
    `make_pallas_rainshaft_step_fn`): ``fn(mom [n_tot, B])``, physical
    moments, ``B % nz == 0``. Every plan launches the kernel generated for
    it (`route` ``"generated"``); `_table` the table-driven instance."""

    _name = "cloudy_step"
    _kind = "step"

    def __call__(self, mom: torch.Tensor) -> torch.Tensor:
        return self._step(mom, None)

    def plain(self, mom: torch.Tensor) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        return rainshaft_step_soa_plain(mom, self.plan)

    def _ref_kinds(self):
        return ("step_scaled",) if self._scaled else ("step",)

    def _smem_bytes(self, cfg_bytes: int) -> int:
        # the configuration, then the flux rows of a block of whole columns
        # (csrc/fused_coalescence.cu step_dims)
        nz = self.plan.nz
        threads = (1 if nz >= STEP_TARGET_THREADS else STEP_TARGET_THREADS // nz) * nz
        return cfg_bytes + self.caps[1] * threads * self.dtype.itemsize

    @_launching
    def _step(self, mom: torch.Tensor, scale) -> torch.Tensor:
        self._check(mom)
        nz = self.plan.nz
        if mom.shape[1] % nz != 0:
            raise ValueError(f"B={mom.shape[1]} is not a multiple of nz={nz}")
        if mom.device.type == "cpu":
            return rainshaft_step_soa_plain(mom, self.plan, scale)
        n_tot = self.plan.n_tot
        if self.route == "generated":
            return self._launch_generated(mom, n_tot, scale)
        if self.caps != CAPS:
            return self._launch_ref(mom, n_tot, self._ref_kinds()[0], nz, scale)
        extra = () if scale is None else (scale.data_ptr(),)
        return self._launch(mom, n_tot, nz, self.plan.instance, *extra)


class ScaledRainshaftStepFn(RainshaftStepFn):
    """The whole step with a per-lane kernel scale (replaces
    `make_pallas_rainshaft_step_fn(kernel_scale=True)`, its ``fn_scaled``,
    pallas_coalescence.py:1022-1056, at either tier):
    ``fn(mom [n_tot, B], scale)``. `scale` is a number, a ``[B]`` or a
    ``[1, B]`` row; each lane's coalescence tendency is multiplied by its
    entry in every RHS evaluation. Scaling by ``s`` equals building the
    configuration from the kernel tensor scaled by ``s``. Every plan
    launches the scaled kernel generated for it (a unit of its own, `route`
    ``"generated"``); `_table` forces the table-driven scaled instance
    (``cloudy_step_scaled_*``, the same-call yardstick)."""

    _name = "cloudy_step_scaled"
    _scaled = True

    def __call__(self, mom: torch.Tensor, scale) -> torch.Tensor:
        return self._step(mom, self.scale_row(mom, scale))

    def plain(self, mom: torch.Tensor, scale) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        return rainshaft_step_soa_plain(mom, self.plan, self.scale_row(mom, scale))

    @staticmethod
    def scale_row(mom: torch.Tensor, scale) -> torch.Tensor:
        """`scale` broadcast to a contiguous ``[B]`` row in the state's type
        on the state's device (pallas_coalescence.py:1026-1028)."""
        B = mom.shape[-1]
        row = torch.as_tensor(scale, dtype=mom.dtype, device=mom.device)
        return row.reshape(1, -1).expand(1, B).reshape(B).contiguous()


class RainshaftRhsFn(_GeneratedFn):
    """Fused per-level rainshaft RHS (replaces
    `make_pallas_rainshaft_rhs_fn`): ``fn.soa(mom [n_tot, B])`` on physical
    moments → ``[2·n_tot, B]``, the physical coalescence tendencies over the
    physical sedimentation fluxes. The caller applies the upwind stencil
    (`models.rainshaft.make_rainshaft_rhs_fused`). Every plan launches the
    kernel generated for it; `_table` the table-driven instance."""

    _name = "cloudy_rhs"
    _kind = "rhs"

    @_launching
    def soa(self, mom: torch.Tensor) -> torch.Tensor:
        self._check(mom)
        if mom.device.type == "cpu":
            return rainshaft_rhs_soa_plain(mom, self.plan)
        n_out = 2 * self.plan.n_tot
        if self.route == "generated":
            return self._launch_generated(mom, n_out)
        if self.caps != CAPS:
            return self._launch_ref(mom, n_out, "rhs")
        return self._launch(mom, n_out, self.plan.instance)

    def plain(self, mom: torch.Tensor) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        return rainshaft_rhs_soa_plain(mom, self.plan)


def make_coal_fn(data: CoalescenceData, device="cuda",
                 dtype: torch.dtype = torch.float32, **coal_kwargs) -> CoalFn:
    """Coalescence RHS on `device` in `dtype`; see `CoalFn`. `coal_kwargs`
    are `make_pallas_coal_fn`'s per-call overrides (`COAL_OVERRIDES`)."""
    return CoalFn(build_plan(data, **coal_kwargs), device, dtype)


def make_rainshaft_rhs_fn(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]],
    norms: Tuple[float, float],
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **coal_kwargs,
) -> RainshaftRhsFn:
    """Fused per-level rainshaft RHS on `device` in `dtype`; see
    `RainshaftRhsFn`. `vel` is the PHYSICAL power-law velocity; `coal_kwargs`
    as for `make_coal_fn`."""
    return RainshaftRhsFn(build_plan(data, vel, norms, **coal_kwargs), device, dtype)


def make_rainshaft_step_fn(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]],
    norms: Tuple[float, float],
    nz: int,
    dz: float,
    dt: float,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    kernel_scale: bool = False,
    **coal_kwargs,
) -> RainshaftStepFn:
    """Whole SSPRK33 rainshaft step on `device` in `dtype`; see
    `RainshaftStepFn`, and `ScaledRainshaftStepFn` for ``kernel_scale=True``
    (at either tier, as JAX's ``fn_scaled``). `vel` is the PHYSICAL power-law
    velocity; `coal_kwargs` as for `make_coal_fn`."""
    if nz < 2 or nz > 1024:
        raise ValueError(f"nz={nz} must lie in [2, 1024] (one block holds a column)")
    plan = build_plan(data, vel, norms, nz, dz, dt, **coal_kwargs)
    cls = ScaledRainshaftStepFn if kernel_scale else RainshaftStepFn
    return cls(plan, device, dtype)
