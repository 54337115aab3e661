"""Hand-written CUDA kernel for the direct-quadrature coalescence RHS, with
its plain PyTorch twin.

Counterpart of `cloudy_tpu.ops.pallas_numerical`: `make_numerical_fn`
(kernel ``cloudy_numerical_*`` in csrc/numerical_coalescence.cu) replaces
`make_pallas_numerical_fn`: normalized moments → coalescence tendencies by
fixed-node Gauss–Legendre quadrature of the Smoluchowski equation with a
kernel *function* K(x, y), fusing

    closure inversion → per-box support bounds → kink-aware outer log grid →
    densities → R inner integral → triangular Q/S inner integrals → gated
    moment assembly

so that a box reads ``n_tot`` values and writes ``n_tot``. The einsum path
(`coalescence_numerical.get_coal_ints_numerical`) is quadrature-identical but
holds its ``[B, G_outer, G_inner]`` intermediates in device memory. The path
needs only density evaluations, so it covers all four families and any
kernel function, as JAX's kernel does: the four of `kernels` (constant,
linear, hydrodynamic, Long) by tag, any other callable (a
`CoalescenceTensor`, a lambda, a subclass of a tagged class) by its trace
(`kernel_expr`), built into a unit of its own.

Layout: the structure-of-arrays ``[n_tot, B]``; on the card one thread block
per box, its outer nodes strided over up to 256 threads, so any node
budget runs. The prebuilt library holds the kernel at one to three modes; a
configuration of more runs a unit built at first use (`codegen.
numerical_unit`), and so does a traced kernel function (the ``KT_GEN`` arm,
its device function ``cloudy_kernel_gen`` generated from the trace). The
kernel reads one packed configuration (`NumericalPlan` → `pack_config`):
the spectrum, the node counts, the Gauss–Legendre rules, the panel cuts,
the kernel function as a tag with up to three parameters
(`kernel_descriptor`), and in f64 the logs
of the inner nodes that the kernel adds to a per-panel offset instead of
taking them per node (`inner_log_tables`). The kernel a CUDA call launches,
``quad_kernel``, runs its densities in base 2 on the card's special
function unit in f32 (IEEE exp/log in f64) with their divides hoisted per
box, and for the constant, linear and Long kernels takes R from block sums
instead of the G × G loop (the hydrodynamic kernel keeps the loop over a
node table; a traced kernel takes its separable terms as block sums and
loops over the pairs for its remainder alone, `kernel_expr.factor`;
csrc/numerical_coalescence.cu).

Beside the kernel sits its plain twin `numerical_soa_plain`: the same
operations in the Pallas body's order on ``[G, B]`` tiles (the y-loop for R,
the node loop for Q/S), in PyTorch. The wrapper runs the twin only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises. It
never falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.ops import special
from cloudy_tpu_torch.ops.fused_coalescence import _KernelFn, _invert_rows, _launching
from cloudy_tpu_torch.ops.gauss import gauss_legendre

_SQRT2PI = float(np.sqrt(2.0 * np.pi))

# The prebuilt library's modes (also the least per-mode stride of the packed
# configuration), the moment orders of a mode, the int32 header slots and the
# outer nodes of the old body's block (`_direct`: one thread each); the
# library and each unit export their layout (`cloudy_numerical_layout`,
# `cloudy_numerical_unit_layout`) and `_build` refuses one whose values
# differ from the host's `layout(n_modes)`.
MAX_MODES = 3
MAX_NMOM = 3
HEADER_INTS = 10
DIRECT_MAX_G = 256


def mode_stride(n_modes: int) -> int:
    """Int32 slots per per-mode table of the packed configuration
    (csrc/numerical_coalescence.cu `num_stride`)."""
    return max(MAX_MODES, n_modes)


def layout(n_modes: int = MAX_MODES) -> tuple:
    """(per-mode stride, moment orders, header ints) of the kernel at
    `n_modes` modes, as its library or unit exports them."""
    return (mode_stride(n_modes), MAX_NMOM, HEADER_INTS)


LAYOUT = layout()

#: kernel-function classes the CUDA kernel evaluates, by tag (the kernel's
#: KT_* constants), with the dataclass fields it reads as k0..k2
KERNEL_TAGS = (
    (K.ConstantKernelFunction, ("coll_coal_rate",)),
    (K.LinearKernelFunction, ("coll_coal_rate",)),
    (K.HydrodynamicKernelFunction, ("coal_eff",)),
    (K.LongKernelFunction, ("x_threshold", "coal_rate_below_threshold",
                            "coal_rate_above_threshold")),
)


#: the hydrodynamic kernel's tag (csrc KT_HYDRO) and a traced kernel
#: function's (KT_GEN): their launches add each outer node's radius (or
#: its factored remainder's tabled y values) and WX·F_j to the block's
#: shared memory
KT_HYDRO = 2
KT_GEN = 4


def kernel_descriptor(kernel_func) -> Tuple[int, Tuple[float, float, float]]:
    """(tag, (k0, k1, k2)) of an already normalized kernel function: an
    instance whose type is exactly one of `KERNEL_TAGS` gets its tag and
    fields; any other callable (a `CoalescenceTensor`, a lambda, a subclass
    of a tagged class, whose own ``__call__`` JAX's kernel would call) is
    ``KT_GEN``, evaluated from its trace (`kernel_expr`)."""
    for tag, (cls, fields) in enumerate(KERNEL_TAGS):
        if type(kernel_func) is cls:
            vals = [float(getattr(kernel_func, f)) for f in fields]
            return tag, tuple(vals + [0.0] * (3 - len(vals)))
    return KT_GEN, (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class NumericalPlan:
    """Host-side tables of one configuration, shared by the CUDA kernel
    (packed by `pack_config`) and the plain twin."""

    families: Tuple[int, ...]
    offsets: Tuple[int, ...]
    nprog: Tuple[int, ...]
    #: the normalized kernel function, its tag and parameters
    kernel_func: K.KernelFunction
    ktag: int
    kpar: Tuple[float, float, float]
    #: the kernel's kink (at most one), or ()
    kinks: Tuple[float, ...]
    #: outer panels and GL nodes per panel; inner panels and nodes per panel
    n_po: int
    g_outer: int
    n_pi: int
    g_inner: int

    @property
    def n_tot(self) -> int:
        return sum(self.nprog)

    @property
    def n_modes(self) -> int:
        return len(self.families)

    @property
    def n_mom(self) -> int:
        return max(self.nprog)

    @property
    def g_total(self) -> int:
        return self.n_po * self.g_outer

    @property
    def outer_cuts(self) -> Tuple[float, ...]:
        return tuple(sorted({c for t in self.kinks for c in (t, 2.0 * t)}))


def build_plan(spec: SpectrumSpec, kernel_func, n_outer: int = 96,
               n_inner: int = 48) -> NumericalPlan:
    """Tables of one configuration. ``n_outer``/``n_inner`` are total node
    budgets, divided evenly among the kink-aware panels: a kinked kernel
    (Long) splits the outer budget into 3 panels and the inner into 3, at
    least 8 nodes each."""
    kinks = tuple(float(t) for t in getattr(kernel_func, "x_kinks", ()))
    if len(kinks) > 1:
        raise NotImplementedError("the quadrature kernel supports <=1 kink")
    ktag, kpar = kernel_descriptor(kernel_func)
    n_po = 2 * len(kinks) + 1
    n_pi = 2 * len(kinks) + 1
    g_outer = max(n_outer // n_po, 8) if kinks else n_outer
    g_inner = max(n_inner // n_pi, 8) if kinks else n_inner
    return NumericalPlan(
        families=tuple(int(f) for f in spec.families),
        offsets=spec.offsets,
        nprog=spec.nprogmoms,
        kernel_func=kernel_func,
        ktag=ktag,
        kpar=kpar,
        kinks=kinks,
        n_po=n_po,
        g_outer=g_outer,
        n_pi=n_pi,
        g_inner=g_inner,
    )


def _rules(plan: NumericalPlan):
    """(xu, wu, s01, w01, log_cuts) in double: the outer rule on [−1, 1], the
    inner rule mapped to (0, 1), and the logs of the outer cuts, each rounded
    once to the working type by its user."""
    xu, wu = gauss_legendre(plan.g_outer)
    su, ws = gauss_legendre(plan.g_inner)
    return (np.asarray(xu), np.asarray(wu), 0.5 * (np.asarray(su) + 1.0),
            0.5 * np.asarray(ws), np.log(np.asarray(plan.outer_cuts, np.float64)))


def inner_log_tables(s01):
    """(log s, log(1 − s)) of the inner nodes s01 in f64 (s rounded once,
    1 − s formed in f64 as the twin forms it), natural logs taken in host
    double. `quad_kernel` in f64 adds them to a per-panel offset instead of
    taking two logs per inner node; in f32 it takes them at the node (the
    SFU's log2 is quicker there than the table read), so f32 packs none."""
    s = np.asarray(s01, np.float64)
    return np.log(s), np.log(1.0 - s)


def pack_config(plan: NumericalPlan, dtype: torch.dtype) -> np.ndarray:
    """The byte buffer the kernel reads (layout:
    csrc/numerical_coalescence.cu, `NumConfig::bind`)."""
    real_t = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    xu, wu, s01, w01, log_cuts = _rules(plan)
    tables = inner_log_tables(s01) if dtype == torch.float64 else ()

    def per_mode(vals):
        return list(vals) + [0] * (mode_stride(plan.n_modes) - len(vals))

    ints = [plan.n_modes, plan.n_tot, plan.n_mom, plan.n_po, plan.g_outer,
            plan.n_pi, plan.g_inner, plan.ktag, 0, 0]  # slot 8: real offset
    ints += per_mode(plan.families) + per_mode(plan.offsets) + per_mode(plan.nprog)
    if len(ints) % 2:
        ints.append(0)  # 8-byte align the real section
    real_offset = 4 * len(ints)
    ints[8] = real_offset

    reals = list(plan.kpar) + [plan.kinks[0] if plan.kinks else 0.0]
    reals += list(log_cuts) + [0.0] * (2 - len(log_cuts))
    reals += list(xu) + list(wu) + list(s01) + list(w01)
    for t in tables:
        reals += list(t)
    total = real_offset + np.dtype(real_t).itemsize * len(reals)
    total += (-total) % 16
    buf = np.zeros(total, np.uint8)
    buf[:real_offset] = np.asarray(ints, np.int32).view(np.uint8)
    rb = np.asarray(reals, np.float64).astype(real_t).view(np.uint8)
    buf[real_offset:real_offset + rb.size] = rb
    return buf


# --------------------------------------------------------------------------
# plain twin (the Pallas body's arithmetic on [G, B] tiles)
# --------------------------------------------------------------------------


def _bounds_rows(fam: int, n, p1, p2):
    """Per-mode support bounds on rows (`_bounds_rows`; mirrors
    `coalescence_numerical.support_bounds`)."""
    if fam == Family.EXPONENTIAL:
        lo, hi = p1 * 1e-8, p1 * 40.0
    elif fam == Family.GAMMA:
        log_eps = torch.log(torch.tensor(1e-12, dtype=p1.dtype, device=p1.device))
        lo = p1 * torch.exp(log_eps / torch.clamp(p2, min=0.05))
        lo = torch.maximum(lo, p1 * 1e-12)
        hi = p1 * (p2 + 30.0 * torch.sqrt(p2) + 40.0)
    elif fam == Family.LOGNORMAL:
        lo, hi = torch.exp(p1 - 8.0 * p2), torch.exp(p1 + 8.0 * p2)
    else:  # MONODISPERSE
        lo, hi = p1 * 0.5, p1 * 2.5
    active = n > 0.0
    return special.select(active, lo, float("inf")), special.select(active, hi, 0.0)


def _density_rows(fam: int, amp, p1, p2, cst, x, logx):
    """Mass density at node tile x (log x given) with amplitude `amp` (n, or
    1 for the normed density); `cst` is the gamma constant
    k·log θ + lgamma(k), hoisted out of the node loops as the kernel does."""
    if fam == Family.EXPONENTIAL:
        return amp / p1 * torch.exp(-x / p1)
    if fam == Family.GAMMA:
        logf = (p2 - 1.0) * logx - cst - x / p1
        return amp * special.exp(logf)
    if fam == Family.LOGNORMAL:
        d = logx - p1
        return (amp * special.exp(-(d * d) / (2.0 * (p2 * p2)))
                / (torch.clamp(x, min=torch.finfo(x.dtype).tiny) * p2 * _SQRT2PI))
    # MONODISPERSE
    return special.select(torch.abs(x - p1) < p1 / 10.0, amp / (2.0 * p1 / 10.0), 0.0)


def numerical_soa_plain(mom: torch.Tensor, plan: NumericalPlan, r_sums=None) -> torch.Tensor:
    """Plain twin of the quadrature kernel: normalized ``[n_tot, B]`` →
    tendencies ``[n_tot, B]``. Its ``[G, B]`` tiles make it a small-batch
    routine; `NumericalFn.plain` runs it in chunks of boxes. `r_sums`
    (``(X, WX, F) -> [A_j]``) replaces R's loop over every pair (a traced
    kernel's factored form, `kernel_expr.factored_r_sums`, as
    `tools.opcount` counts it); by default K is called on every pair."""
    dtype, dev = mom.dtype, mom.device
    eps, tiny = torch.finfo(dtype).eps, torch.finfo(dtype).tiny
    N, n_mom = plan.n_modes, plan.n_mom
    G = plan.g_total
    kf = plan.kernel_func
    xu_np, wu_np, s01_np, w01_np, log_cuts = _rules(plan)

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- closure inversion per mode, on [1, B] rows ------------------------
    params, cst = [], []
    for i, fam in enumerate(plan.families):
        o = plan.offsets[i]
        rows = [mom[o + j:o + j + 1] for j in range(plan.nprog[i])]
        inv_fam = Family.EXPONENTIAL if fam == Family.MONODISPERSE else fam
        n, p1, p2 = _invert_rows(inv_fam, rows, eps)
        params.append((n, p1, p2))
        cst.append(p2 * torch.log(p1) + special.lgamma(p2)
                   if fam == Family.GAMMA else None)

    # ---- per-box support bounds --------------------------------------------
    x_lo = torch.full_like(mom[:1], float("inf"))
    x_hi = torch.zeros_like(mom[:1])
    for fam, (n, p1, p2) in zip(plan.families, params):
        lo, hi = _bounds_rows(fam, n, p1, p2)
        x_lo = torch.minimum(x_lo, lo)
        x_hi = torch.maximum(x_hi, hi)
    x_lo = torch.clamp(x_lo, max=1e30)
    x_hi = torch.clamp(x_hi, min=1e-30)
    x_lo = torch.clamp(torch.minimum(x_lo, x_hi * 1e-12), min=tiny)
    x_hi = torch.clamp(2.0 * x_hi, min=4.0 * tiny)

    # ---- outer log grid: x = exp(u) with GL nodes in u, one panel per
    # smooth kernel piece (empty panels collapse to zero weight) ------------
    lo_l, hi_l = torch.log(x_lo), torch.log(x_hi)
    xu, wu = const(xu_np)[:, None], const(wu_np)[:, None]
    edges = ([lo_l]
             + [torch.minimum(torch.maximum(const(lc), lo_l), hi_l) for lc in log_cuts]
             + [hi_l])
    Xp, Wp = [], []
    for a, b in zip(edges[:-1], edges[1:]):
        u = torch.exp(a + 0.5 * (b - a) * (xu + 1.0))
        Xp.append(u)
        Wp.append(0.5 * (b - a) * wu * u)
    X = torch.cat(Xp, dim=0)  # [G, B]
    WX = torch.cat(Wp, dim=0)
    logX = torch.log(torch.clamp(X, min=tiny))

    # ---- densities at the outer nodes --------------------------------------
    def densities(x, logx, normed=False):
        return [_density_rows(fam, torch.ones_like(n) if normed else n, p1, p2, c, x, logx)
                for fam, (n, p1, p2), c in zip(plan.families, params, cst)]

    F = densities(X, logX)
    NF = densities(X, logX, normed=True)
    denom = NF[0]
    for v in NF[1:]:
        denom = denom + v
    wfrac, run = [], torch.zeros_like(denom)
    for v in NF:
        run = run + v
        wfrac.append(special.select(denom == 0.0, 0.0, run / denom))

    # moment weights B_m = WX·x^m and C_m = B_m·x (inner Jacobian)
    Bm, xp = [], torch.ones_like(X)
    for m in range(n_mom):
        if m > 0:
            xp = xp * X
        Bm.append(WX * xp)
    Cm = [b * X for b in Bm]

    # ---- R: inner ∫ K(x,y) f_j(y) dy on the same grid ----------------------
    if r_sums is not None:
        A = r_sums(X, WX, F)
    else:
        A = [torch.zeros_like(X) for _ in range(N)]
        for y in range(G):
            Ky = kf(X, X[y:y + 1])
            Wy = WX[y:y + 1]
            for j in range(N):
                A[j] = A[j] + (Wy * F[j][y:y + 1]) * Ky

    def reduce(mat):
        return torch.sum(mat, dim=0, keepdim=True)

    R = [[[reduce(Bm[m] * F[k] * A[j]) for k in range(N)] for j in range(N)]
         for m in range(n_mom)]

    # ---- Q and S: triangular inner integrals y = s·x; with a kink t the
    # per-x inner panels split at s = t/x and 1 − t/x ------------------------
    if plan.kinks:
        t = plan.kinks[0]
        b1 = torch.clamp(special.rdiv(t, X), 0.0, 1.0)
        b2 = torch.clamp(1.0 - special.rdiv(t, X), 0.0, 1.0)
        s_edges = [torch.zeros_like(X), torch.minimum(b1, b2),
                   torch.maximum(b1, b2), torch.ones_like(X)]
    else:
        s_edges = [torch.zeros_like(X), torch.ones_like(X)]

    Gq = {(j, k): torch.zeros_like(X) for j in range(N) for k in range(j + 1, N)}
    Gkk = [torch.zeros_like(X) for _ in range(N)]
    for pidx in range(plan.n_pi):
        a, b = s_edges[pidx], s_edges[pidx + 1]
        for s01, w01 in zip(const(s01_np), const(w01_np)):
            s = a + (b - a) * s01
            w = (b - a) * w01
            XR, XS = X * (1.0 - s), X * s
            D = densities(XR, torch.log(torch.clamp(XR, min=tiny)))
            E = densities(XS, torch.log(torch.clamp(XS, min=tiny)))
            KW = 0.5 * w * kf(XR, XS)
            for j in range(N):
                Gkk[j] = Gkk[j] + KW * D[j] * E[j]
                for k in range(j + 1, N):
                    Gq[(j, k)] = Gq[(j, k)] + KW * (D[j] * E[k] + D[k] * E[j])

    S1 = [[reduce(Cm[m] * wfrac[k] * Gkk[k]) for k in range(N)] for m in range(n_mom)]
    S2 = [[reduce(Cm[m] * Gkk[k]) - S1[m][k] for k in range(N)] for m in range(n_mom)]

    # ---- gated assembly (reference Coalescence.jl:479-488) -----------------
    out = []
    for k in range(N):
        for m in range(plan.nprog[k]):
            acc = S1[m][k]
            for j in range(N):
                acc = acc - R[m][j][k]
            for j in range(k):
                acc = acc + reduce(Cm[m] * Gq[(j, k)])
            if k > 0:
                acc = acc + S2[m][k - 1]
            out.append(acc[0])
    return torch.stack(out)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------


class NumericalFn(_KernelFn):
    """Direct-quadrature coalescence RHS (replaces
    `make_pallas_numerical_fn`): ``fn(mom [B, n_tot])`` and
    ``fn.soa(mom [n_tot, B])`` on normalized moments. A CUDA call launches
    ``quad_kernel``: the prebuilt library's at one to three modes with a
    tagged kernel function, else the unit built at first use for the plan's
    modes and, for a traced kernel function, its expression traced at the
    wrapper's type (`unit`); a kernel function the tracer could not follow
    raises when a CUDA wrapper is made (its CPU twin calls it). `_direct`
    (private) launches the body it replaced, ``numerical_kernel``, at the
    prebuilt modes and node counts (one thread per outer node, at most
    `DIRECT_MAX_G`): the same-call yardstick of `chip_smoke.py`."""

    def __init__(self, plan, device, dtype: torch.dtype, _direct: bool = False):
        trace = None
        if torch.device(device).type == "cuda" and plan.ktag == KT_GEN:
            if _direct:
                raise ValueError("the replaced body has no arm for a traced kernel function")
            from cloudy_tpu_torch.ops import kernel_expr

            # KernelTraceError names the operation the tracer does not cover
            trace = kernel_expr.trace(plan.kernel_func, dtype)
        super().__init__(plan, device, dtype)
        if _direct and (plan.n_modes > MAX_MODES or plan.g_total > DIRECT_MAX_G):
            raise ValueError(
                f"the replaced body runs at most {MAX_MODES} modes and {DIRECT_MAX_G} outer "
                f"nodes; this plan has {plan.n_modes} and {plan.g_total}")
        self._direct = _direct
        self._trace = trace
        self._unit = None

    @property
    def unit(self):
        """The unit built at first use that a CUDA call launches (a traced
        kernel function, or more modes than the prebuilt library holds),
        else None."""
        gen = self.plan.ktag == KT_GEN
        if self.plan.n_modes <= MAX_MODES and not gen:
            return None
        if self._unit is None:
            from cloudy_tpu_torch.ops import codegen, kernel_expr

            if gen and self._trace is None:
                self._trace = kernel_expr.trace(self.plan.kernel_func, self.dtype)
            self._unit = codegen.numerical_unit(self.plan.n_modes, self.dtype, self._trace)
        return self._unit

    def build_units(self) -> list:
        """Every unit built at first use that a CUDA call may launch."""
        return [] if self.unit is None else [self.unit]

    def _pack(self) -> np.ndarray:
        return pack_config(self.plan, self.dtype)

    def _smem_bytes(self, cfg_bytes: int) -> int:
        # the node tables (csrc quad_node_bytes): the hydrodynamic kernel's
        # radius and WX·F_j per outer node; a traced kernel's tabled y
        # values and WX·F_j where its factored form has a remainder
        if self._direct or self.plan.ktag not in (KT_HYDRO, KT_GEN):
            return cfg_bytes
        per_node = self.plan.n_modes + 1
        if self.plan.ktag == KT_GEN:
            gen = dict(self.unit.gen)
            per_node = (self.plan.n_modes + gen["tabled"]) if gen["remainder"] else 0
        return cfg_bytes + per_node * self.plan.g_total * self.dtype.itemsize

    @property
    def _symbol(self) -> str:
        body = "direct_" if self._direct else ""
        return f"cloudy_numerical_{body}{self._tag}_n{self.plan.n_modes}"

    @_launching
    def soa(self, mom: torch.Tensor) -> torch.Tensor:
        self._check(mom)
        if mom.device.type == "cpu":
            return numerical_soa_plain(mom, self.plan)
        extra = (self.plan.g_total, self.plan.ktag)
        if self.unit is None:
            return self._launch(mom, self.plan.n_tot, *extra)
        from cloudy_tpu_torch.ops import _build

        lib = _build.load_numerical(self.unit)
        return self._launch(mom, self.plan.n_tot, *extra,
                            symbol="cloudy_numerical_unit_launch", lib=lib,
                            error_string=lib.cloudy_numerical_unit_error_string,
                            label=self.unit.label)

    def __call__(self, mom: torch.Tensor) -> torch.Tensor:
        return self.soa(mom.T.contiguous()).T

    def plain(self, mom: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing), `chunk`
        boxes at a time: its ``[G, B]`` tiles outgrow the memory if a wide
        state is taken whole."""
        if chunk is None or mom.shape[1] <= chunk:
            return numerical_soa_plain(mom, self.plan)
        return torch.cat([numerical_soa_plain(mom[:, i:i + chunk], self.plan)
                          for i in range(0, mom.shape[1], chunk)], dim=1)


def make_numerical_fn(spec: SpectrumSpec, kernel_func, n_outer: int = 96,
                      n_inner: int = 48, device="cuda",
                      dtype: torch.dtype = torch.float32) -> NumericalFn:
    """Direct-quadrature coalescence RHS on `device` in `dtype` for an
    already normalized kernel function (cf. `models.box.make_box_rhs`); see
    `NumericalFn` and `build_plan`. The (96, 48) defaults are the bench
    configuration's budgets."""
    return NumericalFn(build_plan(spec, kernel_func, n_outer, n_inner), device, dtype)
