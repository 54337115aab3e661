"""Per-configuration CUDA source for the whole rainshaft step (B1, with its
scaled form B1s) and the fused per-level RHS (B4) at either tier, and for
the coalescence RHS on normalized moments (B3) at the fast tier, built into
one small shared library per configuration, type and kernel.

The table-driven kernels (csrc/fused_coalescence.cu) read one packed
configuration at run time, so the indices of their Q/R/S contraction, of
the moment recurrence and of the F2 tables are only known per lane, and
the body's per-lane arrays sit in local memory. The Pallas body
(cloudy_tpu/ops/pallas_coalescence.py:145-622) is traced once per
`CoalescenceData` instead: its contraction is a Python loop over the static
nonzeros, unrolled into straight-line FMAs with constant coefficients
(:598-620), and families, offsets, GL nodes and velocity terms are Python
constants. This module does the same for CUDA: `config_source` turns a
`FusedPlan` into a configuration type whose members are `static
constexpr` scalars and constant tables (csrc/coal_body.cuh reads either
form), and whose `contract` is the configuration's Q/R/S terms as
straight-line statements. A reference-tier plan's switches (the quadrature
rule, the series/CF and Newton iteration counts, the grid sizes, the F2
kind per mode) become constants too, as every switch of the Pallas body is
a Python constant; its fixed grids and the Gauss base nodes of a moving
grid, which the node loops index at run time, become `__constant__` tables
of the unit, so that no per-lane array is indexed at run time:

- every real constant is computed in double on the host exactly as
  `pack_config` computes it (`fused_coalescence.config_reals`), rounded once
  to the kernel's type and written as a hex-float literal, so the rounding
  is the table-driven kernels';
- the terms come in the Pallas body's order, wb then wf; the
  first term of each output assigns and later ones add; the wf terms the
  Pallas body skips (`f2_lookup` returning None: an F2 entry past the
  mode's `n_2d_ints`) are the ones `build_plan` leaves out; each F2 entry
  takes the clamp against M_a·M_b of its mode's kind (exact gamma /
  exponential: min(mm, mm·P(2k + a + b)); the lognormal window and every
  quadrature grid: min(mm, F2[a, b]); the monodisperse closed form:
  min(mm, mm where θ < T/2, else 0); no threshold: mm) and the ``mm < eps``
  zero, once per entry.

`unit` wraps the configuration in one kernel (csrc/gen_kernels.cuh: the
whole step with its warp-shuffle or shared-memory z-stencil, with or
without the per-lane kernel scale of B1s, the fused RHS, or the coalescence
RHS), with its block size and launch bounds. The configuration type is
sized from the plan: every per-lane array of the body holds the plan's
modes and moments (its capacities `kModes`, `kNtot`, `kM`, with M at least
`MAX_M`, the F2 rows' stride), so any number of modes and moments compiles.
A unit whose plan has a monodisperse mode is built without FMA contraction
(``-fmad=false``): the mono + gamma pulse is ill-conditioned (ROADMAP.md
§C), and its trajectory stays the twin's only where every product and sum
is rounded as the twin rounds it. Every other unit keeps nvcc's
contraction.

A fast-tier f32 unit takes the SFU forms (`sfu_forms`: ``kSfu`` in its
configuration, csrc/common.cuh ``Dom``): the body's logs and exps in base 2
(``lg2.approx`` / ``ex2.approx``, log2(e) folded into its constants, and
into ``vel_e2``, the velocity exponents times log2(e), in double and
rounded once), its divides by a known normal denominator as approximate
reciprocals and the others as full-range approximate divides, its clamped
square roots approximate: the same operations in the same order, none
through an IEEE slow path. Every other unit (the reference tier, which
every monodisperse plan is, and f64; ``kSfu`` false) compiles to the IEEE
code it had. An SFU unit's label says so: ``step_sfu_f32_<digest>``.

Two more kinds of unit are built at first use from the package's own
sources, for configurations past what the prebuilt library holds:
`ref_unit`, a table-driven reference-tier kernel at capacities past the
library's (csrc/fused_coalescence.cu built with its own CLOUDY_CAP_*: B3's
reference tier, and the table-driven yardstick of B1 and B4), and
`numerical_unit`, the quadrature kernel (B5) at more modes than the
library's three, or with a traced kernel function (its ``KT_GEN`` arm, the
device function emitted by `kernel_expr`; csrc/numerical_coalescence.cu).

A unit's name is a hash of the generated text, the csrc/ sources, the
compiler flags and the spill rule (`_build.gen_flags_digest`); `ops._build`
compiles each unit at first use under ``build/cloudy_tpu_torch/gen/<hash>/``
(several at once when asked for together, `_build.build_generated`) and
binds it by ctypes (`_build.load_generated`, `load_ref`,
`load_numerical`). Nothing generated is committed.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family

#: kernels: the whole step (B1), the fused per-level RHS (B4) and the
#: coalescence RHS on normalized moments (B3, one thread per box)
KINDS = {"step": 0, "rhs": 1, "coal": 2}
#: threads per block of every generated kernel (the whole step at an nz
#: that does not divide it takes whole columns: `_block`). Chosen by
#: measurement on an H100 80GB HBM3 at 700 W (PERF.md §6): 256 took
#: the pod variants' whole step and B4 below 128. The launch bounds carry no
#: minimum block count unless ptxas spills under its own register target
#: (`ops._build.build_generated`), and the whole step runs its three RHS
#: evaluations as a loop over one inlined copy of the body
#: (csrc/gen_kernels.cuh), both also chosen there.
THREADS = 256
#: threads per block of a reference-tier whole step: measured on an H100
#: 80GB HBM3 at 700 W (PERF.md §6, `tools.reference_tune`) at 64, 128 and
#: 256, at [6, 4096] and [6, 131072]: 128 is within 0.6 % of the best size
#: at every shape and type, 256 loses 6-8 % at 4,096 lanes (16 blocks on
#: 132 SMs, one resident block per SM at the f64 unit's 172 registers)
REF_THREADS = 128
#: the flag of a unit built without FMA contraction (a monodisperse plan)
NO_FMA = "-fmad=false"
#: the MAX_M of csrc/coal_body.cuh: the least stride of an F2 row (`_tri`)
_MAX_M = fc.MAX_M
#: log2(e) in double (csrc/common.cuh Dom<float, true>::kFromLnD)
_LOG2E = 1.4426950408889634


@dataclasses.dataclass(frozen=True)
class Unit:
    """One build unit built at first use: a configuration header and the
    unit that instantiates one kernel on it. `kind` is a generated kernel
    (`KINDS`), ``"ref_<kind>"`` a reference-tier one (`ref_unit`) or
    ``"numerical"`` (`numerical_unit`); `flags` are its extra nvcc flags,
    `caps` the capacities a unit of the table-driven sources is built at
    (modes, moments, M; a numerical unit: its modes)."""

    kind: str
    dtype: torch.dtype
    cfg: str
    source: str
    digest: str
    threads: int
    shfl: bool
    n_tot: int
    nz: int
    scaled: bool = False
    #: the SFU forms (`sfu_forms`): ``kSfu`` in the configuration
    sfu: bool = False
    flags: Tuple[str, ...] = ()
    caps: Tuple[int, ...] = ()
    #: a traced numerical unit's factored form (`kernel_expr.factor`), as
    #: (name, count) pairs: separable terms, x values, tabled y values,
    #: remainder operations per pair, remainder (0 or 1)
    gen: Tuple[Tuple[str, int], ...] = ()

    @property
    def label(self) -> str:
        kind = f"{self.kind}_scaled" if self.scaled else self.kind
        kind = f"{kind}_sfu" if self.sfu else kind
        return f"{kind}_{'f32' if self.dtype == torch.float32 else 'f64'}_{self.digest}"


def literal(v: float, dtype: torch.dtype) -> str:
    """`v` rounded once to `dtype` as a C++ hex-float literal (exact: it
    parses back to the rounded value bit for bit)."""
    x = float(np.float32(v)) if dtype == torch.float32 else float(v)
    if not np.isfinite(x):
        raise ValueError(f"constant {v!r} is not finite")
    mant, exp = x.hex().split("p")
    if "." in mant:
        mant = mant.rstrip("0")
        if mant.endswith("."):
            mant += "0"
    s = f"{mant}p{exp}" + ("f" if dtype == torch.float32 else "")
    return f"({s})" if s.startswith("-") else s


def _cap_m(plan: fc.FusedPlan) -> int:
    """The configuration type's capacity of M, the stride of its F2 rows:
    the plan's M, but at least `_MAX_M` (the stride the prebuilt tables
    and every configuration up to M = 5 keep)."""
    return max(plan.M, _MAX_M)


def _tri(p: int, q: int, kM: int = _MAX_M) -> int:
    """The packed (p, q), p ≤ q, slot of an F2 row of stride kM
    (csrc/coal_body.cuh tri)."""
    return p * (2 * kM - p - 1) // 2 + q


def sfu_forms(plan: fc.FusedPlan, dtype: torch.dtype) -> bool:
    """Whether `plan`'s units in `dtype` take the SFU forms: the fast tier in
    float. The reference tier (held to f64 goldens and to the twin bit for
    bit), every plan with a monodisperse mode (reference tier by
    `FusedPlan.ref`: its ill-conditioned pulse is held to the twin bit for
    bit) and f64 keep IEEE."""
    return not plan.ref and dtype == torch.float32


def _check(plan: fc.FusedPlan, kind: str) -> None:
    if plan.ref and kind == "coal":
        raise ValueError("B3's reference tier runs the table-driven kernels (a thread or a "
                         "warp per box, `fused_coalescence.coal_layout`); its code is "
                         "generated for the fast tier only")


def _contract(plan: fc.FusedPlan, dtype: torch.dtype, real: str) -> List[str]:
    """The body of `contract`: each F2 entry the wf terms read (clamped by
    its mode's kind, zeroed below eps) once, then every term in the Pallas
    body's order
    (pallas_coalescence.py:598-620): the wb terms (o, i, j, c), acc[o] +=
    c·Mf[i]·Mf[j] with i = mode·M + p, then the wf terms (o, k, a, b, c),
    acc[o] += c·F2[k][a, b] with a ≤ b, its skipped terms left out
    (`build_plan`)."""
    M, kM = plan.M, _cap_m(plan)
    wb, wf = list(plan.wb_nz), list(plan.wf_nz)
    out = [f"const {real} eps = Lim<{real}>::eps();"]
    seen = set()
    for (_, k, a, b, _) in wf:
        if (k, a, b) in seen:
            continue
        seen.add((k, a, b))
        mm = f"mm_{k}_{a}_{b}"
        out.append(f"const {real} {mm} = mf[{k * M + a}] * mf[{k * M + b}];")
        kind = plan.f2_kind[k]
        if kind in (fc.F2_WINDOW, fc.F2_GRID):
            val = f"vmin({mm}, ftab[{k}][{_tri(a, b, kM)}])"
        elif kind == fc.F2_EXACT:
            val = f"vmin({mm}, {mm} * ftab[{k}][{a + b}])"
        elif kind == fc.F2_MONO:
            # the closed form (pallas_coalescence.py:556-568): ftab[k][0] is
            # 1 where θ < T/2, else 0
            val = f"vmin({mm}, (ftab[{k}][0] != {real}(0)) ? {mm} : {real}(0))"
        else:
            val = mm
        out.append(f"const {real} f2_{k}_{a}_{b} = ({mm} < eps) ? {real}(0) : {val};")
    assigned = set()
    for o in range(plan.n_tot):
        if not any(t[0] == o for t in wb + wf):
            out.append(f"acc[{o}] = {real}(0);")
            assigned.add(o)
    for (o, i, j, c) in wb:
        term = f"{literal(c, dtype)} * mf[{i}] * mf[{j}]"
        out.append(f"acc[{o}] = acc[{o}] + {term};" if o in assigned else f"acc[{o}] = {term};")
        assigned.add(o)
    for (o, k, a, b, c) in wf:
        term = f"{literal(c, dtype)} * f2_{k}_{a}_{b}"
        out.append(f"acc[{o}] = acc[{o}] + {term};" if o in assigned else f"acc[{o}] = {term};")
        assigned.add(o)
    return out


def _table(name: str, ctype: str, vals: Sequence[str]) -> List[str]:
    body = ", ".join(vals) if vals else f"{ctype}(0)"  # an empty table is never read
    return [
        f"struct {name}_tab {{",
        f"  __device__ __forceinline__ {ctype} operator[](int i) const {{",
        f"    constexpr {ctype} v[] = {{{body}}};",
        "    return v[i];",
        "  }",
        f"}} {name};",
    ]


def _constant(name: str, ctype: str, vals: Sequence[str]) -> List[str]:
    """A table the node loops index at run time: `__constant__` memory of
    the unit (a per-call constexpr array indexed at run time may be placed
    in local memory)."""
    return [f"__constant__ {ctype} {name}[{max(len(vals), 1)}] = "
            f"{{{', '.join(vals) if vals else f'{ctype}(0)'}}};"]


def _reference(plan: fc.FusedPlan, lit, real: str):
    """(tables before the struct, members) of a reference-tier
    configuration: its switches as constants (csrc/coal_body.cuh reads them
    as the packed header's slots), the per-mode F2 kind, grid length and
    dx, and the fixed grids (x then w, per mode) and the moving Gauss
    grid's base nodes as `__constant__` tables."""
    r = fc.config_reals(plan)
    grids = [g or ((), (), 0.0) for g in plan.grids]
    offs, off = [], 0
    for x, _, _ in grids:
        offs.append(off)
        off += 2 * len(x)
    tables = [
        "// the reference tier's tables the node loops index at run time",
        *_constant("cfg_grids", real, [lit(v) for v in r["grids"]]),
        *_constant("cfg_gauss_u", real, [lit(v) for v in r["gauss_u"]]),
        *_constant("cfg_gauss_w", real, [lit(v) for v in r["gauss_w"]]),
        "",
    ]
    body = [
        "static constexpr bool kSeriesExit = true;",
        f"static constexpr int quad = {int(plan.quad_rule == 'gauss')};",
        f"static constexpr int gi_iters = {plan.gammainc_iters};",
        f"static constexpr int newton_iters = {plan.thr_newton_iters};",
        f"static constexpr int thr_gi_iters = {plan.thr_gammainc_iters};",
        f"static constexpr int n_pts = {plan.n_points_max};",
        f"static constexpr int n_gauss = {len(r['gauss_u'])};",
    ]
    body += _table("f2kind", "int", [str(int(v)) for v in fc._per_mode(plan.f2_kind)])
    body += _table("grid_n", "int", [str(len(g[0])) for g in grids])
    body += _table("grid_dx", "real", [lit(v) for v in r["grid_dx"]])
    for name in ("gauss_u", "gauss_w"):
        body += [
            f"struct {name}_tab {{",
            "  __device__ __forceinline__ real operator[](int i) const "
            f"{{ return cfg_{name}[i]; }}",
            f"}} {name};",
        ]
    body += [
        "// the fixed grid of mode i: x[grid_n[i]], then w[grid_n[i]]",
        "__device__ __forceinline__ const real* grid(int i) const {",
        f"  constexpr int off[] = {{{', '.join(str(o) for o in offs)}}};",
        "  return cfg_grids + off[i];",
        "}",
    ]
    return tables, body


def config_source(plan: fc.FusedPlan, dtype: torch.dtype, kind: str = "step",
                  scaled: bool = False) -> str:
    """The configuration header of `plan` in `dtype` for kernel `kind`:
    struct ``cloudy::gen::Cfg`` (csrc/coal_body.cuh, `C::kStatic`). A
    `scaled` whole step carries ``kScale`` (csrc/gen_kernels.cuh `Scaled`);
    an unscaled one's text has no such line. A reference-tier plan's
    configuration carries ``kRef`` and its switches (`_reference`), the
    series incomplete gamma's early exit (``kSeriesExit``) among them.
    ``kSfu`` says whether the body takes the SFU forms (`sfu_forms`); with it
    true the configuration also carries ``vel_e2``."""
    _check(plan, kind)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}, not {kind!r}")
    if scaled and kind != "step":
        raise ValueError("only the whole step takes a kernel scale")
    real = "float" if dtype == torch.float32 else "double"
    threads, shfl = _block(plan, kind)
    r = fc.config_reals(plan)
    lit = lambda v: literal(v, dtype)  # noqa: E731
    fams = " ".join(Family(f).name.lower() for f in plan.families)
    on_sfu = sfu_forms(plan, dtype)
    tables, ref_body = _reference(plan, lit, real) if plan.ref else ([], [])
    head = [
        "// Generated by cloudy_tpu_torch/ops/codegen.py; do not edit.",
        f"// {kind} kernel, {real}, {'reference' if plan.ref else 'fast'} tier: modes {fams}, "
        f"{'MovingThreshold' if plan.moving else 'FixedThreshold'}, M = {plan.M}, "
        f"n_tot = {plan.n_tot}, GL nodes {plan.gl_nodes}, window nodes {plan.win_nodes}, "
        f"nz = {plan.nz}; {len(plan.wb_nz)} wb and {len(plan.wf_nz)} wf terms.",
        "#pragma once",
        "",
        '#include "coal_body.cuh"',
        "",
        "namespace cloudy {",
        "namespace gen {",
        "",
        *tables,
        "struct Cfg {",
    ]
    body = [
        f"using real = {real};",
        "static constexpr bool kStatic = true;",
        f"static constexpr bool kArms = {'true' if plan.arms or plan.ref else 'false'};",
        f"static constexpr bool kRef = {'true' if plan.ref else 'false'};",
        f"static constexpr bool kSfu = {'true' if on_sfu else 'false'};",
        f"static constexpr int kKind = {KINDS[kind]};",
        *(["static constexpr bool kScale = true;"] if scaled else []),
        f"static constexpr int kThreads = {threads};",
        f"static constexpr bool kShfl = {'true' if shfl else 'false'};",
        f"static constexpr int n_modes = {plan.n_modes};",
        f"static constexpr int n_tot = {plan.n_tot};",
        f"static constexpr int M = {plan.M};",
        "// capacities: the per-lane arrays' sizes, M's the F2 rows' stride",
        f"static constexpr int kModes = {plan.n_modes}, kNtot = {plan.n_tot}, "
        f"kM = {_cap_m(plan)};",
        "static constexpr int kS = 2 * kM - 1, kFtab = kM * (kM + 1) / 2;",
        f"static constexpr int n_gl = {plan.gl_nodes};",
        f"static constexpr int n_vel = {len(plan.vel_n)};",
        f"static constexpr int n_win = {plan.win_nodes};",
        f"static constexpr int moving = {int(plan.moving)};",
        f"static constexpr int nz = {plan.nz};",
        f"static constexpr real dt = {lit(r['dt'])};",
        f"static constexpr real inv_dz = {lit(r['inv_dz'])};",
        f"static constexpr real two_thirds = {lit(r['two_thirds'])};",
    ]
    for name, vals in (("fam", plan.families), ("off", plan.offsets), ("nprog", plan.nprog),
                       ("thr_flag", plan.thr_flag)):
        body += _table(name, "int", [str(int(v)) for v in fc._per_mode(vals)])
    for name in ("thr", "norm", "inv_norm", "vel_c", "vel_e", "vel_g", "vel_me", "vel_hq2",
                 "gl_y1", "gl_w", "win_v", "win_w"):
        body += _table(name, "real", [lit(v) for v in r[name]])
    if on_sfu:  # the velocity exponents times log2(e), in double, rounded once
        body += _table("vel_e2", "real", [lit(e * _LOG2E) for e in r["vel_e"]])
    body += ref_body
    body += [
        "// Q/R/S: the configuration's terms, wb then wf (pallas_coalescence.py:598-620)",
        "template <class F>",
        "static __device__ __forceinline__ void contract(const real* mf, const F& ftab, "
        "real* acc) {",
        *("  " + ln for ln in _contract(plan, dtype, real)),
        "}",
    ]
    return "\n".join(head + ["  " + ln if ln else "" for ln in body]
                     + ["};", "", "}  // namespace gen", "}  // namespace cloudy", ""])


def _block(plan: fc.FusedPlan, kind: str) -> Tuple[int, bool]:
    """(threads per block, shuffle stencil) of a kernel, blocks of
    `THREADS` (a reference-tier whole step `REF_THREADS`): the whole step at
    nz a power of two ≤ 32 takes the warp shuffle; any other nz blocks of
    whole columns through shared memory."""
    threads = REF_THREADS if plan.ref and kind == "step" else THREADS
    if kind != "step":
        return threads, False
    nz = plan.nz
    if nz <= 32 and nz & (nz - 1) == 0:
        return threads, True
    cols = 1 if nz >= threads else threads // nz
    return cols * nz, False


def _digest(*texts: str) -> str:
    from cloudy_tpu_torch.ops import _build

    h = hashlib.sha256()
    for t in texts:
        h.update(t.encode())
    h.update(_build.gen_flags_digest().encode())
    return h.hexdigest()[:16]


def unit(plan: fc.FusedPlan, dtype: torch.dtype, kind: str = "step",
         scaled: bool = False) -> Unit:
    """The build unit of `plan`'s `kind` kernel in `dtype`; `scaled`: the
    whole step with the per-lane kernel scale (B1s). A plan with a
    monodisperse mode builds without FMA contraction (`NO_FMA`)."""
    cfg = config_source(plan, dtype, kind, scaled)
    threads, shfl = _block(plan, kind)
    real = "float" if dtype == torch.float32 else "double"
    name = f"gen_{kind}"
    args = f"const {real}* __restrict__ mom, {real}* __restrict__ out, long long B"
    if scaled:
        args += f", const {real}* __restrict__ scale"
    source = "\n".join([
        "// Generated by cloudy_tpu_torch/ops/codegen.py; do not edit.",
        '#include "gen_kernels.cuh"',
        '#include "cfg.cuh"',
        "",
        "namespace cloudy {",
        "namespace gen {",
        f"__global__ void CLOUDY_GEN_BOUNDS({threads})",
        f"{name}({args}) {{",
        f"  gen_{kind}_body<Cfg>(mom, out, B{', scale' if scaled else ''});",
        "}",
        "}  // namespace gen",
        "}  // namespace cloudy",
        "",
        f"CLOUDY_GEN_{'SCALED_' if scaled else ''}ENTRY(cloudy::gen::Cfg, cloudy::gen::{name})",
        "",
    ])
    flags = (NO_FMA,) if Family.MONODISPERSE in plan.families else ()
    return Unit(kind=kind, dtype=dtype, cfg=cfg, source=source,
                digest=_digest(cfg, source, " ".join(flags)), threads=threads, shfl=shfl,
                n_tot=plan.n_tot, nz=plan.nz, scaled=scaled, sfu=sfu_forms(plan, dtype),
                flags=flags)


def _first_use_source(caps_defines, include: str, entry: str) -> str:
    return "\n".join([
        "// Generated by cloudy_tpu_torch/ops/codegen.py; do not edit.",
        *caps_defines,
        "#define CLOUDY_UNIT (-1)",
        f'#include "{include}"',
        "",
        entry,
        "",
    ])


def ref_unit(caps, dtype: torch.dtype, kind: str) -> Unit:
    """The unit of the table-driven reference-tier kernel `kind`
    (`fused_coalescence.REF_KINDS`: the coalescence RHS with a thread or a
    warp per box, the fused RHS, the whole step, the scaled whole step) at
    capacities `caps` (modes, moments, M) in `dtype`: csrc/
    fused_coalescence.cu with its CLOUDY_CAP_* set to `caps` and one
    CLOUDY_REF_ENTRY. The whole steps are built without FMA contraction, as
    the library's reference whole step (its units 12, 13, 16, 17). B3's
    reference tier past the library's capacities runs such units; so do
    the table-driven yardsticks of B1 and B4 there (the wrappers' private
    `_table`)."""
    if kind not in fc.REF_KINDS:
        raise ValueError(f"kind must be one of {fc.REF_KINDS}, not {kind!r}")
    modes, ntot, m = (int(v) for v in caps)
    real = "float" if dtype == torch.float32 else "double"
    source = _first_use_source(
        [f"#define CLOUDY_CAP_MODES {modes}", f"#define CLOUDY_CAP_NTOT {ntot}",
         f"#define CLOUDY_CAP_M {m}"],
        "fused_coalescence.cu", f"CLOUDY_REF_ENTRY({real}, {kind.upper()})")
    flags = (NO_FMA,) if kind.startswith("step") else ()
    return Unit(kind=f"ref_{kind}", dtype=dtype, cfg="", source=source,
                digest=_digest(source, " ".join(flags)), threads=0, shfl=False,
                n_tot=ntot, nz=0, flags=flags, caps=(modes, ntot, m))


def numerical_unit(n_modes: int, dtype: torch.dtype, kernel=None) -> Unit:
    """The unit of the quadrature kernel (B5, `quad_kernel`) at `n_modes`
    modes in `dtype`: csrc/numerical_coalescence.cu with one
    CLOUDY_NUMERICAL_UNIT_ENTRY. Without `kernel`, for more modes than the
    prebuilt library holds, with the four tagged kernel functions. With
    `kernel`, a traced kernel function (`kernel_expr.trace`), at any number
    of modes: its device function ``cloudy_kernel_gen`` (constants rounded
    once to `dtype`) in the unit's ``cfg.cuh`` and the kernel's ``KT_GEN``
    arm alone (CLOUDY_KERNEL_GEN), with csrc/special_functions.cuh included
    where the trace calls one of its functions; the digest covers the
    emitted text, so each distinct kernel function builds once."""
    real = "float" if dtype == torch.float32 else "double"
    cfg, defines, gen = "", [], ()
    if kernel is not None:
        from cloudy_tpu_torch.ops import kernel_expr

        def lit(v):
            return literal(v, dtype)

        fac = kernel_expr.factor(kernel)
        gen = (("terms", len(fac.terms)), ("x_values", len(fac.x_values)),
               ("tabled", len(fac.tabled)), ("remainder_nodes", fac.remainder_nodes),
               ("remainder", int(fac.remainder is not None)))
        cfg = "\n".join([
            "// Generated by cloudy_tpu_torch/ops/codegen.py; do not edit.",
            "// The kernel function K(x, y), traced (ops/kernel_expr.py).",
            "#pragma once",
            "",
            *(f'#include "{h}"' for h in kernel_expr.includes(kernel)),
            "",
            "namespace cloudy {",
            kernel_expr.device_source(kernel, lit),
            kernel_expr.factored_source(fac, lit),
            "}  // namespace cloudy",
            "",
        ])
        defines = ["#define CLOUDY_KERNEL_GEN 1", '#include "cfg.cuh"']
    source = _first_use_source(defines, "numerical_coalescence.cu",
                               f"CLOUDY_NUMERICAL_UNIT_ENTRY({real}, {int(n_modes)})")
    return Unit(kind="numerical", dtype=dtype, cfg=cfg, source=source,
                digest=_digest(cfg, source), threads=0, shfl=False, n_tot=0, nz=0,
                caps=(int(n_modes),), gen=gen)
