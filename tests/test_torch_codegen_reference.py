"""The reference tier of the whole step (B1), its scaled form (B1s) and the
fused per-level RHS (B4) generated per configuration (`ops.codegen` on a
reference-tier plan), on the CPU against the JAX package and the plain
twins (no GPU, no nvcc):

(a) the emitted configuration: the contraction's terms parsed back equal
    the Pallas body's (pallas_coalescence.py:598-620) in order; each F2
    entry takes its mode's clamp (a quadrature grid: min(mm, F2[a, b]) at
    its packed slot; the monodisperse closed form: min(mm, mm where θ <
    T/2, else 0)); the switches (rule, iteration counts, grid sizes, F2
    kinds) are the plan's; every literal of the fixed grids and the Gauss
    base nodes (`__constant__` tables) parses back, bit for bit, to the
    host double rounded once (`fused_coalescence.config_reals`);
(b) the generated fused RHS compiled as host C++ (g++ through a shim that
    defines the CUDA qualifiers away), lane by lane, against the twin over
    every arm of the reference tier: the fixed Simpson and Gauss grids, the
    moving Simpson grid (lanes with T < 1 and T > 1, with the Newton
    inverse) and the moving Gauss grid, exact F2 on series/CF, the Lanczos
    flux, mono + gamma (lanes on both sides of θ = T/2), the lognormal Φ
    grid with the series erf and with the rational erf; row-scaled f64 <
    1e-12, f32 < 1e-5 (the same operations in the same order, compiled
    without contraction; glibc's and torch's exp/log differ in the last
    bits); and one arm's coalescence body in f64 against JAX's
    `make_pallas_coal_fn` in interpret mode at 128 lanes (< 1e-9);
(c) the series incomplete gamma's early exit (`kSeriesExit`) against the
    fixed loop, both built by g++ from common.cuh through the shim, bit for
    bit on seeded lanes of both branches in f32 and f64;
(d) the routes: a reference plan's whole step, scaled step and fused RHS
    are ``"generated"``; `_table` still reaches the table-driven yardstick;
    B3's reference tier stays table-driven; a monodisperse plan's unit
    carries ``-fmad=false`` and no other unit does.

The generated whole step and its scaled form are held against the twins in
tests/test_torch_codegen_reference_step.py. Host libraries are compiled once
per module.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

import _codegen_host as ch
from _codegen_host import ARMS, DTYPES, HOST_TOL, NORMS, arm_plans, call, row_scaled
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.ops import _build, codegen
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import reference_tune

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

G = Family.GAMMA

#: the series incomplete gamma with and without its early exit
SERIES = """#include "common.cuh"
template <typename T, bool kExit>
void run(const T* a, const T* x, T* out, long long n, int n_iters) {
  for (long long i = 0; i < n; ++i) {
    const T lga = cloudy::lgamma_lanczos(a[i]);
    const T log_x = cloudy::dlog(cloudy::vmax(cloudy::vmin(x[i], T(1e6)),
                                              cloudy::Lim<T>::tiny()));
    out[i] = cloudy::gammainc_sc<kExit>(a[i], x[i], n_iters, lga, log_x);
  }
}
extern "C" void series_f32(const float* a, const float* x, float* out, long long n,
                           int n_iters, int exit) {
  exit ? run<float, true>(a, x, out, n, n_iters) : run<float, false>(a, x, out, n, n_iters);
}
extern "C" void series_f64(const double* a, const double* x, double* out, long long n,
                           int n_iters, int exit) {
  exit ? run<double, true>(a, x, out, n, n_iters) : run<double, false>(a, x, out, n, n_iters);
}
"""


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """`host_libs(arm)`: the arm's fused-RHS configuration in both types
    (`_codegen_host.compile_arm`: ``host_coal_*``, ``host_rhs_*``), compiled
    once per module."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the generated body on the host")
    libs = {}

    def get(arm):
        if arm not in libs:
            libs[arm] = ch.compile_arm(tmp_path_factory.mktemp("arm"), arm, ("coal", "rhs"))
        return libs[arm]

    return get


def _tag(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _real_t(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


# --------------------------------------------------------------------------
# (a) the emitted configuration
# --------------------------------------------------------------------------


def _parsed_terms(src):
    """The contraction's statements in order: ("wb", o, i, j, c) and ("wf",
    o, k, a, b, c)."""
    body = src[src.index("void contract("):]
    out = []
    for m in re.finditer(r"acc\[(\d+)\] = (?:acc\[\d+\] \+ )?(\(?-?0x[0-9a-fA-Fp.+-]+f?\)?) \* "
                         r"(?:mf\[(\d+)\] \* mf\[(\d+)\]|f2_(\d+)_(\d+)_(\d+));", body):
        c = float.fromhex(m.group(2).strip("()").rstrip("f"))
        if m.group(3) is not None:
            out.append(("wb", int(m.group(1)), int(m.group(3)), int(m.group(4)), c))
        else:
            out.append(("wf", int(m.group(1)), *(int(m.group(i)) for i in (5, 6, 7)), c))
    return out


def _pallas_terms(jdata, real_t):
    wb = [("wb", o, i, j, float(real_t(c))) for (o, i, j, c) in pc._wb_nonzeros(jdata)]
    n2d = jdata.n_2d_ints
    wf = [("wf", o, k, min(p, q), max(p, q), float(real_t(c)))
          for (o, k, p, q, c) in pc._wf_nonzeros(jdata) if p < n2d[k] and q < n2d[k]]
    return wb + wf


def _real_t(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("arm", ["fixed Simpson", "mono + gamma", "lognormal Φ grid, series erf",
                                 "moving Gauss"])
def test_reference_terms_and_clamps(arm, dtype):
    """The contraction's terms are the Pallas body's; each F2 entry takes
    its mode's clamp: a grid mode's packed slot tri(a, b), a monodisperse
    mode's closed form."""
    fams, thr, moving, bkw, _ = ARMS[arm]
    jdata = jbuild(JSpec(tuple(JF[Family(f).name] for f in fams)), ch.ker(JK), thr,
                   norms=NORMS, moving=moving, **bkw)
    splan, _ = arm_plans(arm)
    src = codegen.config_source(splan, dtype)
    assert _parsed_terms(src) == _pallas_terms(jdata, _real_t(dtype))
    real = "float" if dtype == torch.float32 else "double"
    for (_, k, a, b, _) in splan.wf_nz:
        mm = f"mm_{k}_{a}_{b}"
        want = {fc.F2_GRID: f"vmin({mm}, ftab[{k}][{codegen._tri(a, b)}])",
                fc.F2_MONO: f"vmin({mm}, (ftab[{k}][0] != {real}(0)) ? {mm} : {real}(0))",
                fc.F2_NONE: mm}[splan.f2_kind[k]]
        assert f"{real} f2_{k}_{a}_{b} = ({mm} < eps) ? {real}(0) : {want};" in src


def _constant_table(src, name):
    m = re.search(rf"__constant__ \w+ {name}\[(\d+)\] = \{{(.*?)\}};", src)
    return int(m.group(1)), [x.strip() for x in m.group(2).split(",")]


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("arm", ["fixed Simpson", "fixed Gauss", "moving Simpson, Newton",
                                 "moving Gauss"])
def test_reference_switches_and_tables(arm, dtype):
    """The switches are the plan's constants; the fixed grids and the Gauss
    base nodes are `__constant__` tables holding `config_reals` rounded
    once to the type; the grid accessor's offsets step over each mode's x
    and w; a fast-tier configuration carries none of it."""
    splan, _ = arm_plans(arm)
    src = codegen.config_source(splan, dtype)
    r = fc.config_reals(splan)
    real_t = _real_t(dtype)
    ints = {k: int(v) for k, v in re.findall(r"static constexpr int (\w+) = (-?\d+);", src)}
    assert ints["quad"] == int(splan.quad_rule == "gauss")
    assert (ints["gi_iters"], ints["newton_iters"], ints["thr_gi_iters"], ints["n_pts"]) == (
        splan.gammainc_iters, splan.thr_newton_iters, splan.thr_gammainc_iters,
        splan.n_points_max)
    assert ints["n_gauss"] == len(r["gauss_u"]) == (splan.gauss_nodes if splan.moving and
                                                    splan.quad_rule == "gauss" else 0)
    assert "static constexpr bool kRef = true;" in src
    assert "static constexpr bool kSeriesExit = true;" in src
    assert "kSeriesExit = false" in reference_tune.variant(codegen.unit(splan, dtype),
                                                           series_exit=False).cfg
    for name, key in (("cfg_grids", "grids"), ("cfg_gauss_u", "gauss_u"),
                      ("cfg_gauss_w", "gauss_w")):
        n, lits = _constant_table(src, name)
        want = np.asarray(r[key], np.float64).astype(real_t)
        assert n == max(len(want), 1)
        if len(want):
            got = np.asarray([float.fromhex(x.strip("()").rstrip("f")) for x in lits],
                             np.float64).astype(real_t)
            assert got.tobytes() == want.tobytes(), name
    lens = [0 if g is None else len(g[0]) for g in splan.grids]
    m = re.search(r"struct grid_n_tab \{.*?v\[\] = \{(.*?)\};", src, re.S)
    assert [int(v) for v in m.group(1).split(",")] == lens
    m = re.search(r"constexpr int off\[\] = \{(.*?)\};", src)
    assert [int(v) for v in m.group(1).split(",")] == [2 * sum(lens[:i]) for i in range(len(lens))]
    fast = fc.build_plan(build_coalescence_data(SpectrumSpec((G, G)), ch.ker(), (5e-10, np.inf),
                                                norms=NORMS, fast_tier=True),
                         ch.VEL, NORMS, ch.NZ, ch.DZ, ch.DT)
    fsrc = codegen.config_source(fast, dtype)
    assert "kRef = false" in fsrc and "__constant__" not in fsrc and "kSeriesExit" not in fsrc


# --------------------------------------------------------------------------
# (b) the generated fused RHS as host C++
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("arm", list(ARMS))
def test_generated_reference_rhs_matches_twin(host_libs, arm, dtype):
    """The generated fused RHS (coalescence over flux rows), lane by lane,
    against the twin; the empty lane's tendency is zero. Moving grids: lanes
    on both sides of T = 1; mono + gamma: on both sides of θ = T/2."""
    _, rplan = arm_plans(arm)
    lib = host_libs(arm)
    mom = ch.arm_moments(rplan.families, 192, seed=4)
    if rplan.moving:
        thr = fc.moving_thresholds(rplan, torch.as_tensor(mom))[0]
        assert bool((thr < 1.0).any()) and bool((thr > 1.0).any())
    if Family.MONODISPERSE in rplan.families:
        half = float(np.float32(rplan.thr_const[0])) / 2
        theta = mom[1] / np.where(mom[0] > 0, mom[0], 1.0)
        assert (theta[mom[0] > 0] < half).any() and (theta[mom[0] > 0] >= half).any()
    x = ch.physical(rplan, mom, dtype)
    got = call(getattr(lib, f"host_rhs_{_tag(dtype)}"), x, 2 * rplan.n_tot)
    want = fc.rainshaft_rhs_soa_plain(x, rplan)
    assert bool(torch.isfinite(got).all())
    assert row_scaled(got, want, rplan, 2) < HOST_TOL[dtype]
    assert bool((got[:rplan.n_tot, 3] == 0).all())


def test_generated_reference_body_matches_pallas_interpret(host_libs):
    """The generated coalescence body of the fixed Simpson arm at 32
    series/CF iterations (as tests/test_torch_reference_tier.py's step) in
    f64 against `make_pallas_coal_fn` in interpret mode, 128 lanes."""
    arm = "fixed Simpson, 32 iterations"
    fams, thr, _, bkw, _ = ARMS[arm]
    jdata = jbuild(JSpec((JF.GAMMA, JF.GAMMA)), ch.ker(JK), thr, norms=NORMS, **bkw)
    _, rplan = arm_plans(arm)
    assert rplan.ref and rplan.gammainc_iters == 32
    mom = ch.arm_moments(fams, 128, seed=6)
    want = np.asarray(pc.make_pallas_coal_fn(jdata, block_cols=128, interpret=True)
                      .soa(jnp.asarray(mom)))
    got = call(host_libs(arm).host_coal_f64, torch.as_tensor(mom), 6).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) / np.maximum(scale, 1e-300)).max() < 1e-9


# --------------------------------------------------------------------------
# (c) the series early exit
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def series_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the series on the host")
    d = tmp_path_factory.mktemp("series")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text(ch.SHIM)
    (d / "series.cpp").write_text(SERIES)
    so = d / "libseries.so"
    subprocess.run([*ch._GXX, "-I", str(d / "shim"), "-I", str(_build.CSRC), "-o", str(so),
                    str(d / "series.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for f in (lib.series_f32, lib.series_f64):
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        f.restype = None
    return lib


def series_lanes(n, seed):
    """(a, x) of `n` seeded lanes: a ∈ [0.5, 16], x log-uniform in [1e-4,
    64] (both sides of a + 1), and lanes at x = 0, past the clamp and near
    the branch point (tools/reference_tune.py `series_lanes`)."""
    return reference_tune.series_lanes(n, seed)


@pytest.mark.parametrize("n_iters", [12, 128])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_series_exit_is_the_fixed_loop_bit_for_bit(series_lib, dtype, n_iters):
    """The lower series stopped where a term no longer changes the sum
    equals the fixed loop of n_iters terms, bit for bit, on 200,000 lanes of
    both branches (the continued fraction is the same code in both)."""
    a_np, x_np = series_lanes(200_000, seed=7)
    real_t = _real_t(dtype)
    a, x = a_np.astype(real_t), x_np.astype(real_t)
    f = series_lib.series_f32 if dtype == torch.float32 else series_lib.series_f64
    outs = []
    for ex in (0, 1):
        out = np.empty_like(a)
        f(a.ctypes.data, x.ctypes.data, out.ctypes.data, a.size, n_iters, ex)
        outs.append(out)
    series = (np.minimum(x, 1e6) < a + 1) & (x > 0)
    assert series.sum() > 20_000 and (~series).sum() > 20_000
    assert outs[0].tobytes() == outs[1].tobytes()
    assert np.isfinite(outs[0]).all() and ((outs[0] >= 0) & (outs[0] <= 1)).all()


# --------------------------------------------------------------------------
# (d) routes and flags
# --------------------------------------------------------------------------


def test_reference_routes_and_flags():
    """A reference plan's whole step, scaled step and fused RHS launch
    units generated for it; `_table` reaches the table-driven instances;
    B3's reference tier stays table-driven and codegen refuses its kind; a
    monodisperse plan builds without contraction, no other plan does."""
    VEL, NZ = ch.VEL, ch.NZ
    data, ckw = ch.arm_data("fixed Simpson")
    kw = dict(nz=NZ, dz=ch.DZ, dt=ch.DT, device="cpu", **ckw)
    step = fc.make_rainshaft_step_fn(data, VEL, NORMS, **kw)
    scaled = fc.make_rainshaft_step_fn(data, VEL, NORMS, kernel_scale=True, **kw)
    rhs = fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device="cpu")
    coal = fc.make_coal_fn(data, device="cpu")
    assert step.plan.ref and [f.route for f in (step, scaled, rhs)] == ["generated"] * 3
    assert (step.unit.kind, scaled.unit.kind, rhs.unit.kind) == ("step", "step", "rhs")
    assert scaled.unit.scaled and not step.unit.scaled and step.unit.shfl
    assert [f.build_units() for f in (step, scaled, rhs)] == [[step.unit], [scaled.unit],
                                                              [rhs.unit]]
    assert "kRef = true" in step.unit.cfg and "kRef = true" in rhs.unit.cfg
    assert step.caps is None and step.unit.flags == () and rhs.unit.flags == ()
    for fn in (step, scaled, rhs):
        table = type(fn)(fn.plan, "cpu", torch.float32, _table=True)
        assert table.route == "table" and table.unit is None and table.caps == fc.CAPS
    assert coal.route == "table" and coal.unit is None
    with pytest.raises(ValueError, match="B3's reference tier"):
        codegen.unit(coal.plan, torch.float32, "coal")
    mono, _ = ch.arm_data("mono + gamma")
    for fn in (fc.make_rainshaft_step_fn(mono, VEL, NORMS, nz=NZ, dz=ch.DZ, dt=ch.DT,
                                         device="cpu"),
               fc.make_rainshaft_rhs_fn(mono, VEL, NORMS, device="cpu")):
        assert fn.route == "generated" and fn.unit.flags == (codegen.NO_FMA,)
        assert fn.unit.digest != reference_tune.variant(fn.unit, series_exit=False).digest
    for arm in ARMS:
        if Family.MONODISPERSE not in ARMS[arm][0]:
            splan, rplan = arm_plans(arm)
            assert codegen.unit(splan, torch.float64).flags == ()
    x = torch.ones(6, NZ)  # on the host the twin runs and nothing launches
    step(x), rhs.soa(x)
    assert step.launches == rhs.launches == 0


@pytest.mark.parametrize("threads,want", [(None, codegen.REF_THREADS), (64, 64), (256, 256)])
def test_reference_step_block_size(threads, want):
    """The block size of a generated reference step: `REF_THREADS` (the
    measured choice, PERF.md §6), the fused RHS's `THREADS`; the
    measurements' variants at other sizes (tools/reference_tune.py
    `variant`) carry theirs in the configuration and the launch bounds,
    with a shuffle stencil at nz 8 for every size; a size that is no
    multiple of a warp raises."""
    splan, rplan = arm_plans("fixed Simpson")
    u = codegen.unit(splan, torch.float64)
    if threads is not None:
        u = reference_tune.variant(u, threads=threads)
    assert (u.threads, u.shfl) == (want, True)
    assert f"static constexpr int kThreads = {want};" in u.cfg
    assert f"CLOUDY_GEN_BOUNDS({want})" in u.source
    assert codegen.unit(rplan, torch.float64, "rhs").threads == codegen.THREADS
    with pytest.raises(ValueError, match="multiple of a warp"):
        reference_tune.variant(codegen.unit(splan, torch.float64), threads=48)
