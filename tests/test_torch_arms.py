"""The monodisperse and lognormal-Φ-grid arms of the fused coalescence
kernels' plain twins against the JAX package, and the port of the
whole-step family matrix (tools/whole_step_ablation.py).

- B-arms.3, monodisperse modes: the closure (exponential algebra), the
  recurrence M_{p+1} = M_p·θ, the moving threshold θ, the closed-form F2
  M_p·M_q where θ < T/2 (pallas_coalescence.py:556-568) and the flux
  ladder n·θ^e, t·θ;
- B-arms.4, the lognormal Φ grid (`_f2_lognormal`, :458-496) on the fixed
  Simpson and Gauss grids and on the per-lane moving ones, erf by the
  series/CF P(½, z²) or the rational `erf_approx`.

B3's twin is held against JAX's XLA path `get_coal_ints` (rtol 1e-10 / atol
1e-12, f64, tests/test_pallas.py:142-170's tolerance; the XLA path runs the
reference Simpson grid, so Gauss-grid cases go to the Pallas kernel only),
and against `make_pallas_coal_fn` in interpret mode at 32 series/CF
iterations (a per-call override: interpret mode re-traces every call),
row-scaled 1e-9. B1's and B4's twins are held against the Pallas whole step
and fused RHS in interpret mode, one step, 8 columns × 8 levels, f64.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.coalescence import get_coal_ints as jget_coal_ints
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import whole_step_ablation as wsa

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMS = (1e6, 1e-9)
TOL = 1e-9
FIXED3 = (2e-10, 5e-10, np.inf)
#: parameter ranges per family (tests/test_pallas.py:113-207): n, then p1
#: and p2 (lognormal μ, σ; monodisperse and exponential θ and an unused 0)
RANGES = {
    "GAMMA": ((0.05, 5.0), (0.5, 5.0)),
    "LOGNORMAL": ((-2.0, 0.5), (0.3, 1.2)),
    # θ on both sides of T/2 = 0.25 (the normalized threshold 0.5)
    "MONODISPERSE": ((0.05, 0.6), None),
    "EXPONENTIAL": ((0.02, 0.5), None),
}
#: name: (families, thresholds, moving, build kwargs, call kwargs); the
#: configurations of chip_smoke.py phase 20(a)
ARM_CASES = {
    "mono_gamma_fixed": (("MONODISPERSE", "GAMMA"), (5e-10, np.inf), False, {}, {}),
    "mono_gamma_moving": (("MONODISPERSE", "GAMMA"), (0.9, 1.0), True, {}, {}),
    "gamma_mono_last": (("GAMMA", "MONODISPERSE"), (5e-10, np.inf), False, {}, {}),
    "lognorm_simpson_series": (("LOGNORMAL", "GAMMA"), (5e-10, np.inf), False, {}, {}),
    "lognorm_gauss_approx": (("LOGNORMAL", "GAMMA"), (5e-10, np.inf), False,
                             {"gammainc_gl_nodes": 12}, {"quad_rule": "gauss",
                                                         "gauss_nodes": 12}),
    "lognorm_moving_simpson": (("LOGNORMAL", "GAMMA"), (0.9, 1.0), True, {}, {}),
    "lognorm_moving_gauss": (("LOGNORMAL", "GAMMA"), (0.9, 1.0), True,
                             {"gammainc_gl_nodes": 12}, {"quad_rule": "gauss",
                                                         "gauss_nodes": 12}),
    "exp_lognorm_gamma": (("EXPONENTIAL", "LOGNORMAL", "GAMMA"), FIXED3, False, {}, {}),
}


def _data(families, thresholds, moving=False, **kw):
    """(JAX data, port data) of the Golovin 5.0 kernel at order 1."""
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    jd = jbuild(JSpec(tuple(JF[f] for f in families)), jker, thresholds, norms=NORMS,
                moving=moving, **kw)
    td = build_coalescence_data(SpectrumSpec(tuple(Family[f] for f in families)), ker,
                                thresholds, norms=NORMS, moving=moving, **kw)
    return jd, td


def _moments(families, B, seed):
    """Normalized moments [B, n_tot] from parameters drawn first."""
    rng = np.random.default_rng(seed)
    cols = []
    for f in families:
        r1, r2 = RANGES[f]
        cols.append(np.stack([rng.uniform(10, 200, B), rng.uniform(*r1, B),
                              rng.uniform(*r2, B) if r2 else np.zeros(B)], -1))
    spec = JSpec(tuple(JF[f] for f in families))
    return np.asarray(jpd.get_moments(spec, jnp.asarray(np.stack(cols, axis=1))))


def _row_scaled(got, want, axis=0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=axis)
    return float((d / np.maximum(np.abs(want).max(axis=axis), 1e-300)).max())


@pytest.mark.parametrize("case", [c for c in sorted(ARM_CASES)
                                  if "quad_rule" not in ARM_CASES[c][4]])
def test_coal_twin_matches_xla(case):
    """B3's twin against JAX's XLA path (`get_coal_ints`) at 128 boxes;
    every configuration selects the kernels' reference-tier instance."""
    families, thresholds, moving, bkw, ckw = ARM_CASES[case]
    jd, td = _data(families, thresholds, moving, **bkw)
    mom = _moments(families, 128, 7)
    spec = JSpec(tuple(JF[f] for f in families))
    want = np.asarray(jax.jit(lambda m: jget_coal_ints(jd, jpd.params_from_moments(spec, m)))(
        jnp.asarray(mom)))
    fn = fc.make_coal_fn(td, device="cpu", dtype=torch.float64, **ckw)
    assert fn.plan.instance == 2
    got = fn(torch.as_tensor(mom.copy())).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    if case == "mono_gamma_fixed":
        # lanes on both sides of the knife edge θ < T/2
        theta = mom[:, 1] / mom[:, 0]
        assert (theta < 0.25).any() and (theta > 0.25).any()


@pytest.mark.parametrize("case", ["mono_gamma_fixed", "mono_gamma_moving",
                                  "lognorm_simpson_series", "lognorm_gauss_approx",
                                  "lognorm_moving_simpson", "lognorm_moving_gauss"])
def test_coal_twin_matches_pallas(case):
    """B3's twin against `make_pallas_coal_fn` in interpret mode at 128
    boxes, both at 32 series/CF iterations."""
    families, thresholds, moving, bkw, ckw = ARM_CASES[case]
    jd, td = _data(families, thresholds, moving, **bkw)
    kw = dict(ckw, gammainc_iters=32)
    mom = _moments(families, 128, 11)
    want = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=128, interpret=True, **kw)(
        jnp.asarray(mom)))
    fn = fc.make_coal_fn(td, device="cpu", dtype=torch.float64, **kw)
    assert fn.plan.instance == 2
    got = fn(torch.as_tensor(mom.copy())).numpy()
    assert np.isfinite(got).all()
    assert _row_scaled(got, want) < TOL


def _step_state(families, n_cols, nz, seed=3):
    """[6, n_cols·nz] physical states of a family-matrix case: the mode-1
    pulse, a seeded second mode (gamma), per-column amplitudes, a negative
    moment and a whole negative level."""
    z = (np.arange(nz) + 0.5) * 3000.0 / nz
    n1 = SpectrumSpec(tuple(Family[f] for f in families)).nprogmoms[0]
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12])[:, :n1],
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 1))
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, nz // 2, 0] *= -1.0
    st[1, nz // 2 + 1, :] = -1e-3
    return rs.to_soa(torch.as_tensor(st))


@pytest.mark.parametrize("name", ["mono-gamma-closed", "lognorm-gamma-grid"])
@pytest.mark.parametrize("kind", ["step", "rhs"])
def test_step_and_rhs_twins_match_pallas(name, kind):
    """B1's twin (one whole step) and B4's (the fused per-level RHS, rows
    over their moment norms) against the Pallas kernels in interpret mode,
    8 columns × 8 levels, f64, at the family-matrix case's configuration."""
    nz = 8
    config, step = wsa.build_case(name, nz, "cpu", torch.float64)
    td, kw = wsa.case_data(name)
    _, fams, thr, moving, f2x, _ = wsa.CASES[wsa.CASE_NAMES.index(name)]
    jd, _ = _data(tuple(f.name for f in fams), thr, moving, gammainc_iters=12,
                  f2_exact=f2x, gammainc_gl_nodes=12)
    assert step.plan.instance == 2
    state = _step_state(tuple(f.name for f in fams), 8, nz)
    if kind == "step":
        want = np.asarray(pc.make_pallas_rainshaft_step_fn(
            jd, config.vel, NORMS, nz=nz, dz=config.dz, dt=1.0, block_cols=64,
            interpret=True, **kw)(jnp.asarray(state.numpy())))
        got = step(state).numpy()
        assert _row_scaled(got, want, axis=1) < TOL
    else:
        want = np.asarray(pc.make_pallas_rainshaft_rhs_fn(
            jd, config.vel, NORMS, block_cols=64, interpret=True, **kw).soa(
                jnp.asarray(state.numpy())))
        fn = fc.make_rainshaft_rhs_fn(td, config.vel, NORMS, device="cpu",
                                      dtype=torch.float64, **kw)
        got = fn.soa(state).numpy()
        norm = np.asarray(fn.plan.mom_norms * 2)[:, None]
        assert _row_scaled(got / norm, want / norm, axis=1) < TOL
    assert np.isfinite(got).all()


def test_family_matrix_cases_match_the_jax_tool():
    """The port's case table is the JAX tool's (tools/whole_step_ablation.py:
    52-86, read with `ast`, not imported)."""
    src = open(os.path.join(ROOT, "tools", "whole_step_ablation.py")).read()
    cases = None
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "cases" and isinstance(node.value, ast.List)):
            cases = node.value
    assert cases is not None

    def literal(n):
        if isinstance(n, ast.Attribute):  # Family.X, np.inf
            return n.attr
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "dict":
            return {k.arg: ast.literal_eval(k.value) for k in n.keywords}
        if isinstance(n, ast.Tuple):
            return tuple(literal(e) for e in n.elts)
        if isinstance(n, ast.Dict) and not n.keys:
            return {}
        return ast.literal_eval(n)

    want = [literal(c) for c in cases.elts]
    got = [(name, tuple(f.name for f in fams),
            tuple("inf" if t == float("inf") else t for t in thr), moving, f2x, kw)
           for name, fams, thr, moving, f2x, kw in wsa.CASES]
    assert got == want
    assert len(got) == 9


def test_family_matrix_cli_on_the_host():
    """`python -m cloudy_tpu_torch.tools.whole_step_ablation --device cpu
    --columns 64 --nz 8` prints nine finite records (one timed run per
    chain, to keep it short); the reference-tier cases select that
    instance."""
    res = subprocess.run(
        [sys.executable, "-m", "cloudy_tpu_torch.tools.whole_step_ablation", "--device", "cpu",
         "--columns", "64", "--nz", "8", "--reps", "1"],
        capture_output=True, text=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        timeout=300)
    assert res.returncode == 0, res.stderr
    recs = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert [r["name"] for r in recs] == list(wsa.CASE_NAMES)
    for r in recs:
        assert r["finite"] and r["device"] == "cpu" and r["clock"] == "host"
        assert np.isfinite([r["column_updates_per_s"], r["ms_per_step"], r["bound_ms"]]).all()
        assert r["n_columns"] == 64 and r["nz"] == 8 and r["n2"] >= r["n1"] + 8
        assert r["launches"] == 0 and r["bound_share"] is None  # the twin ran, on the host
    inst = {r["name"]: r["instance"] for r in recs}
    assert inst["mono-gamma-closed"] == inst["lognorm-gamma-grid"] == "reference tier"
    assert inst["2gamma-exact"] == "fast" and inst["lognorm-gamma-window"] == "fast with arms"


def test_packed_config_arms():
    """A monodisperse mode packs F2_MONO and no grid; a thresholded
    lognormal mode without the window rule packs F2_GRID with its fixed
    Simpson (76 points at T = 0.5) or Gauss grid; three modes with two
    Simpson grids fit the buffer in f64."""
    _, td = _data(("MONODISPERSE", "GAMMA"), (5e-10, np.inf))
    plan = fc.build_plan(td)
    assert plan.f2_kind == (fc.F2_MONO, fc.F2_NONE) and plan.grids == (None, None)
    assert plan.ref and plan.instance == 2
    ints = fc.pack_config(plan, torch.float64).view(np.int32)
    assert list(ints[16:22]) == [fc.F2_MONO, fc.F2_NONE, 0, 0, 0, 0]
    _, td = _data(("LOGNORMAL", "GAMMA"), (5e-10, np.inf))
    plan = fc.build_plan(td)
    assert plan.f2_kind == (fc.F2_GRID, fc.F2_NONE) and len(plan.grids[0][0]) == 76
    ints = fc.pack_config(plan, torch.float64).view(np.int32)
    assert list(ints[16:22]) == [fc.F2_GRID, fc.F2_NONE, 0, 76, 0, 0]
    gauss = fc.build_plan(td, quad_rule="gauss", gauss_nodes=12)
    assert len(gauss.grids[0][0]) == 12 and gauss.grids[0][2] == 1.0
    # the window rule wins where lognorm_gl_nodes > 0, whatever f2_exact
    _, tw = _data(("LOGNORMAL", "GAMMA"), (5e-10, np.inf), lognorm_gl_nodes=16)
    assert fc.build_plan(tw).f2_kind[0] == fc.F2_WINDOW
    _, t3 = _data(("EXPONENTIAL", "LOGNORMAL", "GAMMA"), FIXED3)
    three = fc.build_plan(t3)
    assert three.f2_kind == (fc.F2_GRID, fc.F2_GRID, fc.F2_NONE)
    assert fc.pack_config(three, torch.float64).size <= 12288  # within 12 KB


def test_moving_mono_f2_is_zero_and_knife_edge():
    """Under MovingThreshold a monodisperse mode's threshold is θ itself, so
    θ < T/2 never holds and its F2 is zero (the clamp leaves M_p·M_q out);
    under FixedThreshold the closed form flips exactly at θ = T/2."""
    _, td = _data(("MONODISPERSE", "GAMMA"), (0.9, 1.0), moving=True)
    plan = fc.build_plan(td)
    mom = torch.as_tensor(_moments(("MONODISPERSE", "GAMMA"), 16, 5).T.copy())
    thr = fc.moving_thresholds(plan, mom)[0]
    torch.testing.assert_close(thr, mom[1] / mom[0], rtol=0, atol=0)
    _, tf = _data(("MONODISPERSE", "GAMMA"), (5e-10, np.inf))
    fn = fc.make_coal_fn(tf, device="cpu", dtype=torch.float64)
    # θ = 0.25 exactly (T/2) and one ulp below: the closed form switches on
    x = torch.tensor([[100.0, 100.0], [25.0, np.nextafter(25.0, 0.0)],
                      [50.0, 50.0], [5.0, 5.0], [10.0, 10.0]], dtype=torch.float64)
    out = fn.soa(x)
    assert not torch.equal(out[:, 0], out[:, 1])


def test_opcount_family_matrix():
    """`tools.opcount` counts every family-matrix case (the bound each
    record carries, `step_bound`); the closed form is the cheapest arm, the
    24-node window the dearest."""
    ops = {}
    for name in wsa.CASE_NAMES:
        config, step = wsa.build_case(name, 8, "cpu")
        state = wsa.initial_state(config, 2, "cpu")
        bnd = wsa.step_bound(step, state, 16, 8)
        assert np.isfinite(bnd["bound_ms"]) and bnd["bound_ms"] > 0
        ops[name] = bnd["ops_per_lane"]
    assert all(np.isfinite(v) and v > 0 for v in ops.values())
    assert min(ops, key=ops.get) == "mono-gamma-closed"
    assert max(ops, key=ops.get) == "lognorm-gamma-window24"


@pytest.mark.parametrize("name", ["mono-gamma-closed", "lognorm-gamma-grid"])
def test_scaled_step_refuses_the_reference_tier_arms(name):
    """The scaled whole step (B1s) no longer refuses the reference tier: a
    monodisperse or Φ-grid configuration builds the scaled step on a unit
    generated for its reference-tier plan (as JAX's `fn_scaled` takes any
    tier), and at s = 1 its twin is the unscaled step's, bit for bit."""
    data, kw = wsa.case_data(name)
    args = (data, ((50.0, 1.0 / 6.0),), NORMS)
    skw = dict(nz=8, dz=375.0, dt=1.0, device="cpu", dtype=torch.float64, **kw)
    scaled = fc.make_rainshaft_step_fn(*args, kernel_scale=True, **skw)
    assert isinstance(scaled, fc.ScaledRainshaftStepFn)
    assert scaled.route == "generated" and scaled.plan.instance == 2 and scaled.unit.scaled
    x = torch.as_tensor(_moments(tuple(Family(int(f)).name for f in data.spec.families),
                                 16, 3).T.copy()) * torch.tensor(
                                     scaled.plan.mom_norms, dtype=torch.float64)[:, None]
    unscaled = fc.make_rainshaft_step_fn(*args, **skw)
    torch.testing.assert_close(scaled(x, 1.0), unscaled(x), rtol=0, atol=0)
    assert scaled.launches == unscaled.launches == 0
