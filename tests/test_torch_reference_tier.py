"""The reference tier of the fused coalescence kernels' plain twins against
the JAX package: quadrature-grid F2 (the masked log-grid Simpson rule and
Gauss–Legendre, on fixed and per-lane moving grids), the series/continued-
fraction incomplete gamma, the damped-Newton percentile inverse and the
Lanczos-pair flux — the default of every JAX kernel factory.

The twins (`ops.fused_coalescence`) are held against the Pallas kernels in
interpret mode at the sizes tests/test_pallas.py uses, f64, row-scaled 1e-9
(each output row over its largest magnitude: the node sums run in another
order, and near-empty rows sit ~1e-20 below their scale). Where interpret
mode is too slow (a whole step with the MovingThreshold Newton inverse,
tests/test_pallas.py:603), the twin is held against JAX's XLA path, which
tests/test_pallas.py pins to the Pallas kernel.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu import stepper as jstepper
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.coalescence import get_coal_ints as jget_coal_ints
from cloudy_tpu.coalescence import make_coal_rhs as jmake_coal_rhs
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch import stepper
from cloudy_tpu_torch.coalescence import build_coalescence_data, make_coal_rhs
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
TOL = 1e-9
G2 = ("GAMMA", "GAMMA")
EG = ("EXPONENTIAL", "GAMMA")


def _data(families, thresholds, moving=False, **kw):
    """(JAX data, port data) of the Golovin 5.0 kernel at order 1."""
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    jd = jbuild(JSpec(tuple(JF[f] for f in families)), jker, thresholds,
                norms=NORMS, moving=moving, **kw)
    td = build_coalescence_data(SpectrumSpec(tuple(Family[f] for f in families)), ker,
                                thresholds, norms=NORMS, moving=moving, **kw)
    return jd, td


def _moments(families, B, seed):
    """Normalized moments [B, n_tot] from parameters drawn first
    (tests/test_pallas.py:22-35)."""
    rng = np.random.default_rng(seed)
    params = np.stack([np.stack([rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                                 rng.uniform(0.5, 5.0, B)], -1) for _ in families], axis=1)
    spec = JSpec(tuple(JF[f] for f in families))
    return np.asarray(jpd.get_moments(spec, jnp.asarray(params)))


def _row_scaled(got, want, axis=0):
    """max over rows of |got − want| / max|want| of the row; rows lie along
    `axis` of [B, n] (axis 0) or are the first axis of [n, B] (axis 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=axis)
    scale = np.maximum(np.abs(want).max(axis=axis), 1e-300)
    return float((d / scale).max())


COAL_CASES = {
    # name: (families, thresholds, moving, B, seed, build kwargs, call kwargs)
    "fixed_two_gamma": (G2, (5e-10, np.inf), False, 256, 0, {}, {}),
    "exp_gamma": (EG, (5e-10, np.inf), False, 128, 0, {}, {}),
    "moving_two_gamma": (G2, (0.9, 1.0), True, 64, 17, {}, {}),
    "exact_series_cf": (G2, (5e-10, np.inf), False, 128, 17, {"f2_exact": True}, {}),
    "gauss_fixed": (G2, (5e-10, np.inf), False, 128, 5, {}, {"quad_rule": "gauss"}),
    "gauss_moving": (G2, (0.9, 1.0), True, 64, 19, {}, {"quad_rule": "gauss"}),
    # bench.py's quadrature fallback (BENCH_F2_EXACT=0) and its series/CF
    # switch (BENCH_GL_NODES=0), at its overrides
    "bench_gauss_fallback": (G2, (5e-10, np.inf), False, 128, 3,
                             {"gammainc_iters": 12, "gammainc_gl_nodes": 12},
                             {"quad_rule": "gauss", "gauss_nodes": 12, "gammainc_iters": 12}),
    "bench_exact_series": (G2, (5e-10, np.inf), False, 128, 3,
                           {"gammainc_iters": 12, "f2_exact": True},
                           {"quad_rule": "gauss", "gauss_nodes": 12, "gammainc_iters": 12}),
    "bench_grid_series": (G2, (5e-10, np.inf), False, 128, 3, {"gammainc_iters": 12},
                          {"quad_rule": "gauss", "gauss_nodes": 12, "gammainc_iters": 12}),
}


@pytest.mark.parametrize("case", sorted(COAL_CASES))
def test_coal_twin_matches_pallas(case):
    """B3's twin against `make_pallas_coal_fn` in interpret mode at the
    reference tier: every arm, each configuration launching the kernels'
    reference-tier instance."""
    families, thresholds, moving, B, seed, bkw, ckw = COAL_CASES[case]
    jd, td = _data(families, thresholds, moving, **bkw)
    mom = _moments(families, B, seed)
    want = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=B, interpret=True, **ckw)(
        jnp.asarray(mom)))
    fn = fc.make_coal_fn(td, device="cpu", dtype=torch.float64, **ckw)
    assert fn.plan.instance == 2
    got = fn(torch.as_tensor(mom.copy())).numpy()
    assert np.isfinite(got).all()
    assert _row_scaled(got, want) < TOL
    if moving:
        # lanes on both sides of T = 1 (x_lo = 1e-5·T below, 1e-5 above);
        # the moving Simpson grid's bin count per lane
        thr = fc.moving_thresholds(fn.plan, torch.as_tensor(mom.T.copy()))[0]
        assert bool((thr < 1.0).any()) and bool((thr > 1.0).any())
        nb = fc.moving_bins(thr)
        print(f"{case}: nb {sorted(set(nb.tolist()))}, T in "
              f"[{float(thr.min()):.3e}, {float(thr.max()):.3e}]")
        assert bool((nb[thr < 1.0] == 75).all())


def test_coal_twin_degenerate_columns():
    """Empty columns and an empty second mode at the reference tier
    (tests/test_pallas.py:81-91): exact zeros where JAX gives them."""
    jd, td = _data(G2, (5e-10, np.inf))
    mom = np.zeros((128, 6))
    mom[0] = [1e2, 1e1, 2e0, 0, 0, 0]
    want = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=128, interpret=True)(
        jnp.asarray(mom)))
    got = fc.make_coal_fn(td, device="cpu", dtype=torch.float64)(torch.as_tensor(mom)).numpy()
    assert _row_scaled(got, want) < TOL
    np.testing.assert_array_equal(got[1:], 0.0)


def test_moving_exp_gamma_twin_matches_xla():
    """MovingThreshold exponential + gamma (the exponential threshold
    θ·(−log1p(−p)), its F2 on the per-lane Simpson grid with k = 1) against
    JAX's XLA path (tests/test_pallas.py:208-255 runs this case slow)."""
    jd, td = _data(EG, (0.9, 1.0), moving=True)
    mom = _moments(EG, 64, 23)
    spec = JSpec((JF.EXPONENTIAL, JF.GAMMA))
    want = np.asarray(jax.jit(lambda m: jget_coal_ints(jd, jpd.params_from_moments(spec, m)))(
        jnp.asarray(mom)))
    got = fc.make_coal_fn(td, device="cpu", dtype=torch.float64)(
        torch.as_tensor(mom.copy())).numpy()
    assert _row_scaled(got, want) < TOL


def _column_state(n_cols, nz, seed=23):
    """[n_cols, nz, 6] physical two-gamma states: both modes seeded (an
    empty second mode leaves only promotion dust, a comparison of knife-edge
    noise; tests/test_pallas.py:622-629), per-column amplitudes, a negative
    moment and a whole negative level."""
    z = (np.arange(nz) + 0.5) * 3000.0 / nz
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12]),
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 2)).repeat(3, axis=2)
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, nz // 2, 0] *= -1.0
    st[1, nz // 2 + 1, :] = -1e-3
    return st


def test_rhs_twin_matches_pallas():
    """B4's twin at the reference tier (Simpson grid, series/CF at 128
    iterations, the Lanczos-pair flux) against `make_pallas_rainshaft_rhs_fn`
    in interpret mode (tests/test_pallas.py:442-467), 8 columns × 16 levels;
    rows normalized by their moment norms."""
    jd, td = _data(G2, (5e-10, np.inf))
    config = rs.RainshaftConfig(spec=td.spec, nz=16, zmax=3000.0, norms=NORMS)
    state = rs.to_soa(torch.as_tensor(_column_state(8, 16)))
    want = np.asarray(pc.make_pallas_rainshaft_rhs_fn(
        jd, config.vel, NORMS, block_cols=128, interpret=True).soa(jnp.asarray(state.numpy())))
    fn = fc.make_rainshaft_rhs_fn(td, config.vel, NORMS, device="cpu", dtype=torch.float64)
    assert fn.plan.instance == 2 and fn.plan.gl_nodes == 0
    got = fn.soa(state).numpy()
    norm = np.asarray(fn.plan.mom_norms * 2)[:, None]
    assert _row_scaled(got / norm, want / norm, axis=1) < TOL


def test_step_twin_matches_pallas():
    """B1's twin, one whole SSPRK33 step at the reference tier (fixed
    Simpson grid, series/CF, Lanczos flux), against
    `make_pallas_rainshaft_step_fn` in interpret mode at nz 16, 8 columns
    (tests/test_pallas.py:606-657). The series/CF runs 32 iterations (a
    per-call override of both): interpret mode traces the three RHS of 128
    unrolled iterations in ~28 s per call; B4's test holds 128."""
    jd, td = _data(G2, (5e-10, np.inf))
    config = rs.RainshaftConfig(spec=td.spec, nz=16, zmax=3000.0, norms=NORMS)
    state = rs.to_soa(torch.as_tensor(_column_state(8, 16)))
    kw = dict(gammainc_iters=32)
    want = np.asarray(pc.make_pallas_rainshaft_step_fn(
        jd, config.vel, NORMS, nz=16, dz=config.dz, dt=1.0, block_cols=128,
        interpret=True, **kw)(jnp.asarray(state.numpy())))
    fn = fc.make_rainshaft_step_fn(td, config.vel, NORMS, nz=16, dz=config.dz, dt=1.0,
                                   device="cpu", dtype=torch.float64, **kw)
    assert fn.plan.instance == 2 and fn.plan.gammainc_iters == 32
    got = fn(state).numpy()
    assert _row_scaled(got, want, axis=1) < TOL


def test_moving_step_twin_matches_xla_step():
    """B1's twin at the reference tier under MovingThreshold (per-lane
    Newton inverse at 32 × 128 iterations, per-lane Simpson grid) against
    JAX's XLA-orchestrated rainshaft RHS (`make_rainshaft_rhs`, through
    `get_coal_ints`) and `ssprk33_step`, 4 columns × 16 levels."""
    jd, td = _data(G2, (0.9, 1.0), moving=True)
    config = rs.RainshaftConfig(spec=td.spec, nz=16, zmax=3000.0, norms=NORMS)
    jconfig = jrs.RainshaftConfig(spec=jd.spec, nz=16, zmax=3000.0, norms=NORMS)
    st = _column_state(4, 16)
    jrhs = jax.jit(jrs.make_rainshaft_rhs(jconfig, jd))  # one trace for the 3 stages
    want = np.asarray(jstepper.ssprk33_step(jrhs, jnp.asarray(st), 0.0, 1.0))
    fn = fc.make_rainshaft_step_fn(td, config.vel, NORMS, nz=16, dz=config.dz, dt=1.0,
                                   device="cpu", dtype=torch.float64)
    got = rs.from_soa(fn(rs.to_soa(torch.as_tensor(st))), 16).numpy()
    assert _row_scaled(got.reshape(-1, 6), want.reshape(-1, 6)) < TOL


def test_hook_rhs_matches_jax():
    """The `coal_fn` hook of `make_rainshaft_rhs` (JAX models/rainshaft.py:
    64-120): the port's RHS with the coalescence kernel's wrapper (its twin
    on the CPU) against JAX's with the Pallas kernel in interpret mode, 4
    columns × 32 levels, the default tier."""
    jd, td = _data(G2, (5e-10, np.inf))
    config = rs.RainshaftConfig(spec=td.spec, nz=32, zmax=3000.0, norms=NORMS)
    jconfig = jrs.RainshaftConfig(spec=jd.spec, nz=32, zmax=3000.0, norms=NORMS)
    st = _column_state(4, 32)
    jfn = pc.make_pallas_coal_fn(jd, block_cols=128, interpret=True)
    want = np.asarray(jrs.make_rainshaft_rhs(jconfig, jd, coal_fn=jfn)(jnp.asarray(st), 0.0))
    fn = fc.make_coal_fn(td, device="cpu", dtype=torch.float64)
    got = rs.make_rainshaft_rhs(config, td, coal_fn=fn)(torch.as_tensor(st), 0.0).numpy()
    assert _row_scaled(got.reshape(-1, 6), want.reshape(-1, 6)) < TOL
    # and against the port's own torch-ops path
    ops = rs.make_rainshaft_rhs(config, td)(torch.as_tensor(st), 0.0).numpy()
    assert _row_scaled(got.reshape(-1, 6), ops.reshape(-1, 6)) < TOL


def test_make_coal_rhs_matches_jax():
    """`coalescence.make_coal_rhs` (JAX coalescence.py:730-744) on physical
    moments of the exponential + gamma box, f64."""
    jd, td = _data(EG, (5e-10, np.inf))
    norm = np.asarray([1e6, 1e-3, 1e6, 1e-3, 1e-12])
    mom = _moments(EG, 16, 29) * norm
    want = np.asarray(jax.jit(jmake_coal_rhs(jd, NORMS))(jnp.asarray(mom)))
    got = make_coal_rhs(td, NORMS)(torch.as_tensor(mom.copy())).numpy()
    assert _row_scaled(got, want) < TOL


@pytest.mark.parametrize("family", ["EXPONENTIAL", "GAMMA"])
def test_analytical_sol_sedimentation_matches_jax(family):
    """The semi-analytic pure-sedimentation profiles (JAX rainshaft.py:198)
    at 8 levels (tests/test_rainshaft.py:52-83 uses 60): the same numpy, so
    the same numbers."""
    nm = 2 if family == "EXPONENTIAL" else 3
    config = rs.RainshaftConfig(spec=SpectrumSpec((Family[family],)), nz=8,
                                zmax=3000.0, norms=(1.0, 1.0),
                                vel=((10.0, 0.0), (10.0, 1.0 / 6.0)), t_end=20.0, dt=0.5)
    jconfig = jrs.RainshaftConfig(spec=JSpec((JF[family],)), nz=8, zmax=3000.0,
                                  norms=(1.0, 1.0), vel=((10.0, 0.0), (10.0, 1.0 / 6.0)),
                                  t_end=20.0, dt=0.5)
    ic = rs.initial_condition(config.z, [1.0, 1.0, 2.0][:nm])
    want = jrs.analytical_sol_sedimentation(jconfig, JF[family], ic, (10.0, 10.0), 20.0)
    got = rs.analytical_sol_sedimentation(config, Family[family], ic, (10.0, 10.0), 20.0)
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0.0)


def test_overrides_match_pallas():
    """The per-call overrides reach the twin as they reach the Pallas
    kernel: a moving configuration at 8 Newton steps of 16 series/CF
    iterations, 20 F2 iterations and 16 Gauss nodes."""
    jd, td = _data(G2, (0.9, 1.0), moving=True)
    kw = dict(quad_rule="gauss", gauss_nodes=16, gammainc_iters=20, thr_newton_iters=8,
              thr_gammainc_iters=16)
    mom = _moments(G2, 64, 31)
    want = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=64, interpret=True, **kw)(
        jnp.asarray(mom)))
    fn = fc.make_coal_fn(td, device="cpu", dtype=torch.float64, **kw)
    plan = fn.plan
    assert (plan.quad_rule, plan.gauss_nodes, plan.gammainc_iters, plan.thr_newton_iters,
            plan.thr_gammainc_iters) == ("gauss", 16, 20, 8, 16)
    got = fn(torch.as_tensor(mom.copy())).numpy()
    assert _row_scaled(got, want) < TOL
    default = fc.make_coal_fn(td, device="cpu", dtype=torch.float64)(
        torch.as_tensor(mom.copy())).numpy()
    assert _row_scaled(got, default) > 1e-6  # the overrides change the result


def test_override_defaults_and_unknown_keys():
    """None takes the data's value (`gammainc_iters`, `f2_exact`,
    `gammainc_gl_nodes`), the rest default as `make_pallas_coal_fn`'s; an
    unknown key raises `TypeError` in every factory, as the JAX ones do."""
    _, td = _data(G2, (5e-10, np.inf), gammainc_iters=40)
    plan = fc.build_plan(td)
    assert (plan.quad_rule, plan.gauss_nodes, plan.gammainc_iters, plan.thr_newton_iters,
            plan.thr_gammainc_iters, plan.gl_nodes) == ("reference", 24, 40, 32, 128, 0)
    assert plan.f2_kind == (fc.F2_GRID, fc.F2_NONE) and plan.instance == 2
    assert len(plan.grids[0][0]) == 76 and plan.grids[1] is None
    exact = fc.build_plan(td, f2_exact=True, gammainc_gl_nodes=12, gammainc_iters=None)
    assert exact.f2_kind[0] == fc.F2_EXACT and exact.instance == 0
    assert exact.gammainc_iters == 40
    vel = ((50.0, 1.0 / 6.0),)
    for make in (lambda **k: fc.make_coal_fn(td, device="cpu", **k),
                 lambda **k: fc.make_rainshaft_rhs_fn(td, vel, NORMS, device="cpu", **k),
                 lambda **k: fc.make_rainshaft_step_fn(td, vel, NORMS, nz=16, dz=1.0,
                                                       dt=1.0, device="cpu", **k)):
        with pytest.raises(TypeError, match="unknown kwargs"):
            make(quad_rul="gauss")
        with pytest.raises(ValueError, match="quad_rule"):
            make(quad_rule="simpson")
    # the scaled whole step takes the reference tier too (JAX's `fn_scaled`)
    scaled = fc.make_rainshaft_step_fn(td, vel, NORMS, nz=16, dz=1.0, dt=1.0, device="cpu",
                                       kernel_scale=True)
    assert isinstance(scaled, fc.ScaledRainshaftStepFn) and scaled.plan.instance == 2


def test_rainshaft_soa_kernel_route_matches_hook():
    """The three routes through one reference-tier configuration agree: 5
    steps of B1's twin, of `make_rainshaft_rhs_fused` over B4's twin, and of
    the AoS hook over B3's twin (2 columns × 16 levels, f64)."""
    _, td = _data(G2, (5e-10, np.inf))
    config = rs.RainshaftConfig(spec=td.spec, nz=16, zmax=3000.0, norms=NORMS)
    st = torch.as_tensor(_column_state(2, 16))
    step = fc.make_rainshaft_step_fn(td, config.vel, NORMS, nz=16, dz=config.dz, dt=1.0,
                                     device="cpu", dtype=torch.float64)
    fused = rs.make_rainshaft_rhs_fused(
        config, fc.make_rainshaft_rhs_fn(td, config.vel, NORMS, device="cpu",
                                         dtype=torch.float64))
    hook = rs.make_rainshaft_rhs(
        config, td, coal_fn=fc.make_coal_fn(td, device="cpu", dtype=torch.float64))
    y1 = y2 = rs.to_soa(st)
    y3 = st
    for _ in range(5):
        y1 = step(y1)
        y2 = stepper.ssprk33_step(fused, y2, 0.0, 1.0)
        y3 = stepper.ssprk33_step(hook, y3, 0.0, 1.0)
    a, b = y1.numpy(), y2.numpy()
    c = rs.to_soa(y3).numpy()
    assert _row_scaled(a, b, axis=1) < TOL and _row_scaled(a, c, axis=1) < TOL


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_moving_bins_match_jax(dtype):
    """The moving Simpson grid's bin count ⌊15·log10(T / x_lo)⌋ sits on the
    integer 75 for every T ≤ 1: the twin's count equals the Pallas body's
    (`jnp.log10`) on 100,000 thresholds on both sides of T = 1."""
    rng = np.random.default_rng(37)
    t = np.concatenate([rng.uniform(1e-3, 1.0, 50000), rng.uniform(1.0, 50.0, 50000)])
    t = t.astype(dtype)
    tj = jnp.asarray(t)
    x_lo = jnp.minimum(jnp.asarray(1e-5, tj.dtype), 1e-5 * tj)
    want = np.asarray(jnp.floor(15.0 * jnp.log10(tj / x_lo)))
    got = fc.moving_bins(torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:50000] == 75).all()
