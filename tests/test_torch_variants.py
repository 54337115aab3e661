"""The pod `moving` and `lognorm` variants of the port against the JAX package
on the same inputs (f64, drawn from a numpy seed):

- closure, moments and percentile thresholds (`distributions`), and the
  lognormal sedimentation flux, elementwise at 1e-12 relative: the same
  operations in the same order;
- `get_coal_ints` for MovingThreshold (fast GL inverse and Newton inverse)
  and lognormal modes (GL window and Φ grid), row-scaled 1e-10: the same
  arithmetic, the bilinear form summed by a matmul in another order;
- the plain twins of the CUDA kernels (coalescence RHS, whole step, fused
  per-level RHS) against the Pallas kernels in interpret mode, row-scaled
  1e-9 (tests/test_pallas.py:656): XLA's and torch's fusion and exp/log
  differ in the last bits, and the twins sum the window's nodes one by
  one where the Pallas body reduces them with `jnp.sum`;
- the port's fused-RHS SSPRK33 step against JAX's, row-scaled 1e-9;
- the slice as a whole: the port's pod scenarios against JAX's AoS
  rainshaft RHS + SSPRK33 (row-scaled 1e-8: the fused kernels take the
  gamma flux base from `gamma_ratio`, the AoS RHS from a Lanczos pair).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import distributions as jd
from cloudy_tpu import harness as jharness
from cloudy_tpu import kernels as JK
from cloudy_tpu import sedimentation as jsed
from cloudy_tpu import stepper as jstepper
from cloudy_tpu.coalescence import build_coalescence_data as jbuild, get_coal_ints as jcoal
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import harness, kernels as K, stepper
from cloudy_tpu_torch import sedimentation as sed
from cloudy_tpu_torch.coalescence import build_coalescence_data, get_coal_ints
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)
VARIANTS = ["moving", "lognorm"]


def _both(variant, **overrides):
    """(JAX data, port data) of a pod variant, fast tier unless overridden."""
    fams, thresholds, moving, kw = jharness.POD_VARIANTS[variant]
    kw = {**kw, "fast_tier": True, **overrides}
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    jdata = jbuild(JSpec(fams), jker, thresholds, norms=NORMS, moving=moving, **kw)
    data = build_coalescence_data(SpectrumSpec(tuple(Family(int(f)) for f in fams)),
                                  ker, thresholds, norms=NORMS, moving=moving, **kw)
    return jdata, data


def _params(families, B, seed):
    """Physically consistent parameters (tests/test_pallas.py:311-319):
    lognormal (n, μ, σ) ∈ [10, 200] × [−2, 0.5] × [0.3, 1.2], gamma
    (n, θ, k) ∈ [10, 200] × [0.05, 5] × [0.5, 5]."""
    rng = np.random.default_rng(seed)
    out = []
    for fam in families:
        p1, p2 = ((-2.0, 0.5), (0.3, 1.2)) if fam == Family.LOGNORMAL else ((0.05, 5.0), (0.5, 5.0))
        out.append(np.stack([rng.uniform(10, 200, B), rng.uniform(*p1, B),
                             rng.uniform(*p2, B)], -1))
    return np.stack(out, axis=1)


def _row_scaled(got, want, axis):
    scale = np.abs(want).max(axis=axis, keepdims=True)
    return (np.abs(got - want) / np.maximum(scale, 1e-300)).max()


def _state(spec, nz, n_cols):
    """Both modes seeded (with the second mode empty its rows hold only
    promotion dust, tests/test_pallas.py:625-632), per-column amplitudes, a
    negative moment and a whole negative (empty) level planted; SoA."""
    config = jrs.RainshaftConfig(spec=JSpec(spec.families), nz=nz, zmax=3000.0, norms=NORMS)
    ic = np.concatenate([jrs.initial_condition(config.z, [1e8, 1e-2, 2e-12]),
                         jrs.initial_condition(config.z, [1e7, 1e-3, 2e-13])], -1)
    st = np.tile(ic[None], (n_cols, 1, 1)) * np.linspace(0.5, 1.5, n_cols)[:, None, None]
    st[0, nz // 2, 0] *= -1.0
    st[1, nz // 2 + 1, :] = -1e-3
    return config, np.asarray(jrs.to_soa(jnp.asarray(st)))


# --------------------------------------------------------------------------
# distributions and sedimentation
# --------------------------------------------------------------------------


def test_lognormal_closure_and_moments_match_jax():
    spec = SpectrumSpec((Family.LOGNORMAL, Family.GAMMA))
    jspec = JSpec(spec.families)
    params = _params(spec.families, 200, seed=21)
    mom = np.asarray(jd.get_moments(jspec, jnp.asarray(params)))
    np.testing.assert_allclose(pd.get_moments(spec, torch.tensor(params)).numpy(),
                               mom, rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(pd.params_from_moments(spec, torch.tensor(mom)).numpy(),
                               np.asarray(jd.params_from_moments(jspec, jnp.asarray(mom))),
                               rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(pd.moments_matrix(spec, torch.tensor(params), 4).numpy(),
                               np.asarray(jd.moments_matrix(jspec, jnp.asarray(params), 4)),
                               rtol=1e-12, atol=0.0)
    for q in (0.0, 1.0 / 6.0, 2.5):
        np.testing.assert_allclose(pd.moment(spec, torch.tensor(params), q).numpy(),
                                   np.asarray(jd.moment(jspec, jnp.asarray(params), q)),
                                   rtol=1e-12, atol=0.0)


def test_lognormal_degenerate_moments_fall_back():
    """Moments at or below eps give the zero distribution (n = 0, μ = σ = 1),
    as the JAX closure does."""
    spec = SpectrumSpec((Family.LOGNORMAL,))
    mom = np.array([[0.0, 0.0, 0.0], [1.0, 1e-20, 1.0], [2.0, 3.0, 5.0]])
    got = pd.params_from_moments(spec, torch.tensor(mom)).numpy()
    want = np.asarray(jd.params_from_moments(JSpec(spec.families), jnp.asarray(mom)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    assert got[0, 0, 0] == 0.0 and got[1, 0, 0] == 0.0 and got[2, 0, 0] > 0.0


@pytest.mark.parametrize("fams", [(Family.GAMMA, Family.GAMMA),
                                  (Family.LOGNORMAL, Family.GAMMA),
                                  (Family.EXPONENTIAL, Family.MONODISPERSE, Family.GAMMA)],
                         ids=["gamma", "lognormal", "exp_mono"])
@pytest.mark.parametrize("fast_gl_nodes", [0, 12], ids=["newton", "fast"])
def test_compute_thresholds_match_jax(fams, fast_gl_nodes):
    spec = SpectrumSpec(fams)
    params = _params(fams, 64, seed=22)
    pct = (0.9, 0.75, 1.0)[:len(fams)]
    want = np.asarray(jd.compute_thresholds(JSpec(fams), jnp.asarray(params), pct,
                                            fast_gl_nodes=fast_gl_nodes))
    got = pd.compute_thresholds(spec, torch.tensor(params), pct,
                                fast_gl_nodes=fast_gl_nodes).numpy()
    assert np.all(np.isinf(got[:, -1])) and np.all(np.isinf(want[:, -1]))
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=1e-12, atol=0.0)


def test_lognormal_sedimentation_flux_matches_jax():
    spec = SpectrumSpec((Family.LOGNORMAL, Family.GAMMA))
    params = _params(spec.families, 100, seed=23)
    vel = ((50.0 * 1e-9 ** (1.0 / 6.0), 1.0 / 6.0), (3.0, 0.5))
    want = np.asarray(jsed.get_sedimentation_flux(JSpec(spec.families),
                                                  jnp.asarray(params), vel))
    got = sed.get_sedimentation_flux(spec, torch.tensor(params), vel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


# --------------------------------------------------------------------------
# coalescence: the torch reference path
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "variant,overrides",
    [("moving", {}), ("moving", {"fast_tier": False}),
     ("lognorm", {}), ("lognorm", {"fast_tier": False, "lognorm_gl_nodes": 0})],
    ids=["moving_fast_inverse", "moving_newton_inverse", "lognorm_window", "lognorm_phi_grid"],
)
def test_get_coal_ints_variants_match_jax(variant, overrides):
    jdata, data = _both(variant, **overrides)
    params = _params(data.spec.families, 64, seed=24)
    want = np.asarray(jcoal(jdata, jnp.asarray(params)))
    got = get_coal_ints(data, torch.tensor(params)).numpy()
    assert _row_scaled(got, want, axis=0) < 1e-10


# --------------------------------------------------------------------------
# the plain twins of the CUDA kernels against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_coal_twin_matches_pallas_coal_fn(variant):
    jdata, data = _both(variant)
    mom = np.asarray(jd.get_moments(JSpec(data.spec.families),
                                    jnp.asarray(_params(data.spec.families, 128, seed=25))))
    want = np.asarray(pc.make_pallas_coal_fn(jdata, block_cols=128, interpret=True)
                      .soa(jnp.asarray(mom.T)))
    fn = fc.make_coal_fn(data, device="cpu", dtype=torch.float64)
    got = fn.soa(torch.tensor(mom.T.copy())).numpy()
    assert _row_scaled(got, want, axis=1) < 1e-9
    assert fn.launches == 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_twin_matches_pallas_whole_step(variant):
    jdata, data = _both(variant)
    config, state = _state(data.spec, 16, 8)
    want = np.asarray(pc.make_pallas_rainshaft_step_fn(
        jdata, VEL, NORMS, nz=16, dz=config.dz, dt=1.0, block_cols=128,
        interpret=True)(jnp.asarray(state)))
    step = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=16, dz=config.dz,
                                     dt=1.0, device="cpu", dtype=torch.float64)
    got = step(torch.tensor(state)).numpy()
    assert _row_scaled(got, want, axis=1) < 1e-9
    assert step.launches == 0


@pytest.mark.parametrize("variant", ["fixed2gamma"] + VARIANTS)
def test_rhs_twin_matches_pallas_rainshaft_rhs(variant):
    """B4's twin: [coal; flux] rows, physical units."""
    jdata, data = _both(variant)
    _, state = _state(data.spec, 16, 8)
    want = np.asarray(pc.make_pallas_rainshaft_rhs_fn(
        jdata, VEL, NORMS, block_cols=128, interpret=True).soa(jnp.asarray(state)))
    fn = fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device="cpu", dtype=torch.float64)
    got = fn.soa(torch.tensor(state)).numpy()
    assert got.shape == (12, state.shape[1])
    assert _row_scaled(got, want, axis=1) < 1e-9
    assert fn.launches == 0


@pytest.mark.parametrize("variant", ["fixed2gamma"] + VARIANTS)
def test_fused_rhs_ssprk33_step_matches_jax(variant):
    """The fused-RHS route (B4's twin + torch stencil + `ssprk33_step`)
    against JAX's `make_rainshaft_rhs_fused` + `ssprk33_step` in interpret
    mode, and against the port's own whole step."""
    jdata, data = _both(variant)
    config, state = _state(data.spec, 16, 8)
    fused = pc.make_pallas_rainshaft_rhs_fn(jdata, VEL, NORMS, block_cols=128,
                                            interpret=True)
    jrhs = jrs.make_rainshaft_rhs_fused(config, fused)
    want = np.asarray(jstepper.ssprk33_step(jrhs, jnp.asarray(state),
                                            jnp.asarray(0.0, jnp.float64), 1.0))
    pconfig = rs.RainshaftConfig(spec=data.spec, nz=16, zmax=3000.0, norms=NORMS)
    rhs = rs.make_rainshaft_rhs_fused(
        pconfig, fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device="cpu",
                                          dtype=torch.float64))
    got = stepper.ssprk33_step(rhs, torch.tensor(state), 0.0, 1.0).numpy()
    assert _row_scaled(got, want, axis=1) < 1e-9
    whole = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=16, dz=pconfig.dz,
                                      dt=1.0, device="cpu", dtype=torch.float64)
    assert _row_scaled(whole(torch.tensor(state)).numpy(), got, axis=1) < 1e-12


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_pod_variant_f64_matches_jax_aos_rhs(variant):
    """10 whole steps of the port's pod scenario (8 columns, the twin, f64)
    against JAX's AoS `make_rainshaft_rhs` + `ssprk33_step` from the same
    initial condition (mode 1 seeded, mode 2 empty)."""
    name = {"moving": "pod_ensemble_moving", "lognorm": "pod_ensemble_lognorm"}[variant]
    sc = harness.SCENARIOS[name](n_columns=8, device="cpu", dtype=torch.float64)
    y, _, _ = sc["run"](10)
    got = y.numpy()
    assert sc["step"].launches == 0

    jdata, _ = _both(variant)
    config = jrs.RainshaftConfig(spec=jdata.spec, nz=32, zmax=3000.0, norms=NORMS,
                                 t_end=120.0, dt=1.0)
    ic1 = jrs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    ys = jnp.asarray(np.tile(ic[None], (8, 1, 1)))
    rhs = jax.jit(jrs.make_rainshaft_rhs(config, jdata))
    for _ in range(10):
        ys = jstepper.ssprk33_step(rhs, ys, jnp.asarray(0.0, jnp.float64), 1.0)
    want = np.asarray(jrs.to_soa(ys))
    assert np.all(np.isfinite(got))
    assert _row_scaled(got, want, axis=1) < 1e-8


@pytest.mark.parametrize("variant", VARIANTS)
def test_pod_variant_cpu_f32_report(variant):
    """The harness runs each variant in its stated f32 configuration on the
    CPU (twin): finite, no negative moments, no launches, host clock."""
    name = {"moving": "pod_ensemble_moving", "lognorm": "pod_ensemble_lognorm"}[variant]
    sc = harness.SCENARIOS[name](n_columns=2, device="cpu")
    y, seconds, clock = sc["run"](3)
    report = harness.metrics.conservation_report(sc["spec"], rs.from_soa(y, 32))
    assert y.dtype == torch.float32 and clock == "host" and seconds > 0
    assert bool(torch.isfinite(y).all()) and report["negative_fraction"] == 0.0
    assert sc["data"].moving == (variant == "moving")
    assert sc["step"].launches == 0
