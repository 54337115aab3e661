"""The port's adiabatic parcel (`cloudy_tpu_torch.models.parcel`) against
tests/test_parcel.py's physics, the Rogers (1975) digitized curves at its
bounds, and the JAX package's `run_parcel` trajectory for each kind (f64,
1e-10 relative); the adaptive run against JAX's trial counts."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu.models import parcel as jpm

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch.models import parcel as pm
from cloudy_tpu_torch.models import thermodynamics as th

torch.set_num_threads(1)

KINDS = ["monodisperse", "gamma", "mixture"]
TRAJ_RTOL = 1e-10


def _setup(mod, kind):
    spec, mom0, ml_v = mod.init_conditions(kind)
    config = mod.ParcelConfig(spec=spec, w=10.0, dt=0.25, t_end=20.0)
    Y0 = mod.initial_state(config, mom0, ml_v, p0=8e4, T0=273.15 + 7.0, S0=1.0)
    return config, Y0


def _run(kind):
    config, Y0 = _setup(pm, kind)
    ts, ys = pm.run_parcel(config, Y0, device="cpu")
    return config, ts.numpy(), ys.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_parcel_kind_matches_jax(kind):
    """One kind end to end: its initial state and trajectory against JAX's
    (80 SSPRK33 steps, f64), then tests/test_parcel.py's sanity checks."""
    jconfig, jY0 = _setup(jpm, kind)
    config, Y0 = _setup(pm, kind)
    np.testing.assert_allclose(Y0, jY0, rtol=1e-14, atol=0.0)
    jts, jys = jpm.run_parcel(jconfig, jY0)
    ts, ys = pm.run_parcel(config, Y0, device="cpu")
    assert ys.dtype == torch.float64 and ys.shape == (81, len(Y0))
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-14)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=TRAJ_RTOL, atol=0.0)

    ys = ys.numpy()
    S, p, T, qv = ys[:, 0], ys[:, 1], ys[:, 2], ys[:, 3]
    assert np.all(np.isfinite(ys))
    assert p[-1] < p[0] and T[-1] < T[0]
    assert S.max() > 1.0005 and S.max() < 1.02
    assert qv[-1] < qv[0]
    assert ys[-1, 5] > ys[0, 5]


def test_monodisperse_inversion_is_jax_on_the_parcel_state():
    """The monodisperse closure inverts through the port's `MONODISPERSE`
    branches as JAX's `_invert_monodisperse` does, on every state of the
    parcel's trajectory."""
    config, ts, ys = _run("monodisperse")
    mom = ys[:, 4:]
    got = pd.params_from_moments(config.spec, torch.from_numpy(mom)).numpy()
    jspec = jpm.init_conditions("monodisperse")[0]
    want = np.asarray(jpd.params_from_moments(jspec, jnp.asarray(mom)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0, 0], mom[:, 0])  # n = M0
    np.testing.assert_array_equal(got[:, 0, 1], mom[:, 1] / mom[:, 0])  # θ = M1/M0


def test_parcel_vs_rogers_1975():
    """Supersaturation within 0.35 (end) and 0.45 (anywhere) percentage
    points of the digitized Rogers curve, radius within 0.6 μm
    (tests/test_parcel.py:35-53)."""
    config, ts, ys = _run("gamma")
    supersat_pct = (ys[:, 0] - 1.0) * 100.0
    got = np.interp(pm.ROGERS_TIME_SUPERSAT, ts, supersat_pct)
    assert abs(got[-1] - pm.ROGERS_SUPERSAT[-1]) < 0.35
    assert np.max(np.abs(got - pm.ROGERS_SUPERSAT)) < 0.45
    N_l, M_l = ys[:, 4], ys[:, 5]
    r_um = (M_l / N_l / config.tps.rho_w * 3 / 4 / np.pi) ** (1 / 3) * 1e6
    got_r = np.interp(pm.ROGERS_TIME_RADIUS, ts, r_um)
    assert np.max(np.abs(got_r - pm.ROGERS_RADIUS)) < 0.6
    for name in ("ROGERS_TIME_SUPERSAT", "ROGERS_SUPERSAT", "ROGERS_TIME_RADIUS",
                 "ROGERS_RADIUS"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jpm, name))


def test_parcel_mass_budget_closed():
    """q_v + q_l changes only through density variation (rtol 2e-3)."""
    config, ts, ys = _run("gamma")
    rho = th.air_density(config.tps, torch.from_numpy(ys[:, 2]), torch.from_numpy(ys[:, 1]),
                         torch.from_numpy(ys[:, 3])).numpy()
    total = ys[:, 3] + ys[:, 5] / rho
    np.testing.assert_allclose(total, total[0], rtol=2e-3)


def test_parcel_adaptive_matches_fixed_dt_and_jax():
    """`run_parcel_adaptive` on the monodisperse parcel agrees with the
    fixed-dt endpoint (rtol 1e-5, tests/test_parcel.py:67-82), and on the
    mixture takes JAX's trials: the same accepted and rejected counts,
    `reached`, `t_final`, y within 1e-12 and the last step size within
    1e-8."""
    config, Y0 = _setup(pm, "monodisperse")
    _, ys = pm.run_parcel(config, Y0, device="cpu")
    y_ad, st = pm.run_parcel_adaptive(config, Y0, rtol=1e-8, atol=1e-11, device="cpu")
    np.testing.assert_allclose(y_ad.numpy(), ys[-1].numpy(), rtol=1e-5, atol=1e-12)
    assert st["n_reject"] < st["n_accept"] and st["reached"]

    jconfig, jY0 = _setup(jpm, "mixture")
    config, Y0 = _setup(pm, "mixture")
    jy, jst = jpm.run_parcel_adaptive(jconfig, jY0)
    y, st = pm.run_parcel_adaptive(config, Y0, device="cpu")
    assert (st["n_accept"], st["n_reject"], st["reached"]) == (
        int(jst["n_accept"]), int(jst["n_reject"]), bool(jst["reached"]))
    assert float(st["t_final"]) == float(jst["t_final"]) == 20.0
    # the last step size follows err, a ratio of the difference of two
    # nearly equal solutions: its last digits carry the rounding of each
    # package's operations (measured 5e-10 apart)
    assert float(st["dt_last"]) == pytest.approx(float(jst["dt_last"]), rel=1e-8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-12, atol=0.0)


def test_no_card_raises():
    """The parcel's entry points run on the card unless asked for the CPU;
    without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config, Y0 = _setup(pm, "gamma")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.run_parcel(config, Y0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.run_parcel_adaptive(config, Y0)
