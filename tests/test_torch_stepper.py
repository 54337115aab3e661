"""The port's fixed-step integrator (`cloudy_tpu_torch.stepper`) against the
JAX package's: the time an RHS sees.

JAX carries `t` in its scan in the state's dtype (cloudy_tpu/stepper.py:
178), so an f32 run adds dt = 0.1 in f32 and the stages see t, t + dt and
t + dt/2 rounded to f32 each step. The port carries it the same way; the
sequence an RHS reads over 1000 f32 steps is JAX's, bit for bit.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import stepper as jstepper

from cloudy_tpu_torch import stepper

torch.set_num_threads(1)

N_STEPS, DT = 1000, 0.1


def test_integrate_t_sequence_matches_jax():
    jseen = []

    def jf(y, t):
        jax.debug.callback(lambda tt: jseen.append(np.asarray(tt)), t, ordered=True)
        return -0.01 * y

    _, jys = jstepper.integrate(jf, jnp.ones(3, jnp.float32), 0.0, DT, N_STEPS, save_every=100)
    jax.block_until_ready(jys)
    seen = []

    def f(y, t):
        seen.append(t)
        return -0.01 * y

    _, ys = stepper.integrate(f, torch.ones(3, dtype=torch.float32), 0.0, DT, N_STEPS,
                              save_every=100)
    assert len(seen) == len(jseen) == 3 * N_STEPS
    assert all(torch.is_tensor(t) and t.dtype == torch.float32 for t in seen)
    want = np.asarray(jseen, np.float32)
    got = np.asarray([t.item() for t in seen], np.float32)
    np.testing.assert_array_equal(got, want)
    # the f32 sum has drifted from the exact times, as JAX's has
    assert got[3 * (N_STEPS - 1)] != np.float32((N_STEPS - 1) * DT)
    # the trajectories: f32 rounding of 1000 steps, XLA's fusion against torch's ops
    assert ys.dtype == torch.float32 and ys.shape == (11, 3)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-5)


# --- the steppers of A.9: euler, rk4 and the adaptive integrator ---------

import pytest  # noqa: E402


def _convergence_order(method, dts=(0.1, 0.05, 0.025)):
    """Observed order on dy/dt = -y + sin t, y(0) = 1 (tests/test_stepper.py:
    9-27), f64, against a fine run of the same method."""

    def f(y, t):
        return -y + torch.sin(t)

    def run(dt):
        n = int(round(1.0 / dt))
        _, ys = stepper.integrate(f, torch.ones(1, dtype=torch.float64), 0.0, dt, n,
                                  method=method)
        return float(ys[-1, 0])

    ref = run(1e-4)
    errs = [abs(run(dt) - ref) for dt in dts]
    return min(np.log(errs[i] / errs[i + 1]) / np.log(dts[i] / dts[i + 1])
               for i in range(len(dts) - 1))


@pytest.mark.parametrize("method,order", [("euler", 0.9), ("ssprk33", 2.7), ("rk4", 3.7)])
def test_order_of_accuracy(method, order):
    assert _convergence_order(method) > order


@pytest.mark.parametrize("method", ["euler", "ssprk33", "rk4"])
def test_integrate_matches_jax_per_method(method):
    """Each method's fixed-dt trajectory (thinned by `save_every`) against
    JAX's on a nonautonomous RHS that reads `t`, f64, 1e-13."""
    jts, jys = jstepper.integrate(lambda y, t: -y * y + jnp.cos(t), jnp.asarray([1.0, 0.5]),
                                  0.0, 0.1, 20, method=method, save_every=5)
    ts, ys = stepper.integrate(lambda y, t: -y * y + torch.cos(t),
                               torch.tensor([1.0, 0.5], dtype=torch.float64), 0.0, 0.1, 20,
                               method=method, save_every=5)
    assert ys.shape == (5, 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-14)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-13, atol=0.0)
    assert set(stepper.STEPPERS) == set(jstepper.STEPPERS) == set(stepper._ORDERS)
    assert stepper._ORDERS == jstepper._ORDERS


def _same_trials(got, want, y, jy, y_rtol=1e-12):
    y1, st = got
    assert (st["n_accept"], st["n_reject"], st["reached"]) == (
        int(want["n_accept"]), int(want["n_reject"]), bool(want["reached"]))
    assert st["t_final"].dtype == y1.dtype
    assert float(st["t_final"]) == float(want["t_final"])
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=y_rtol, atol=0.0)


@pytest.mark.parametrize("method", ["euler", "ssprk33", "rk4"])
@pytest.mark.parametrize("rtol,atol", [(1e-4, 1e-8), (1e-8, 1e-12)])
def test_adaptive_tracks_rtol_as_jax(method, rtol, atol):
    """tests/test_stepper.py:50-83 for each method and tolerance: the exact
    solution of y' = -y + sin t at t = 3 within the tolerance (ssprk33 at
    its 1e-3 / 1e-6), and JAX's trials: the same accepted and rejected
    counts, `reached`, `t_final`, y within 1e-12."""
    t1 = 3.0
    exact = 1.5 * np.exp(-t1) + 0.5 * (np.sin(t1) - np.cos(t1))
    y1, st = stepper.integrate_adaptive(lambda y, t: -y + torch.sin(t),
                                        torch.ones(1, dtype=torch.float64), 0.0, t1,
                                        rtol=rtol, atol=atol, method=method)
    jy, jst = jstepper.integrate_adaptive(lambda y, t: -y + jnp.sin(t), jnp.ones(1), 0.0, t1,
                                          rtol=rtol, atol=atol, method=method)
    _same_trials((y1, st), jst, y1, jy)
    assert st["reached"] and abs(float(st["t_final"]) - t1) < 1e-12
    if method == "ssprk33":
        assert abs(float(y1[0]) - exact) < (1e-3 if rtol > 1e-6 else 1e-6)
        assert st["n_reject"] < st["n_accept"]


def test_adaptive_spends_more_steps_at_tighter_tolerance():
    f = lambda y, t: -y + torch.sin(t)  # noqa: E731
    y0 = torch.ones(1, dtype=torch.float64)
    _, loose = stepper.integrate_adaptive(f, y0, 0.0, 3.0, rtol=1e-4, atol=1e-8)
    _, tight = stepper.integrate_adaptive(f, y0, 0.0, 3.0, rtol=1e-8, atol=1e-12)
    assert tight["n_accept"] > loose["n_accept"]


def test_adaptive_reports_truncation_on_max_steps():
    """max_steps trials exhausted before t1: `reached` False, t_final short
    of t1, y finite (tests/test_stepper.py:86-95); JAX's trials."""
    y1, st = stepper.integrate_adaptive(lambda y, t: -y, torch.ones(1, dtype=torch.float64),
                                        0.0, 1e6, rtol=1e-10, atol=1e-14, max_steps=10)
    jy, jst = jstepper.integrate_adaptive(lambda y, t: -y, jnp.ones(1), 0.0, 1e6, rtol=1e-10,
                                          atol=1e-14, max_steps=10)
    assert not st["reached"] and float(st["t_final"]) < 1e6
    assert st["n_accept"] + st["n_reject"] == 10
    assert bool(torch.isfinite(y1).all())
    _same_trials((y1, st), jst, y1, jy)


def test_adaptive_nan_rhs_rejects_at_the_cap_with_finite_dt():
    """A NaN RHS rejects every trial; the controller's NaN factor is taken
    as 0.2, so dt shrinks by 5 each trial and stays finite (JAX's
    `nan_to_num(grow, nan=0.2)`); f32 keeps t in f32."""
    y1, st = stepper.integrate_adaptive(lambda y, t: y * float("nan"),
                                        torch.ones(2, dtype=torch.float32), 0.0, 1.0,
                                        max_steps=5)
    _, jst = jstepper.integrate_adaptive(lambda y, t: y * jnp.nan, jnp.ones(2, jnp.float32),
                                         0.0, 1.0, max_steps=5)
    assert (st["n_accept"], st["n_reject"], st["reached"]) == (0, 5, False)
    assert st["dt_last"].dtype == st["t_final"].dtype == torch.float32
    assert float(st["dt_last"]) == float(jst["dt_last"])
    assert float(st["dt_last"]) == pytest.approx(0.01 * 0.2**5, rel=1e-6)  # (t1 - t0)/100, 5 × 0.2
    assert torch.equal(y1, torch.ones(2))


def test_adaptive_matches_fixed_dt_on_coalescence_box():
    """Adaptive SSPRK33 on the coalescence RHS of one gamma mode agrees with
    a fine fixed-dt trajectory (rtol 1e-5) in fewer steps
    (tests/test_stepper.py:98-130)."""
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data, get_coal_ints
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA,))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=(1e6, 1e-9))
    y0 = torch.tensor([1e2, 1e1, 2.0], dtype=torch.float64)

    def rhs(m, t):
        del t
        return get_coal_ints(data, pd.params_from_moments(spec, m))

    _, ys = stepper.integrate(rhs, y0, 0.0, 0.01, 3000)
    y_ad, st = stepper.integrate_adaptive(rhs, y0, 0.0, 30.0, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(y_ad.numpy(), ys[-1].numpy(), rtol=1e-5)
    assert st["reached"] and st["n_accept"] < 3000
