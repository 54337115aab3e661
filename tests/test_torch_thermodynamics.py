"""The port's moist thermodynamics (`cloudy_tpu_torch.models.thermodynamics`)
against the JAX package's on seeded (T, p, q) in f64, 1e-13 relative."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu.models import thermodynamics as jth

from cloudy_tpu_torch.models import thermodynamics as th

torch.set_num_threads(1)

RTOL = 1e-13


def _inputs(seed=0, n=257):
    rng = np.random.default_rng(seed)
    T = rng.uniform(230.0, 310.0, n)
    p = rng.uniform(5e4, 1.05e5, n)
    qv = rng.uniform(1e-4, 2e-2, n)
    ql = rng.uniform(0.0, 3e-3, n)
    return T, p, qv, ql


CASES = {
    "latent_heat_vapor": lambda m, tps, T, p, qv, ql: m.latent_heat_vapor(tps, T),
    "saturation_vapor_pressure_liquid":
        lambda m, tps, T, p, qv, ql: m.saturation_vapor_pressure_liquid(tps, T),
    "gas_constant_air": lambda m, tps, T, p, qv, ql: m.gas_constant_air(tps, qv + ql, ql),
    "cp_m": lambda m, tps, T, p, qv, ql: m.cp_m(tps, qv + ql, ql),
    "air_density": lambda m, tps, T, p, qv, ql: m.air_density(tps, T, p, qv),
    "air_density_moist": lambda m, tps, T, p, qv, ql: m.air_density(tps, T, p, qv, ql),
    "G_func_liquid": lambda m, tps, T, p, qv, ql: m.G_func_liquid(tps, T),
    "condensation_coefficient": lambda m, tps, T, p, qv, ql: m.condensation_coefficient(tps, T),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    T, p, qv, ql = _inputs()
    fn = CASES[name]
    want = np.asarray(fn(jth, jth.ThermoParams(), *(jnp.asarray(a) for a in (T, p, qv, ql))))
    got = fn(th, th.ThermoParams(), *(torch.from_numpy(a) for a in (T, p, qv, ql)))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0.0)


def test_numbers_and_other_constants():
    """A number gives an f64 host tensor (`initial_state` reads e_s(T0) so);
    the constants are JAX's, field for field, and a changed one reaches
    every function that reads it."""
    assert dataclasses_equal(th.ThermoParams(), jth.ThermoParams())
    tps, jtps = th.ThermoParams(D_vapor=3e-5, K_therm=2.6e-2), jth.ThermoParams(
        D_vapor=3e-5, K_therm=2.6e-2)
    e = th.saturation_vapor_pressure_liquid(tps, 280.15)
    assert isinstance(e, torch.Tensor) and e.dtype == torch.float64 and e.device.type == "cpu"
    assert float(e) == pytest.approx(float(jth.saturation_vapor_pressure_liquid(jtps, 280.15)),
                                     rel=RTOL)
    assert float(th.condensation_coefficient(tps, 275.0)) == pytest.approx(
        float(jth.condensation_coefficient(jtps, 275.0)), rel=RTOL)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)
