"""The port's condensation source (`cloudy_tpu_torch.condensation`) against
its closed forms (tests/test_sources.py:27-62, reference
test_Sources_correctness.jl:274-308) and against the JAX package's
`get_cond_evap` on seeded batched parameters and supersaturations, f64,
1e-12 relative."""

import numpy as np
import pytest
import scipy.special as ss
import torch
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu.condensation import get_cond_evap as jget_cond_evap
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch.condensation import get_cond_evap
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

RTOL = 1e-12


def test_condensation_single_exponential():
    spec = SpectrumSpec((Family.EXPONENTIAL,))
    params = torch.tensor([[1.0, 1.0, 0.0]], dtype=torch.float64)
    xi, s = 1e-6, 0.01
    got = get_cond_evap(spec, params, s, xi).numpy()
    m13 = ss.gamma(1.0 + 1.0 / 3.0)  # M_{1/3} of exp(1, 1): Γ(4/3)
    want = [0.0, 3 * xi * s * m13 * (4 * np.pi / 3) ** (2 / 3) / 1000.0 ** (1 / 3)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-30)
    assert float(pd.moment(spec, params, 1.0 - 2.0 / 3.0)[0]) == pytest.approx(m13, rel=1e-12)


def test_condensation_three_modes():
    spec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA, Family.GAMMA))
    params = torch.tensor([[1.0, 1.0, 0.0], [1.0, 2.0, 3.0], [0.1, 10.0, 3.0]],
                          dtype=torch.float64)
    xi, s = 1e-6, 0.01
    got = get_cond_evap(spec, params, s, xi).numpy()
    coef = 3 * xi * s * (4 * np.pi / 3) ** (2 / 3) / 1000.0 ** (1 / 3)

    def frac_mom(n, theta, k, q):  # n θ^q Γ(q + k)/Γ(k)
        return n * theta**q * ss.gamma(q + k) / ss.gamma(k)

    want = [
        0.0,
        coef * frac_mom(1.0, 1.0, 1.0, 1 - 2 / 3),
        0.0,
        coef * frac_mom(1.0, 2.0, 3.0, 1 - 2 / 3),
        coef * 2 * frac_mom(1.0, 2.0, 3.0, 2 - 2 / 3),
        0.0,
        coef * frac_mom(0.1, 10.0, 3.0, 1 - 2 / 3),
        coef * 2 * frac_mom(0.1, 10.0, 3.0, 2 - 2 / 3),
    ]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-30)


FAMILIES = {
    "exp": (Family.EXPONENTIAL,),
    "gamma": (Family.GAMMA,),
    "mono": (Family.MONODISPERSE,),
    "lognormal": (Family.LOGNORMAL,),
    "exp_gamma_gamma": (Family.EXPONENTIAL, Family.GAMMA, Family.GAMMA),
    "lognormal_gamma": (Family.LOGNORMAL, Family.GAMMA),
}


def _params(families, batch, seed):
    rng = np.random.default_rng(seed)
    out = np.empty(batch + (len(families), 3))
    for i, fam in enumerate(families):
        out[..., i, 0] = rng.uniform(1e-2, 1e3, batch)
        if fam == Family.LOGNORMAL:
            out[..., i, 1] = rng.uniform(-3.0, 2.0, batch)
            out[..., i, 2] = rng.uniform(0.1, 1.0, batch)
        else:
            out[..., i, 1] = rng.uniform(1e-2, 10.0, batch)
            out[..., i, 2] = rng.uniform(0.5, 8.0, batch) if fam == Family.GAMMA else 0.0
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_batched_matches_jax(name):
    """Batched params [5, 7, n_modes, 3] against a batched `s` [5, 7] and
    a scalar ξ; then a batched `s` [4, 1] against unbatched params: the
    zero rows take the broadcast shape of ``params[..., 0, 0]`` and `s`."""
    fams = FAMILIES[name]
    jspec = JSpec(tuple(JFamily[f.name] for f in fams))
    spec = SpectrumSpec(fams)
    params = _params(fams, (5, 7), seed=len(name))
    s = np.random.default_rng(1).uniform(-0.02, 0.02, (5, 7))
    for p_, s_, xi in ((params, s, 3.7e-3), (params[0, 0], s[:4, :1], 2.1e-2)):
        want = np.asarray(jget_cond_evap(jspec, jnp.asarray(p_), jnp.asarray(s_), xi))
        got = get_cond_evap(spec, torch.from_numpy(p_), torch.from_numpy(s_), xi)
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0.0)
    # the fractional moment is the port's `moment` at m - 2/3, as JAX's
    np.testing.assert_allclose(
        pd.moment(spec, torch.from_numpy(params), 1.0 / 3.0).numpy(),
        np.asarray(jpd.moment(jspec, jnp.asarray(params), 1.0 / 3.0)), rtol=RTOL)


def test_f32_stays_f32():
    spec = SpectrumSpec((Family.GAMMA,))
    params = torch.tensor([[100.0, 0.5, 2.0]], dtype=torch.float32)
    got = get_cond_evap(spec, params, torch.tensor([0.01, -0.01]), 1e-2)
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    assert torch.equal(got[0], -got[1]) and float(got[0, 0]) == 0.0
