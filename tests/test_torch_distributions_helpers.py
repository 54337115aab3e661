"""The distributions and kernels helpers of the port that came last, on the
CPU: `moment_source_helper` against the reference values of
tests/test_distributions.py:170-210 (rtol 1e-3) and against the JAX
package in f64 per family (rtol 1e-12: the same grid, weights and
incomplete gamma), batched parameters and thresholds included;
`check_moment_consistency` against tests/test_distributions.py:212-218;
and the free functions `get_normalized_kernel_func` and
`get_normalized_kernel_tensor` against JAX's (rtol 1e-15).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

RTOL = 1e-3
FAMILIES = {"mono": Family.MONODISPERSE, "exp": Family.EXPONENTIAL,
            "gamma": Family.GAMMA, "lognorm": Family.LOGNORMAL}


def _msh(fam, params, p1, p2, t, **kw):
    spec = SpectrumSpec((fam,))
    return float(pd.moment_source_helper(spec, torch.tensor([params], dtype=torch.float64),
                                         0, p1, p2, t, **kw))


#: (family, params, p1, p2, T, keywords, reference value)
#: (test_ParticleDistributions_correctness.jl:202-218 as tests/test_distributions.py cites it)
REFERENCE = [
    ("mono", [1.0, 0.5, 0.0], 0.0, 0.0, 0.5, {}, 0.0),
    ("mono", [1.0, 0.5, 0.0], 0.0, 0.0, 1.2, {}, 1.0),
    ("mono", [1.0, 0.5, 0.0], 1.0, 0.0, 0.5, {}, 0.0),
    ("mono", [1.0, 0.5, 0.0], 0.0, 1.0, 1.2, {}, 0.5),
    ("exp", [1.0, 0.5, 0.0], 0.0, 0.0, 0.5, {"n_bins_per_log_unit": 20}, 2.642e-1),
    ("exp", [1.0, 0.5, 0.0], 1.0, 0.0, 0.5, {"n_bins_per_log_unit": 20}, 4.015e-2),
    ("exp", [1.0, 0.5, 0.0], 1.0, 1.0, 0.5, {"n_bins_per_log_unit": 20}, 4.748e-3),
    ("gamma", [1.0, 0.5, 2.0], 0.0, 0.0, 0.5, {"n_bins_per_log_unit": 20}, 1.899e-2),
    ("gamma", [1.0, 0.5, 2.0], 1.0, 0.0, 0.5, {"n_bins_per_log_unit": 20}, 3.662e-3),
    ("gamma", [1.0, 0.5, 2.0], 1.0, 1.0, 0.5, {"n_bins_per_log_unit": 20}, 5.940e-4),
    ("lognorm", [1.0, 0.5, 2.0], 0.0, 0.0, 2.5,
     {"n_bins_per_log_unit": 60, "n_points_max": 512}, 2.831e-1),
    ("lognorm", [1.0, 0.5, 2.0], 1.0, 0.0, 2.5,
     {"n_bins_per_log_unit": 60, "n_points_max": 512}, 1.725e-1),
    ("lognorm", [1.0, 0.5, 2.0], 1.0, 1.0, 2.5,
     {"n_bins_per_log_unit": 60, "n_points_max": 512}, 8.115e-2),
]


@pytest.mark.parametrize("case", REFERENCE, ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}-{c[4]}")
def test_moment_source_helper_reference_values(case):
    fam, params, p1, p2, t, kw, want = case
    got = _msh(FAMILIES[fam], params, p1, p2, t, **kw)
    if want == 0.0:
        assert got == pytest.approx(0.0, abs=1e-12)
    else:
        assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_moment_source_helper_matches_jax(fam):
    """Batched parameters, orders and thresholds, f64, against JAX."""
    rng = np.random.default_rng(7)
    B = 6
    if fam == "lognorm":
        params = np.stack([rng.uniform(0.5, 2.0, B), rng.uniform(-1.0, 1.0, B),
                           rng.uniform(0.3, 1.0, B)], -1)
    else:
        params = np.stack([rng.uniform(0.5, 2.0, B), rng.uniform(0.2, 2.0, B),
                           rng.uniform(0.5, 4.0, B)], -1)
    p1, p2 = rng.uniform(0.0, 2.0, B), rng.uniform(0.0, 2.0, B)
    t = rng.uniform(0.3, 3.0, B)
    spec, jspec = SpectrumSpec((FAMILIES[fam],)), JSpec((JFamily(int(FAMILIES[fam])),))
    got = pd.moment_source_helper(spec, torch.tensor(params[:, None, :]), 0, torch.tensor(p1),
                                  torch.tensor(p2), torch.tensor(t), n_points_max=128)
    want = np.asarray(jpd.moment_source_helper(jspec, jnp.asarray(params[:, None, :]), 0,
                                               jnp.asarray(p1), jnp.asarray(p2),
                                               jnp.asarray(t), n_points_max=128))
    assert got.shape == want.shape == (B,)
    assert np.isfinite(want).all() and (np.abs(want) > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-300)


def test_check_moment_consistency():
    pd.check_moment_consistency((1.1, 2.1))
    pd.check_moment_consistency((0.0, 0.0))
    pd.check_moment_consistency((0.0, 1.0, 2.0))
    pd.check_moment_consistency(torch.tensor([1.0, 1.0, 2.0]))
    for bad in ((-0.1, 1.0), (0.1, -1.0), (1.0, 3.0, 2.0)):
        with pytest.raises(ValueError):
            pd.check_moment_consistency(bad)
    # the same verdicts as JAX's on moments of four orders
    rng = np.random.default_rng(2)
    for _ in range(20):
        m = rng.uniform(0.0, 3.0, 4)
        verdicts = []
        for f in (pd.check_moment_consistency, jpd.check_moment_consistency):
            try:
                f(m)
                verdicts.append(None)
            except ValueError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1], m


def test_normalized_kernel_helpers():
    norms = (1e6, 1e-9)
    for name, args in (("LinearKernelFunction", (5.0,)), ("ConstantKernelFunction", (1e-3,)),
                       ("HydrodynamicKernelFunction", (1e-2,)),
                       ("LongKernelFunction", (5.236e-10, 9.44e9, 5.78))):
        got = K.get_normalized_kernel_func(getattr(K, name)(*args), list(norms))
        want = JK.get_normalized_kernel_func(getattr(JK, name)(*args), list(norms))
        assert type(got).__name__ == name
        np.testing.assert_allclose(np.asarray(list(vars(got).values())),
                                   np.asarray(list(vars(want).values())), rtol=1e-15)
        assert got == getattr(K, name)(*args).normalized(norms)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 2, 1e-6)
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 2, 1e-6)
    got = K.get_normalized_kernel_tensor(ker, norms)
    want = JK.get_normalized_kernel_tensor(jker, norms)
    np.testing.assert_allclose(got.array, np.asarray(want.array), rtol=1e-15)
    assert got == ker.normalized(norms)
