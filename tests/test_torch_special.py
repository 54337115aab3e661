"""Special functions of the port against the JAX package (same inputs, drawn
from a numpy seed) and against scipy.

Tolerances:
- f64: rtol 1e-12 — same operations in the same order; what is left is
  torch's and XLA's exp/log differing in the last bit.
- f32: exp and log are elementwise within rtol 2e-6 (the two libraries' f32
  exp/log differ by an ulp). The composite functions cancel large terms
  (Stirling differences, 1 − Σ in the GL tail), which amplifies that ulp, so
  for them the test states the property that matters: the port's f32 result
  is as close to the f64 truth as JAX's own f32 result (within a factor 2),
  and within rtol 2e-6 of JAX's f32 result plus an absolute floor of four
  times JAX's own f32 error (the cancellation floor).
- scipy: the bounds tests/test_special.py proves for the JAX package —
  GL-12 gammainc 2.6e-7 absolute over the exact-F2 domain, gamma_ratio 5e-7
  relative, lgamma_stirling 4e-9 absolute.
"""

import numpy as np
import pytest
import scipy.special as ss
import torch
import jax.numpy as jnp

from cloudy_tpu.ops import special as jsp
from cloudy_tpu_torch.ops import special as tsp

torch.set_num_threads(1)

_RNG = np.random.default_rng(7)
_K = _RNG.uniform(1e-3, 12.0, 600)  # shape parameters / lgamma arguments
_A = _RNG.uniform(2.5, 26.0, 600)  # incomplete-gamma orders (exact-F2 domain)
_X = np.concatenate([_RNG.uniform(0.0, 60.0, 500), _RNG.uniform(1e-6, 1.0, 100)])
_ARG = _RNG.uniform(-120.0, 120.0, 600)  # exp arguments incl. |x| >= 85

CASES = {
    "exp": (lambda m, dt: m.exp(_c(m, _ARG, dt))),
    "lgamma": (lambda m, dt: m.lgamma(_c(m, _K, dt))),
    "lgamma_stirling": (lambda m, dt: m.lgamma_stirling(_c(m, _K, dt))),
    "gamma_ratio": (lambda m, dt: m.gamma_ratio(_c(m, _K, dt), 1.0 / 6.0)),
    "gammainc_gl": (lambda m, dt: m.gammainc_gl(_c(m, _A, dt), _c(m, _X, dt))),
    "gammainc_impl": (
        lambda m, dt: m.gammainc_impl(_c(m, _A, dt), _c(m, _X, dt), n_iters=128)
    ),
    "gammainc_impl_12": (
        lambda m, dt: m.gammainc_impl(_c(m, _A, dt), _c(m, _X, dt), n_iters=12)
    ),
}


def _c(mod, x, dt):
    """The input array for `mod` (jax or torch special module) in `dt`."""
    if mod is jsp:
        return jnp.asarray(x, jnp.float32 if dt == "f32" else jnp.float64)
    return torch.tensor(x, dtype=torch.float32 if dt == "f32" else torch.float64)


def _np(v):
    return v.double().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_special_f64_matches_jax(name):
    fn = CASES[name]
    want, got = _np(fn(jsp, "f64")), _np(fn(tsp, "f64"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_special_f32_matches_jax(name):
    fn = CASES[name]
    truth = _np(fn(jsp, "f64"))
    want, got = _np(fn(jsp, "f32")), _np(fn(tsp, "f32"))
    if name == "exp":
        # XLA's CPU f32 flushes subnormal results to zero, torch keeps them:
        # compare where the result is a normal finite f32
        ok = np.isfinite(want) & (np.abs(truth) >= np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got[ok], want[ok], rtol=2e-6, atol=0.0)
        return
    jax_err = np.abs(want - truth).max()
    port_err = np.abs(got - truth).max()
    assert port_err <= 2.0 * jax_err + 1e-30, (port_err, jax_err)
    # elementwise: rtol 2e-6 plus the cancellation floor (JAX's own f32 error)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=4.0 * jax_err)


def test_gammainc_gl_scipy_bound():
    """The exact-F2 domain of tests/test_special.py: a ∈ [4, 26],
    x ∈ (0, 1e6]."""
    a = np.concatenate([np.linspace(4.0, 26.0, 45), [26.0]])
    x = np.concatenate([np.logspace(-6, 6, 80), np.linspace(0.5, 80.0, 300)])
    A, X = np.meshgrid(a, x)
    got = tsp.gammainc_gl(torch.tensor(A), torch.tensor(X), n_nodes=12).numpy()
    assert np.abs(got - ss.gammainc(A, X)).max() < 2.6e-7


def test_gamma_ratio_scipy_bound():
    k = np.logspace(-6, np.log10(50.0), 300)
    for e in (1.0 / 6.0, 1.0 / 3.0, 0.5, 2.0 / 3.0, 5.0 / 6.0, 1.0):
        got = tsp.gamma_ratio(torch.tensor(k), e).numpy()
        want = np.exp(ss.gammaln(k + e) - ss.gammaln(k))
        assert np.abs(got / want - 1.0).max() < 5e-7, e


def test_lgamma_stirling_scipy_bound():
    x = np.concatenate([np.logspace(-6, 0, 40), np.linspace(1.0, 50.0, 300)])
    got = tsp.lgamma_stirling(torch.tensor(x)).numpy()
    assert np.abs(got - ss.gammaln(x)).max() < 4e-9


def test_quadrature_rules_match_jax():
    """ops.gauss and ops.simpson: the same nodes and weights as the JAX
    package (f64)."""
    from cloudy_tpu.ops import gauss as jg, simpson as js
    from cloudy_tpu_torch.ops import gauss as tg, simpson as ts

    a, b = np.array([1e-3, 0.5]), np.array([2.0, 7.5])
    for jnodes, tnodes in ((jg.nodes_on_interval(12, a, b),
                            tg.nodes_on_interval(12, torch.tensor(a), torch.tensor(b))),
                           (jg.log_nodes(16, a, b),
                            tg.log_nodes(16, torch.tensor(a), torch.tensor(b)))):
        for j, t in zip(jnodes, tnodes):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13, atol=0.0)
    for n_bins in (3, 4, 9, 75):
        assert np.array_equal(ts.simpson_even_fast_weights(n_bins),
                              js.simpson_even_fast_weights(n_bins))
    nb = np.array([3, 10, 75])
    want = np.asarray(js.simpson_even_fast_weights_dynamic(76, jnp.asarray(nb)))
    got = ts.simpson_even_fast_weights_dynamic(76, torch.tensor(nb)).numpy()
    assert np.array_equal(got, want)
    y = np.linspace(0.0, 1.0, 76)
    np.testing.assert_allclose(
        ts.integrate_simpson_even_fast(torch.tensor(y), 0.1, torch.tensor(got)).numpy(),
        np.asarray(js.integrate_simpson_even_fast(jnp.asarray(y), 0.1, jnp.asarray(want))),
        rtol=1e-14)
