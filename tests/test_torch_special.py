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
# ndtri incl. both tails; the upper one stops at 1 − 1e-6, since in f32 a p
# within 6e-8 of 1 rounds to 1, where both packages return NaN
_PCT = np.concatenate([_RNG.uniform(0.0, 1.0, 500), np.logspace(-9, -1.7, 50),
                       1.0 - np.logspace(-6, -1.7, 50)])
_KI = _RNG.uniform(0.02, 10.0, 600)  # percentile-inverse shapes
_PI = _RNG.uniform(0.01, 0.995, 600)  # and percentiles
_AS = _RNG.uniform(1e-3, 10.0, 600)  # gammainc_gl_shift orders (any a > 0)
_Z = np.concatenate([_RNG.uniform(-8.0, 8.0, 599), [0.0]])  # erf arguments

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
    "ndtri": (lambda m, dt: m.ndtri(_c(m, _PCT, dt))),
    "gammainc_gl_shift": (
        lambda m, dt: m.gammainc_gl_shift(_c(m, _AS, dt), _c(m, _X, dt))
    ),
    "gammaincinv_gl": (
        lambda m, dt: m.gammaincinv_gl_impl(_c(m, _KI, dt), _c(m, _PI, dt))
    ),
    "gammaincinv_newton_8x12": (
        lambda m, dt: m.gammaincinv_impl(_c(m, _KI, dt), _c(m, _PI, dt),
                                         n_newton=8, n_iters=12)
    ),
    "erf_approx": (lambda m, dt: m.erf_approx(_c(m, _Z, dt))),
    "erf_impl": (lambda m, dt: m.erf_impl(_c(m, _Z, dt), n_iters=128)),
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


def test_ndtri_scipy_bound():
    """tests/test_special.py:51-56."""
    p = np.array([1e-9, 1e-4, 0.01, 0.3, 0.5, 0.7, 0.99, 1 - 1e-6])
    got = tsp.ndtri(torch.tensor(p)).numpy()
    want = ss.ndtri(p)
    assert np.all(np.abs(got - want) <= 1e-8 + 1e-5 * np.abs(want))


def test_gammainc_gl_shift_scipy_bound():
    """tests/test_special.py:148-157: 5e-7 absolute over a ∈ (0, 10] ×
    x ∈ (0, 1e6]."""
    a = np.logspace(-3, 1, 60)
    x = np.concatenate([np.logspace(-6, 6, 80), np.linspace(0.5, 40.0, 160)])
    A, X = np.meshgrid(a, x)
    got = tsp.gammainc_gl_shift(torch.tensor(A), torch.tensor(X)).numpy()
    assert np.abs(got - ss.gammainc(A, X)).max() < 5e-7


def test_gammaincinv_gl_scipy_bound():
    """tests/test_special.py:160-173: 2e-5 relative over k ∈ [0.02, 10] ×
    p ∈ [0.01, 0.995] (f64)."""
    k = np.logspace(np.log10(0.02), 1, 90)
    p = np.array([0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.995])
    Kk, P = np.meshgrid(k, p, indexing="ij")
    got = tsp.gammaincinv_gl_impl(torch.tensor(Kk), torch.tensor(P)).numpy()
    assert np.abs(got / ss.gammaincinv(Kk, P) - 1.0).max() < 2e-5


def test_erf_approx_scipy_bound():
    """tests/test_special.py:219-229: 1.6e-7 absolute over the real line,
    and exactly 0 at 0 (sign, not copysign)."""
    x = np.concatenate([np.linspace(-8, 8, 4001), np.array([-1e9, -30.0, 30.0, 1e9, 0.0])])
    got = tsp.erf_approx(torch.tensor(x)).numpy()
    assert np.abs(got - ss.erf(x)).max() < 1.6e-7
    assert got[-1] == 0.0


# the public wrappers (cloudy_tpu/ops/special.py:112, :295-309, :569-585,
# :587) on the same seeded inputs
WRAPPERS = {
    "gammafn": (lambda m, dt: m.gammafn(_c(m, _K, dt))),
    "gammainc": (lambda m, dt: m.gammainc(_c(m, _A, dt), _c(m, _X, dt))),
    "gammaincc": (lambda m, dt: m.gammaincc(_c(m, _A, dt), _c(m, _X, dt), n_iters=24)),
    "gammaincinv_gl": (lambda m, dt: m.gammaincinv_gl(_c(m, _KI, dt), _c(m, _PI, dt))),
    "gammaincinv": (
        lambda m, dt: m.gammaincinv(_c(m, _KI, dt), _c(m, _PI, dt), n_newton=8, n_iters=24)
    ),
    "erf": (lambda m, dt: m.erf(_c(m, _Z, dt))),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_public_wrapper_f64_matches_jax(name):
    fn = WRAPPERS[name]
    want, got = _np(fn(jsp, "f64")), _np(fn(tsp, "f64"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_public_wrapper_f32_matches_jax(name):
    """As `test_special_f32_matches_jax` for the composite functions."""
    fn = WRAPPERS[name]
    truth = _np(fn(jsp, "f64"))
    want, got = _np(fn(jsp, "f32")), _np(fn(tsp, "f32"))
    jax_err = np.abs(want - truth).max()
    port_err = np.abs(got - truth).max()
    assert port_err <= 2.0 * jax_err + 1e-30, (port_err, jax_err)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=4.0 * jax_err)


def test_gammafn_scipy_bound():
    """Γ through the Lanczos lgamma (tests/test_special.py:12-18's domain)."""
    x = np.concatenate([np.linspace(0.01, 1.0, 57), np.linspace(1.0, 50.0, 200)])
    got = tsp.gammafn(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ss.gamma(x), rtol=1e-11, atol=0.0)


def test_gammainc_scipy_bound():
    """tests/test_special.py:21-27: P(a, x) to rtol 5e-12, atol 1e-14, and
    Q = 1 − P."""
    a = np.logspace(-3, np.log10(50.0), 40)
    x = np.concatenate([[0.0], np.logspace(-8, np.log10(200.0), 80)])
    A, X = np.meshgrid(a, x)
    got = tsp.gammainc(torch.tensor(A), torch.tensor(X)).numpy()
    np.testing.assert_allclose(got, ss.gammainc(A, X), rtol=5e-12, atol=1e-14)
    q = tsp.gammaincc(torch.tensor(A), torch.tensor(X)).numpy()
    np.testing.assert_allclose(q, 1.0 - got, rtol=0.0, atol=1e-15)


def test_gammainc_extremes():
    """tests/test_special.py:30-35: P(a, inf) = 1, P(a, x <= 0) = 0, finite
    far out; Python numbers are taken in float64, as JAX takes them."""
    assert float(tsp.gammainc(2.0, float("inf"))) == 1.0
    assert float(tsp.gammainc(2.0, 0.0)) == 0.0
    assert float(tsp.gammainc(2.0, -1.0)) == 0.0
    assert np.isfinite(float(tsp.gammainc(10.0, 1e30)))
    assert tsp.gammainc(2.0, 1.3).dtype == torch.float64
    assert tsp.gammainc(2.0, torch.tensor([1.3], dtype=torch.float32)).dtype == torch.float32


def test_gammaincinv_roundtrip():
    """tests/test_special.py:38-48: the Newton inverse against scipy to
    rtol 1e-8 over k ∈ [0.1, 20] and p from 1e-4 to 1 − 1e-6, and back
    through P(a, ·)."""
    a = np.logspace(-1, np.log10(20.0), 25)
    p = np.array([1e-4, 1e-3, 0.03, 0.25, 0.5, 0.75, 0.97, 0.99, 1 - 1e-6])
    A, P = np.meshgrid(a, p)
    x = tsp.gammaincinv(torch.tensor(A), torch.tensor(P))
    np.testing.assert_allclose(x.numpy(), ss.gammaincinv(A, P), rtol=1e-8, atol=1e-280)
    back = tsp.gammainc(torch.tensor(A), x).numpy()
    np.testing.assert_allclose(back, P, rtol=1e-8, atol=0.0)


def test_gammaincinv_gl_wrapper_scipy_bound():
    """tests/test_special.py:160-173 through the public wrapper."""
    k = np.logspace(np.log10(0.02), 1, 90)
    p = np.array([0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.995])
    Kk, P = np.meshgrid(k, p, indexing="ij")
    got = tsp.gammaincinv_gl(torch.tensor(Kk), torch.tensor(P)).numpy()
    assert np.abs(got / ss.gammaincinv(Kk, P) - 1.0).max() < 2e-5


def test_erf_scipy_bound():
    x = np.concatenate([np.linspace(-8, 8, 4001), [-1e9, -30.0, 30.0, 1e9, 0.0]])
    got = tsp.erf(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ss.erf(x), rtol=1e-15, atol=1e-16)
