"""Gradients through the port's torch reference path against `jax.grad`.

The B kernels are forward-only, as the Pallas kernels are: the JAX package
differentiates through its XLA path, and the port through its torch path
(closure inversion → Simpson-tier autoconversion → Q/R/S → SSPRK33 steps).
Same setup as tests/test_autodiff.py at f64, 5 steps instead of 20 to stay
small. Pass: relative error < 1e-8 against the largest gradient component:
the same arithmetic differentiated by two systems, whose derivative rules
differ in rounding only.

The JAX derivative is taken once per module, in forward mode (`jax.jacfwd`),
of the loss as a function of (initial moments, s, kernel coefficients)
through `make_kernel_diff_coal_fn` at the stored coefficients, where it
equals the static path to 1e-12 (asserted below): on XLA:CPU reverse mode
(`jax.grad`) compiles such a graph in ~38 s, forward mode in ~20 s, and
both are JAX's own differentiation of the same loss. The JAX package pins
its rematerialised gradient to its plain one (tests/test_autodiff.py), so
the port's gradient with and without `remat` is held against the one JAX
derivative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu import stepper as jstepper
from cloudy_tpu.coalescence import (
    build_coalescence_data as jbuild,
    get_coal_ints as jcoal,
    make_kernel_diff_coal_fn as jdiff,
)
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch import stepper
from cloudy_tpu_torch.coalescence import (
    build_coalescence_data,
    get_coal_ints,
    make_kernel_diff_coal_fn,
)
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
MOM0 = np.array([1e2, 1e1, 2.0, 1e-6, 1e-5, 2e-4])
W = 1.0 / np.array([1e2, 1e1, 2.0, 1e-2, 1e-2, 1e-2])
TOL = 1e-8


def _setup():
    """(JAX spec, JAX data, port spec, port data) of tests/test_autodiff.py."""
    jspec = JSpec((JF.GAMMA, JF.GAMMA))
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    jdata = jbuild(jspec, jker, (5e-10, np.inf), norms=NORMS, gammainc_iters=32)
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS,
                                  gammainc_iters=32)
    return jspec, jdata, spec, data


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


N_STEPS = 5


def _jax_loss(jspec, jdata):
    """JAX's trajectory loss in (initial moments, s, kernel coefficients)."""
    jfn = jdiff(jdata)

    def jloss(mom0, s, kernels):
        def rhs(m, t):
            return s * jfn(jpd.params_from_moments(jspec, m), kernels)

        _, ys = jstepper.integrate(rhs, mom0, 0.0, 1.0, N_STEPS)
        return jnp.sum((ys[-1] * jnp.asarray(W)) ** 2)

    return jloss


def _port_loss(spec, coal, remat=False):
    """The port's loss; ``coal(params) -> [..., n_tot]``."""

    def loss(mom0, s):
        def rhs(m, t):
            return s * coal(pd.params_from_moments(spec, m))

        _, ys = stepper.integrate(rhs, mom0, 0.0, 1.0, N_STEPS, remat=remat)
        return torch.sum((ys[-1] * torch.tensor(W)) ** 2)

    return loss


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's loss value and its derivative in (initial moments, s, kernel
    coefficients) at (MOM0, 1, the stored coefficients)."""
    jspec, jdata, _, _ = _setup()
    jloss = _jax_loss(jspec, jdata)
    args = (jnp.asarray(MOM0), jnp.asarray(1.0), jnp.asarray(jdata.kernels))
    value, grads = jax.jit(
        lambda *a: (jloss(*a), jax.jacfwd(jloss, argnums=(0, 1, 2))(*a)))(*args)
    return (float(value),) + tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_grad_moments_and_scale_match_jax(remat, jax_grads):
    """d loss / d (initial moments, kernel scale s) through the static path
    `get_coal_ints`, with and without rematerialisation."""
    want_v, want_m, want_s, _ = jax_grads
    _, _, spec, data = _setup()
    loss = _port_loss(spec, lambda p: get_coal_ints(data, p), remat=remat)
    mom0 = torch.tensor(MOM0, requires_grad=True)
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    value = loss(mom0, s)
    value.backward()
    assert abs(value.item() - want_v) / abs(want_v) < TOL
    assert np.all(np.isfinite(mom0.grad.numpy())) and float(s.grad) != 0.0
    assert _rel(mom0.grad.numpy(), want_m) < TOL
    assert _rel(float(s.grad), want_s) < TOL


def test_remat_leaves_the_gradient_unchanged():
    """`torch.utils.checkpoint` recomputes the same stages: the gradient is
    the plain one to the last bits."""
    _, _, spec, data = _setup()
    grads = []
    for remat in (False, True):
        s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        loss = _port_loss(spec, lambda p: get_coal_ints(data, p), remat=remat)
        loss(torch.tensor(MOM0), s).backward()
        grads.append(float(s.grad))
    assert abs(grads[0] - grads[1]) <= 1e-12 * abs(grads[0])


def test_grad_through_kernel_tensor_coefficients_matches_jax(jax_grads):
    """d loss / d kernel coefficients through `make_kernel_diff_coal_fn`; at
    the stored coefficients the diff path equals the static path and the
    JAX diff path (rtol 1e-12)."""
    jspec, jdata, spec, data = _setup()
    fn = make_kernel_diff_coal_fn(data)
    k0 = np.asarray(data.kernels)
    np.testing.assert_array_equal(k0, np.asarray(jdata.kernels))

    p0 = pd.params_from_moments(spec, torch.tensor(MOM0))
    np.testing.assert_allclose(fn(p0, torch.tensor(k0)).numpy(),
                               get_coal_ints(data, p0).numpy(), rtol=1e-12)
    jdiff_k0, jstatic = jax.jit(lambda m: (
        jdiff(jdata)(jpd.params_from_moments(jspec, m), jnp.asarray(k0)),
        jcoal(jdata, jpd.params_from_moments(jspec, m))))(jnp.asarray(MOM0))
    np.testing.assert_allclose(fn(p0, torch.tensor(k0)).numpy(), np.asarray(jdiff_k0),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jdiff_k0), np.asarray(jstatic), rtol=1e-12)

    kernels = torch.tensor(k0, requires_grad=True)
    loss = _port_loss(spec, lambda p: fn(p, kernels))
    loss(torch.tensor(MOM0), 1.0).backward()
    got = kernels.grad.numpy()
    assert got.shape == k0.shape and np.all(np.isfinite(got)) and np.any(got != 0.0)
    assert _rel(got, jax_grads[3]) < TOL
