"""The port's debugging aids (`cloudy_tpu_torch.utils.debug`): the call
counter as the JAX package's, and `debug_nans` as the counterpart of
`jax_debug_nans` (tests/test_utils.py)."""

import math

import pytest
import torch

from cloudy_tpu.utils import debug as jdebug

from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.utils import debug

torch.set_num_threads(1)


def test_trace_counter_counts_calls_as_jax():
    f, counts = debug.trace_counter(lambda x, k=1: x + k)
    jf, jcounts = jdebug.trace_counter(lambda x, k=1: x + k)
    for i in range(3):
        assert f(i, k=2) == jf(i, k=2) == i + 2
    assert counts == jcounts == {"n": 3}


def test_debug_nans_raises_at_the_first_nan():
    """The operation that makes the NaN raises, not a later one; finite work
    passes; outside the block nothing is checked."""
    x = torch.tensor([1.0, -1.0], dtype=torch.float64)
    with debug.debug_nans():
        y = torch.exp(x) + 1.0  # finite
        with pytest.raises(FloatingPointError, match="nan"):
            torch.sqrt(x)
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.tensor(-1.0))
        assert torch.isfinite(y).all()
    assert math.isnan(float(torch.sqrt(x)[1]))  # the state is restored


def test_debug_nans_ignores_inf_and_integers_and_can_be_disabled():
    with debug.debug_nans():
        assert torch.isinf(torch.tensor([1.0]) / 0.0).all()
        assert int(torch.tensor([3]) // 2) == 1
        with debug.debug_nans(False):
            assert math.isnan(float(torch.tensor(0.0) / 0.0))
        with pytest.raises(FloatingPointError):
            torch.tensor(0.0) / 0.0
    with debug.debug_nans(False):
        assert math.isnan(float(torch.tensor(0.0) / 0.0))


def test_debug_nans_over_a_rainshaft_rhs():
    """A rainshaft RHS on a physical state runs clean under the check; a NaN
    moment raises inside the RHS."""
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    import numpy as np

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
    cfg = rs.RainshaftConfig(spec=spec, nz=8, zmax=3000.0)
    rhs = rs.make_rainshaft_rhs(cfg, data)
    ic1 = rs.initial_condition(cfg.z, [1e8, 1e-2, 2e-12])
    y = torch.as_tensor(np.concatenate([ic1, 0.3 * ic1], axis=-1))
    bad = y.clone()
    bad[4, 1] = float("nan")  # outside: writing a NaN is itself an operation
    with debug.debug_nans():
        assert torch.isfinite(rhs(y, 0.0)).all()
        with pytest.raises(FloatingPointError):
            rhs(bad, 0.0)
