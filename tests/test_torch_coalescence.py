"""Coalescence of the port against the JAX package on the same inputs:

- the torch reference path `get_coal_ints` against JAX's at f64, in the
  Simpson tier and the fast tier (row-scaled 1e-10: same arithmetic, the
  bilinear form summed by a matmul in another order);
- the plain twins of the two CUDA kernels against the Pallas kernels they
  replace, run in interpret mode as the JAX package's own tests run them
  (row-scaled 1e-9, as tests/test_pallas.py:656: the same arithmetic, with
  XLA's and torch's fusion and exp/log differing in the last bits).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import distributions as jd
from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild, get_coal_ints as jcoal
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data, get_coal_ints
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)


def _both(fast_tier):
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    jdata = jbuild(JSpec((JF.GAMMA, JF.GAMMA)), jker, (5e-10, np.inf),
                   norms=NORMS, fast_tier=fast_tier)
    data = build_coalescence_data(SpectrumSpec((Family.GAMMA, Family.GAMMA)), ker,
                                  (5e-10, np.inf), norms=NORMS, fast_tier=fast_tier)
    return jdata, data


def _params(B, seed):
    """Physically consistent inputs: parameters first (n, θ, k per mode)."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.stack([rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                   rng.uniform(0.5, 5.0, B)], -1) for _ in range(2)], axis=1)


def _row_scaled(got, want, axis):
    scale = np.abs(want).max(axis=axis, keepdims=True)
    return (np.abs(got - want) / np.maximum(scale, 1e-300)).max()


@pytest.mark.parametrize("fast_tier", [False, True], ids=["simpson", "fast"])
def test_get_coal_ints_matches_jax_f64(fast_tier):
    jdata, data = _both(fast_tier)
    params = _params(64, seed=11)
    want = np.asarray(jcoal(jdata, jnp.asarray(params)))
    got = get_coal_ints(data, torch.tensor(params)).numpy()
    assert _row_scaled(got, want, axis=0) < 1e-10


def test_coal_twin_matches_pallas_coal_fn():
    jdata, data = _both(True)
    mom = np.asarray(jd.get_moments(JSpec((JF.GAMMA, JF.GAMMA)),
                                    jnp.asarray(_params(128, seed=12))))
    want = np.asarray(pc.make_pallas_coal_fn(jdata, block_cols=128, interpret=True)
                      .soa(jnp.asarray(mom.T)))
    fn = fc.make_coal_fn(data, device="cpu", dtype=torch.float64)
    got = fn.soa(torch.tensor(mom.T.copy())).numpy()
    assert _row_scaled(got, want, axis=1) < 1e-9
    assert fn.launches == 0


def test_step_twin_matches_pallas_whole_step():
    """nz = 16, 8 columns, fast tier; both modes seeded (with the second mode
    empty its rows hold only promotion dust and the comparison would be of
    knife-edge noise, tests/test_pallas.py:625-632), a negative moment and an
    empty level planted."""
    jdata, data = _both(True)
    config = jrs.RainshaftConfig(spec=JSpec((JF.GAMMA, JF.GAMMA)), nz=16,
                                 zmax=3000.0, norms=NORMS)
    ic = np.concatenate([jrs.initial_condition(config.z, [1e8, 1e-2, 2e-12]),
                         jrs.initial_condition(config.z, [1e7, 1e-3, 2e-13])], -1)
    st = np.tile(ic[None], (8, 1, 1)) * np.linspace(0.5, 1.5, 8)[:, None, None]
    st[0, 8, 0] *= -1.0
    st[1, 9, :] = -1e-3
    state = np.asarray(jrs.to_soa(jnp.asarray(st)))
    want = np.asarray(pc.make_pallas_rainshaft_step_fn(
        jdata, VEL, NORMS, nz=16, dz=config.dz, dt=1.0, block_cols=128,
        interpret=True)(jnp.asarray(state)))
    step = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=16, dz=config.dz,
                                     dt=1.0, device="cpu", dtype=torch.float64)
    got = step(torch.tensor(state)).numpy()
    assert _row_scaled(got, want, axis=1) < 1e-9
    assert step.launches == 0
