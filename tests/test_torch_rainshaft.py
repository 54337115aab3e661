"""The slice as a whole: the port's rainshaft against the stored f64 golden
trajectory and against the JAX package's rainshaft on the same data.

Errors are per-moment-scaled (|y − y_golden| / max over the trajectory of
that moment), as tests/test_golden.py does: elementwise rtol is unsafe at
near-empty levels, where values sit ~1e-20 below their moment's scale.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import kernels as JK
from cloudy_tpu import stepper as jstepper
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

from cloudy_tpu_torch import harness, kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.spec import Family, SpectrumSpec

from _golden_cases import load_golden

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)


def _scaled_err(ys, ys_g):
    scale = np.abs(ys_g).max(axis=tuple(range(ys_g.ndim - 1)))  # per moment
    return (np.abs(ys - ys_g) / scale).max()


def test_aos_simpson_tier_matches_golden_f64():
    """The torch reference path (AoS, Simpson tier, f64) reproduces
    tests/golden/rainshaft_small.npz over its 120 steps."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS)
    config = rs.RainshaftConfig(spec=spec, nz=32, zmax=3000.0, norms=NORMS,
                                t_end=120.0, dt=1.0, save_every=20)
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    ts, ys = rs.run_rainshaft(config, rs.make_rainshaft_rhs(config, data), ic)
    ts_g, ys_g = load_golden("rainshaft_small")
    np.testing.assert_allclose(ts.numpy(), ts_g, rtol=1e-12)
    assert _scaled_err(ys.numpy(), ys_g) < 1e-8


def test_pod_scenario_cpu_f32_matches_golden():
    """The port's pod scenario on the CPU (8 columns × 32 levels, f32, 120
    steps, through the whole-step kernel's plain twin) stays within 1e-3 of
    the golden's final state — the fast tier's own error there is 1.06e-4."""
    _, report = harness.run_scenario("pod_ensemble", n_columns=8, device="cpu")
    assert report["dtype"] == "float32"
    assert report["finite"] and report["negative_fraction"] == 0.0
    assert report["launches"] == 0 and report["clock"] == "host"
    sc = harness.SCENARIOS["pod_ensemble"](n_columns=8, device="cpu",
                                           dtype=torch.float32)
    y, _, _ = sc["run"]()
    got = rs.from_soa(y, 32).double().numpy()  # [8, 32, 6]
    _, ys_g = load_golden("rainshaft_small")
    assert _scaled_err(got, np.broadcast_to(ys_g[-1], got.shape)) < 1e-3
    assert np.array_equal(got[0], got[-1])  # identical columns stay identical


@pytest.mark.parametrize("reference", ["fused_rhs", "aos_rhs"])
def test_pod_scenario_f64_matches_jax_rhs(reference):
    """20 whole steps of the port's pod scenario at f64 (the twin) against
    JAX's rainshaft RHS + `stepper.integrate` on the same fast-tier data.

    - ``fused_rhs``: `make_rainshaft_rhs_fused` over the Pallas fused RHS
      kernel (interpret mode) — the XLA-orchestrated step the JAX package
      holds its whole-step kernel against (tests/test_pallas.py:606), with
      the same sedimentation arithmetic: row-scaled 1e-9 (measured 3e-15).
    - ``aos_rhs``: `make_rainshaft_rhs`, whose sedimentation flux takes
      Γ(k+e)/Γ(k) from a Lanczos-lgamma pair where the fast tier's fused
      kernels use `special.gamma_ratio` (proven < 5e-7 relative). That
      designed difference, not the port, sets the gap: 1.9e-9 row-scaled
      after 20 steps (the two JAX references differ from each other by it).
      Row-scaled 1e-8."""
    sc = harness.SCENARIOS["pod_ensemble"](n_columns=8, device="cpu",
                                           dtype=torch.float64)
    y, _, _ = sc["run"](20)
    got = y.numpy()

    jspec = JSpec((JF.GAMMA, JF.GAMMA))
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    jdata = jbuild(jspec, jker, (5e-10, np.inf), norms=NORMS, fast_tier=True)
    config = jrs.RainshaftConfig(spec=jspec, nz=32, zmax=3000.0, norms=NORMS,
                                 t_end=120.0, dt=1.0)
    ic1 = jrs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    state = jnp.asarray(np.tile(ic[None], (8, 1, 1)))
    if reference == "fused_rhs":
        fused = pc.make_pallas_rainshaft_rhs_fn(jdata, config.vel, NORMS,
                                                block_cols=256, interpret=True)
        rhs, y0, tol = jrs.make_rainshaft_rhs_fused(config, fused), jrs.to_soa(state), 1e-9
    else:
        rhs, y0, tol = jrs.make_rainshaft_rhs(config, jdata), state, 1e-8
    _, ys = jstepper.integrate(rhs, y0, 0.0, 1.0, 20, save_every=20)
    want = np.asarray(ys[-1] if reference == "fused_rhs" else jrs.to_soa(ys[-1]))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) / scale).max() < tol
