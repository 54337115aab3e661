"""The frozen reference against the port's plain twins, on the CPU."""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import rainshaft as ref
from benchmark.tests.support import ROOT


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _port_step(dtype):
    from cloudy_tpu_torch import harness
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import fused_coalescence as fc

    spec, data = harness.pod_data("fixed2gamma")
    c = rs.RainshaftConfig(spec=spec, nz=32, zmax=3000.0, norms=(1e6, 1e-9), dt=1.0)
    return fc.make_rainshaft_step_fn(data, c.vel, c.norms, nz=32, dz=c.dz, dt=c.dt,
                                     device="cpu", dtype=dtype)


def _state(physics, dtype, columns=8):
    col = ref.initial_column(physics)
    fac = np.linspace(0.7, 1.3, columns)
    return torch.as_tensor((col[:, None, :] * fac[None, :, None]).reshape(col.shape[0], -1),
                           dtype=dtype)


def test_tables_are_the_ports():
    """The reference derives from the file the tables the port derives
    from its own set-up: the assembly weights, the threshold, the norms,
    the velocity and the grid."""
    t = ref.build_tables(_config("pod_fixed2gamma")["physics"], "float32")
    plan = _port_step(torch.float32).plan
    assert t.wb_nz == plan.wb_nz and t.wf_nz == plan.wf_nz
    assert t.thr == plan.thr_const and t.mom_norms == plan.mom_norms
    assert t.vel_n == plan.vel_n and t.inv_dz == plan.inv_dz and t.dt == plan.dt
    assert t.gl_nodes == plan.gl_nodes and t.nz == plan.nz


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_step_matches_the_twin(dtype):
    """20 steps of 8 columns: the reference, run in the type it states,
    repeats the twin bit for bit."""
    physics = _config("pod_fixed2gamma")["physics"]
    t = ref.build_tables(physics, str(dtype).split(".")[1])
    step = _port_step(dtype)
    a = _state(physics, dtype)
    b = a.clone()
    for _ in range(20):
        a = step(a)
        b = ref.step(t, b)
    assert torch.equal(a, b)


def test_run_saves_every_frame():
    physics = _config("pod_fixed2gamma")["physics"]
    t = ref.build_tables(physics, "float32")
    y0 = _state(physics, torch.float64, columns=3)
    out = ref.run(t, y0, 6, 3, block_lanes=64)  # two blocks of columns
    y = y0
    for n in range(6):
        y = ref.step(t, y)
        if n == 2:
            assert torch.equal(out[0], y)
    assert torch.equal(out[1], y)
