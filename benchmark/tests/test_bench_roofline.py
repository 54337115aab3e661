"""The rooflines' operation counts: the benchmark's counter on its frozen
reference repeats exactly, and counts what the port's own counter counts
on the port's float32 twin."""

import json


from benchmark import roofline
from benchmark.tests.support import ROOT


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_counts_repeat_exactly():
    a = roofline.work("b1", _config("pod_fixed2gamma"))
    b = roofline.work("b1", _config("pod_fixed2gamma"))
    assert a == b
    assert a["ops_per_lane"] == int(a["ops_per_lane"]) > 0


def test_counts_are_the_ports():
    from cloudy_tpu_torch import harness
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.tools import opcount
    from benchmark.roofline.b1 import state

    cfg = _config("pod_fixed2gamma")
    spec, data = harness.pod_data("fixed2gamma")
    c = rs.RainshaftConfig(spec=spec, nz=32, zmax=3000.0, norms=(1e6, 1e-9), dt=1.0)
    y = state(cfg).float()
    step = fc.make_rainshaft_step_fn(data, c.vel, c.norms, nz=32, dz=c.dz, dt=c.dt, device="cpu")
    ports = opcount.count_ops(step.plain, y) / y.shape[1]
    assert roofline.work("b1", cfg)["ops_per_lane"] == ports


def test_bounds_at_the_cells_sizes():
    """B1 at 2^20 × 32 lanes: the bound the port's tools give today
    (1.2756 ms, operations)."""
    card = "NVIDIA H100 80GB HBM3"
    b1 = roofline.bound_us("b1", _config("pod_fixed2gamma"), 1 << 25, card)
    assert abs(b1 - 1275.569) < 0.01
    assert roofline.bound_us("b1", _config("pod_fixed2gamma"), 1 << 25, "cpu") is None
