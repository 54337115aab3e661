"""The check refuses what it should, at a tiny size on the CPU: the
control (the reference in bfloat16 put in the program's place) fails a
limit of every cell, and so does each fault a cell can have, planted in
the timed path underneath a run of the harness. (One chip: no exchange
between chips to leave out.)"""

import copy

import torch

from benchmark.tests.support import TINY_TRAFFIC, cpu_run

POD = "pod_fixed2gamma.frames10"


def _driver(bench, workload, seed=2**33 + 5):
    from benchmark import run
    from benchmark.core.trace import Tracer

    cell, config, traffic = run.load_cell(bench, workload)
    traffic = {**traffic, **copy.deepcopy(TINY_TRAFFIC[workload])}
    dev = torch.device("cpu")
    d = run.load_plugin("drivers", config["driver"]).Driver(config, traffic, seed, dev,
                                                           Tracer(False, dev))
    d.run(0.01)
    d.release()
    return d, config["limits"]


def test_the_control_fails(bench):
    d, limits = _driver(bench, POD)
    gaps = d.check(control_dtype=torch.bfloat16)
    assert any(not v <= limits[k] for k, (v, _) in gaps.items())
    sound = d.check()
    assert all(v <= limits[k] for k, (v, _) in sound.items())


def _unchanged(self, mom, *args):
    return mom.clone()


def _altered(orig):
    def call(self, mom, *args):
        out = orig(self, mom, *args)
        i = int(out[1].argmax())
        out[1, i] *= 1.01  # one lane's mass, where the step produces it
        return out
    return call


def test_pod_faults(bench, monkeypatch):
    from cloudy_tpu_torch import harness
    from cloudy_tpu_torch.ops import fused_coalescence as fc

    with monkeypatch.context() as m:
        m.setattr(fc.RainshaftStepFn, "__call__", _unchanged)
        assert cpu_run(bench, POD)["correct"] is False

    orig_mean = harness.column_mean

    def half_mean(y, nz, *args, **kw):  # half of the columns, the mean over the rest
        return orig_mean(y[:, : y.shape[1] // (2 * nz) * nz].contiguous(), nz)

    with monkeypatch.context() as m:
        m.setattr(harness, "column_mean", half_mean)
        assert cpu_run(bench, POD)["correct"] is False

    with monkeypatch.context() as m:
        m.setattr(fc.RainshaftStepFn, "__call__", _altered(fc.RainshaftStepFn.__call__))
        assert cpu_run(bench, POD)["correct"] is False

    assert cpu_run(bench, POD)["correct"] is True
