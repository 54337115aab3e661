"""The long-horizon check (`cloudy_tpu_torch.tools.longhorizon`) on the CPU,
through the whole-step kernel's twins: the f32 fast tier against the f64
reference tier at nz 32 with E = 4 columns, from the tool's spread start,
held to the JAX gate's bounds (tests/test_golden.py:194-253: scaled error <
1e-3, |drift32 − drift64| < 1e-4, finite) at every one of its checkpoints
over 200 steps: the longest horizon that keeps this file under 30 s on one
worker (the f64 reference twin takes ~0.1 s a step at 128 lanes; 1000 steps
run on the card, chip_smoke.py phase 27). Then the CLI at a few steps.
"""

import json

import numpy as np
import torch

from cloudy_tpu_torch.tools import longhorizon as lh

torch.set_num_threads(1)

HORIZON = 200


def test_f32_fast_twin_holds_the_f64_reference_twin():
    fast, ref = lh.make_steps(32, "cpu")
    assert (fast.route, fast.dtype, ref.route, ref.dtype) == (
        "generated", torch.float32, "generated", torch.float64)
    assert not fast.plan.ref and ref.plan.ref
    rec, states = lh.run_depth("pod", 32, fast, ref, n_steps=HORIZON, columns=4)
    assert rec["n_columns"] == 4 and rec["card"] == "cpu" and rec["clock"] == "host"
    assert rec["launches_f32"] == rec["launches_f64"] == 0
    assert [r["t"] for r in rec["checkpoints"]] == list(range(20, HORIZON + 1, 20))
    assert len(states["f32"]) == len(states["f64"]) == lh.CHECKPOINTS
    assert states["f32"][0].shape == (4, 32, 6)
    for r in rec["checkpoints"]:
        assert r["finite"], r
        assert r["traj_err_max_scaled"] < 1e-3, r
        assert abs(r["f32_mass_drift_vs_t0"] - r["f64_mass_drift_vs_t0"]) < lh.DRIFT_GATE, r
    # the columns drain: both runs lose mass through the bottom
    assert rec["checkpoints"][-1]["f64_mass_drift_vs_t0"] < -0.01
    assert rec["gate_failures"] == []


def test_gates_read_the_jax_bounds():
    row = {"traj_err_max_scaled": 1.5e-3, "f32_mass_drift_vs_t0": -0.5,
           "f64_mass_drift_vs_t0": -0.5, "finite": True}
    rec = {"nz": 128, "finite": True,
           "checkpoints": [dict(row, t=t) for t in (100, 500, 1000)]}
    assert lh.gate_failures(rec) == []  # under nz 128's 2e-3; t = 100 is not gated
    rec["nz"] = 32
    assert lh.gate_failures(rec) == ["t=1000: scaled error 1.500e-03 >= 1e-03"]
    rec["checkpoints"][2]["f32_mass_drift_vs_t0"] = -0.4
    rec["finite"] = False
    assert len(lh.gate_failures(rec)) == 3


def test_cli_prints_records_and_writes_only_outdir(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    assert lh.main(["--device", "cpu", "--steps", "10", "--columns", "1",
                    "--outdir", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert [(r["scenario"], r["nz"], r["n_steps"]) for r in recs] == [
        ("longhorizon_pod_f32_wholestep", 32, 10),
        ("longhorizon_rainshaft_128_f32_wholestep", 128, 10)]
    assert all(r["finite"] and not r["gate_failures"] for r in recs)
    assert all(np.isfinite(r["ms_per_step_f64"]) for r in recs)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert [json.loads(ln) for ln in (out / "longhorizon.jsonl").read_text().splitlines()] \
        == recs
