"""The port's pod harness: checkpoint and resume, the run report, and the
NetCDF output of `--outdir`, on the CPU (the whole-step kernel's twin).

- cut after one 40-step segment and resumed, a pod run is bit for bit the
  plain `run()` (tests/test_harness.py:86-116);
- the report counts the steps this invocation ran (``n_steps_run``) and
  divides its rate by them: 80 on the resumed call, 0 and a null rate on a
  re-run over the finished directory (where the JAX harness divides by the
  configured 120, harness.py:360);
- the pod's mean-profile NetCDF (``--outdir``): its frames are the column
  means of the port's own states, and the last is within 1e-4,
  per-moment-scaled, of JAX's `run_diagnostics` at 8 columns (measured
  5.8e-6: f32 through two formulations, JAX's XLA path on the AoS layout
  against the port's fused twin).

The box and rainshaft files are tests/test_torch_harness_output.py's; the
mean profile of a resumed run and a checkpoint of another width are
tests/test_torch_harness_resume.py's.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from cloudy_tpu import harness as jharness

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

N_COLS = 8


@pytest.fixture(scope="module")
def jax_mean_profile():
    """JAX's pod `run_diagnostics` at 8 columns (one run per module)."""
    _, profs = jharness._scenario_pod_ensemble(n_columns=N_COLS)["diagnostics"]()
    return np.asarray(profs, np.float64)


def read_nc(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.asarray(v[:]).astype(np.float64) for k, v in f.variables.items()}, \
            dict(f.dimensions)


def _flat_moments(mom, spec):
    """The NetCDF's per-mode padded ``moments`` [..., dist, order] back to
    the flat ``[..., n_tot]``."""
    return np.concatenate([mom[..., i, :n] for i, n in enumerate(spec.nprogmoms)], axis=-1)


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving"])
def test_pod_checkpoint_resume_bit_identical(tmp_path, variant):
    """Cut after one 40-step segment (simulated preemption), resumed: the
    state is the plain run's bit for bit (an uninterrupted checkpointed run
    is held to it by tests/test_torch_harness_output.py's CLI test)."""
    name = {"fixed2gamma": "pod_ensemble", "moving": "pod_ensemble_moving"}[variant]
    sc = harness.SCENARIOS[name](n_columns=N_COLS, device="cpu")
    path = str(tmp_path / "pod")
    assert sc["run_checkpointed"](path, segment=40, max_segments=1) is None
    assert ck.latest_step(path) == 40
    y_res, _, clock, info = sc["run_checkpointed"](path, segment=40)
    assert clock == "host" and info["resumed_from_step"] == 40
    assert info["n_steps_run"] == 80 and len(info["save_s"]) == 2
    assert info["checkpoint_bytes"] > y_res.numel() * 4
    assert ck.latest_step(path) == 120
    y_plain, _, _ = sc["run"]()
    assert torch.equal(y_res, y_plain)


def test_report_counts_the_steps_run_and_writes_the_mean_profile(tmp_path, jax_mean_profile):
    """run_scenario cut after one segment, resumed with --outdir, then run
    again over the finished directory."""
    ckd, out = str(tmp_path / "ck"), str(tmp_path / "out")
    y, cut = harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd, segment=40,
                                  max_segments=1, n_columns=N_COLS)
    assert y is None and cut["completed"] is False and cut["n_steps_run"] == 40
    state, rep = harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd, outdir=out,
                                      segment=40, n_columns=N_COLS)
    assert rep["completed"] and rep["n_steps"] == 120 and rep["n_steps_run"] == 80
    assert rep["resumed_from_step"] == 40 and rep["launches"] == 0
    assert rep["column_updates_per_s"] == pytest.approx(N_COLS * 80 / rep["seconds"])
    assert rep["finite"] and rep["negative_fraction"] == 0.0
    again_state, again = harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd,
                                              n_columns=N_COLS)
    assert again["n_steps_run"] == 0 and again["column_updates_per_s"] is None
    assert again["seconds"] == 0.0 and again["save_s"] == []
    assert torch.equal(again_state, state)
    logged = [json.loads(ln) for ln in (tmp_path / "out" / "runs.jsonl").read_text().splitlines()]
    assert logged == [rep]

    # the mean profile: 12 frames, each the column mean of the port's state
    sc = harness.SCENARIOS["pod_ensemble"](n_columns=N_COLS, device="cpu")
    var, dims = read_nc(tmp_path / "out" / "pod_ensemble_mean_profile.nc")
    assert dims == {"time": 12, "z": 32, "dist": 2, "order": 3, "param": 3}
    np.testing.assert_array_equal(var["time"], 10.0 * np.arange(1, 13))
    np.testing.assert_array_equal(var["z"], sc["config"].z)
    frames = _flat_moments(var["moments"], sc["spec"])
    y = sc["state0"]
    for k in range(12):
        for _ in range(10):
            y = sc["step"](y)
        np.testing.assert_array_equal(frames[k], harness.column_mean(y, 32).double().numpy())
    assert torch.equal(y, rs.to_soa(state))
    scale = np.abs(jax_mean_profile).max(axis=(0, 1))
    assert (np.abs(frames[-1] - jax_mean_profile[-1]) / scale).max() < 1e-4

