"""The port's checkpointed pod run on the CPU (the whole-step kernel's
twin), past what tests/test_torch_harness.py holds:

- the mean-profile frames are taken on the way and kept beside each
  checkpoint, so a resumed run with ``--outdir`` writes its NetCDF without
  `diagnostics`' second pass over all the steps; where the resumed
  checkpoint has no frames (one the JAX package wrote), `diagnostics` makes
  them; either way they are the plain chain's column means;
- a checkpoint of another ensemble width does not resume.
"""

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from cloudy_tpu_torch import harness

torch.set_num_threads(1)


def read_nc(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.asarray(v[:]).astype(np.float64) for k, v in f.variables.items()}, \
            dict(f.dimensions)


def _flat_moments(mom, spec):
    """The NetCDF's per-mode padded ``moments`` [..., dist, order] back to
    the flat ``[..., n_tot]``."""
    return np.concatenate([mom[..., i, :n] for i, n in enumerate(spec.nprogmoms)], axis=-1)


def _expected_frames(sc):
    """The column means every 10 steps of the plain chain from `state0`."""
    y, frames = sc["state0"], []
    for _ in range(12):
        for _ in range(10):
            y = sc["step"](y)
        frames.append(harness.column_mean(y, 32).double().numpy())
    return frames


@pytest.mark.parametrize("frames_kept", [True, False])
def test_resumed_mean_profile_takes_no_second_pass(tmp_path, monkeypatch, frames_kept):
    """A checkpointed pod run keeps its mean-profile frames beside each
    checkpoint, so the resumed run writes the NetCDF without `diagnostics`
    (which would repeat all 120 steps). Without them (a checkpoint the JAX
    package wrote: its frames file removed here), `diagnostics` makes them.
    Either way the frames are the plain chain's column means."""
    built = {}

    def scenario(**kw):
        sc = harness._scenario_pod_ensemble(**kw)
        if frames_kept:
            def no_second_pass():
                raise AssertionError("diagnostics ran after a checkpointed run")
            sc["diagnostics"] = no_second_pass
        built["sc"] = sc
        return sc

    monkeypatch.setitem(harness.SCENARIOS, "pod_ensemble", scenario)
    ckd, out = str(tmp_path / "ck"), str(tmp_path / "out")
    harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd, segment=40,
                         max_segments=1, n_columns=2)
    frames40 = tmp_path / "ck" / "pod_ensemble_profile_step40.npy"
    assert np.load(frames40).shape == (4, 32, 6)
    if not frames_kept:
        frames40.unlink()
    _, rep = harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd, outdir=out,
                                  segment=40, n_columns=2)
    assert rep["n_steps_run"] == 80 and "profiles" not in rep
    var, dims = read_nc(tmp_path / "out" / "pod_ensemble_mean_profile.nc")
    assert dims["time"] == 12
    frames = _flat_moments(var["moments"], built["sc"]["spec"])
    for got, want in zip(frames, _expected_frames(built["sc"])):
        np.testing.assert_array_equal(got, want)


def test_checkpoint_of_another_width_does_not_resume(tmp_path):
    """A directory left by a 2-column run does not resume an 8-column one."""
    ckd = str(tmp_path / "ck")
    harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd, segment=10,
                         max_segments=1, n_columns=2)
    with pytest.raises(ValueError, match="shape"):
        harness.run_scenario("pod_ensemble", device="cpu", ckpt_dir=ckd, n_columns=8)
