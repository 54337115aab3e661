"""The NetCDF files of the port's harness (``--outdir``) against the JAX
package's, on the CPU: a box run live in both packages, and `rainshaft_128`
for its first 30 s against JAX's writer on the same frames of its stored
golden (JAX's own run, tests/_golden_cases.py), every variable to 1e-6,
per-moment-scaled; and the CLI's ``--ckpt`` and ``--outdir``.
"""

import json

import numpy as np
import torch
from scipy.io import netcdf_file

from cloudy_tpu import harness as jharness
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec
from cloudy_tpu.utils import io as jio

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.utils import checkpoint as ck

from _golden_cases import load_golden

torch.set_num_threads(1)


def read_nc(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.asarray(v[:]).astype(np.float64) for k, v in f.variables.items()}, \
            dict(f.dimensions)


def test_outdir_box_file_matches_jax(tmp_path):
    name = "box_single_gamma_golovin"
    harness.run_scenario(name, device="cpu", outdir=str(tmp_path / "port"))
    jharness.run_scenario(name, outdir=str(tmp_path / "jax"))
    got, gdims = read_nc(tmp_path / "port" / f"{name}.nc")
    want, wdims = read_nc(tmp_path / "jax" / f"{name}.nc")
    assert gdims == wdims and set(got) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max(axis=0)
        assert (np.abs(got[k] - w) / np.where(scale > 0, scale, 1.0)).max() < 1e-6, k


def test_outdir_rainshaft_file_matches_jax(tmp_path):
    """`rainshaft_128` for its first 30 s (two frames, f64, torch ops)
    against JAX's writer on the same frames of its stored run."""
    ts_g, ys_g = load_golden("rainshaft_128")
    _, rep = harness.run_scenario("rainshaft_128", device="cpu", outdir=str(tmp_path),
                                  t_end=30.0)
    assert rep["finite"]
    z = (np.arange(128) + 0.5) * 3000.0 / 128
    jio.rainshaft_output(str(tmp_path / "jax.nc"), JSpec((JF.GAMMA, JF.GAMMA)), ts_g[:2], z,
                         ys_g[:2])
    got, gdims = read_nc(tmp_path / "rainshaft_128.nc")
    want, wdims = read_nc(tmp_path / "jax.nc")
    assert gdims == wdims == {"time": 2, "z": 128, "dist": 2, "order": 3, "param": 3}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max(axis=tuple(range(w.ndim - 1)) if w.ndim > 1 else 0)
        assert (np.abs(got[k] - w) / np.where(scale > 0, scale, 1.0)).max() < 1e-6, k


def test_cli_ckpt_and_outdir(tmp_path, capsys):
    """`--ckpt` and `--outdir` through the CLI: an uninterrupted
    checkpointed run whose mean profile's last frame is its last
    checkpoint's column mean, bit for bit."""
    ckd, out = str(tmp_path / "ck"), str(tmp_path / "out")
    harness.main(["pod_ensemble", "--columns", "2", "--device", "cpu", "--ckpt", ckd,
                  "--outdir", out])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["n_steps_run"] == 120 and len(rep["save_s"]) == 12
    path = str(tmp_path / "ck" / "pod_ensemble")
    assert ck.latest_step(path) == 120
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "pod_ensemble_mean_profile.nc", "runs.jsonl"]
    y, _ = ck.load_checkpoint(path, 120, like=torch.zeros(6, 64))
    var, _ = read_nc(tmp_path / "out" / "pod_ensemble_mean_profile.nc")
    last = np.concatenate([var["moments"][-1, :, i, :] for i in range(2)], axis=-1)
    np.testing.assert_array_equal(last, harness.column_mean(y, 32).double().numpy())
