"""The two slowest example scripts of the port on the CPU, in FAST mode
(tests/test_torch_examples.py runs the other 21 the same way):

- `calibration_example` (f64, the EKI, EKS, UKI, gradient and sparse-EKI
  drivers of `calibrate` through batched torch-ops forwards): each driver
  meets the recovery the JAX script's printout reports in FAST mode
  (`JAX_PLATFORMS=cpu CLOUDY_EXAMPLE_FAST=1 python calibration_example.py`:
  EKI s = 1.6995, EKS 1.6994, UKI 1.6869, gradient 1.6429 for s = 1.7;
  sparse EKI exact zeros on c00 and c11 and the active total at 0.01):
  EKI and EKS within 2 % of 1.7, UKI and the gradient fit to 1e-3 of JAX's
  (both deterministic: no draw reaches them but the observation noise),
  the sparse EKI's exact zeros and its active total within 2 %;
- `box_gamma_mix_moving` (four gamma modes, MovingThreshold percentiles,
  ~20 s).
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _run(name, tmp_path, monkeypatch):
    monkeypatch.setenv("CLOUDY_EXAMPLE_FAST", "1")
    mod = importlib.import_module(f"cloudy_tpu_torch.examples.{name}")
    return mod.main(["--device", "cpu", "--outdir", str(tmp_path)])


def test_calibration_example_recovers_the_scale(tmp_path, monkeypatch, capsys):
    res = _run("calibration_example", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "done" in out and "sparse EKI kernel tensor" in out
    assert abs(res["s_eki"] - 1.7) / 1.7 < 0.02, res
    assert abs(res["s_eks"] - 1.7) / 1.7 < 0.02, res
    assert res["s_uki"] == pytest.approx(1.6869, abs=1e-3)
    assert res["s_grad"] == pytest.approx(1.6429, abs=1e-3)
    m = res["sparse"]
    assert m[0, 0] == 0.0 and m[1, 1] == 0.0, m
    assert m[0, 1] + m[1, 0] == pytest.approx(2.0 * res["b_n"], rel=0.02)


def test_moving_box_example_runs(tmp_path, monkeypatch, capsys):
    ts, ys = _run("box_gamma_mix_moving", tmp_path, monkeypatch)
    assert "final moments" in capsys.readouterr().out
    assert (tmp_path / "box_gamma_mix_moving.nc").exists()
    assert ys.shape == (5, 12) and bool(torch.isfinite(ys).all())
    # coalescence keeps the total mass
    m1 = ys[:, 1::3].sum(dim=1)
    np.testing.assert_allclose(m1.numpy(), float(m1[0]), rtol=1e-6)
