"""Every example script of the port on the CPU, in FAST mode.

tests/test_examples.py runs each of the JAX package's 23 scripts under
examples/ with CLOUDY_EXAMPLE_FAST=1; here each of the port's counterparts
(`cloudy_tpu_torch.examples.<name>`) runs in this process, through its
``main(["--device", "cpu", "--outdir", <tmp>])`` (a subprocess each would
spend most of its time importing torch), and prints the lines
tests/test_examples.py:80-88 looks for; the box, rainshaft and
condensation scripts write their NetCDF file under the given directory, and
nothing is written into the JAX package's examples/output/. One box
example's NetCDF has `cloudy_tpu.utils.io.box_output`'s variables and
dimensions. Without a card, the default ``--device cuda`` raises.
The final moments of the deterministic examples against the JAX library:
tests/test_torch_examples_jax.py; the calibration example's recovery and
the four-mode moving box: tests/test_torch_examples_heavy.py.
"""

import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudy_tpu_torch.examples import EXAMPLES, common

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_EXAMPLES = ROOT / "examples"
#: what writes no NetCDF (tests/test_examples.py:32-36)
NO_NETCDF = {"parcel_example", "test_kernel_tensor_approximation", "calibration_example"}
#: run in tests/test_torch_examples_heavy.py (the calibration's recovery is
#: checked there; the four-mode moving box takes ~20 s of this file's 60)
ELSEWHERE = {"calibration_example", "box_gamma_mix_moving"}


def _snapshot(folder: Path):
    return {p.name: p.stat().st_mtime_ns for p in folder.iterdir()} if folder.is_dir() else {}


def run_example(name, outdir, monkeypatch, device="cpu"):
    """`name`'s main in FAST mode on `device`; returns what it returns."""
    monkeypatch.setenv("CLOUDY_EXAMPLE_FAST", "1")
    mod = importlib.import_module(f"cloudy_tpu_torch.examples.{name}")
    return mod.main(["--device", device, "--outdir", str(outdir)])


def test_every_jax_example_has_a_port():
    jax_names = sorted(p.stem for p in JAX_EXAMPLES.glob("*.py") if p.name != "common.py")
    assert len(jax_names) == 23
    assert sorted(EXAMPLES) == jax_names
    port = Path(common.__file__).parent
    assert sorted(p.stem for p in port.glob("*.py")
                  if p.stem not in ("common", "__init__")) == jax_names


@pytest.mark.parametrize("name", sorted(set(EXAMPLES) - ELSEWHERE))
def test_example_runs(name, tmp_path, monkeypatch, capsys):
    before = _snapshot(JAX_EXAMPLES / "output")
    result = run_example(name, tmp_path, monkeypatch)
    out = capsys.readouterr().out
    if name in NO_NETCDF:
        assert ("done" in out) or ("max rel error" in out)
    else:
        assert (tmp_path / f"{name}.nc").exists(), out
        assert ("final moments" in out) or ("total mass" in out)
        ys = result[-1]
        assert ys.dtype == torch.float64 and ys.device.type == "cpu"
        assert bool(torch.isfinite(ys).all())
    assert list(tmp_path.glob("*.png")), out
    assert _snapshot(JAX_EXAMPLES / "output") == before


def test_box_netcdf_has_the_jax_writers_layout(tmp_path, monkeypatch):
    """The port's box_single_gamma.nc against `cloudy_tpu.utils.io.box_output`
    on the same trajectory: the same variables, dimensions and values."""
    from scipy.io import netcdf_file

    from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec
    from cloudy_tpu.utils import io as jio

    ts, ys = run_example("box_single_gamma", tmp_path, monkeypatch)
    jio.box_output(str(tmp_path / "jax.nc"), JSpec((JFamily.GAMMA,)), ts.numpy(), ys.numpy(),
                   common.NORMS)
    with netcdf_file(tmp_path / "box_single_gamma.nc", "r", mmap=False) as a, \
            netcdf_file(tmp_path / "jax.nc", "r", mmap=False) as b:
        assert dict(a.dimensions) == dict(b.dimensions)
        assert sorted(a.variables) == sorted(b.variables)
        for k in b.variables:
            assert a.variables[k].dimensions == b.variables[k].dimensions, k
            np.testing.assert_allclose(a.variables[k][:], b.variables[k][:], rtol=1e-12,
                                       err_msg=k)


def test_example_without_matplotlib_skips_its_figures(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed, an example says it skips its
    figures and writes its NetCDF file and printout all the same."""
    from cloudy_tpu_torch.utils import plotting

    assert plotting.available()
    monkeypatch.setattr(plotting, "available", lambda: False)
    ts, ys = run_example("box_single_gamma", tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert "[box_single_gamma] figures skipped: matplotlib is not installed" in out
    assert "final moments" in out and (tmp_path / "box_single_gamma.nc").exists()
    assert not list(tmp_path.glob("*.png"))


def test_examples_need_a_card_unless_told(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("CLOUDY_EXAMPLE_FAST", "1")
    mod = importlib.import_module("cloudy_tpu_torch.examples.box_single_gamma")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--outdir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    assert common.OUTDIR == Path(common.__file__).parent / "output"
    assert os.path.relpath(common.OUTDIR, ROOT) == "cloudy_tpu_torch/examples/output"
