"""What the port's example scripts share: arguments, then build → integrate
→ plot → NetCDF.

Port of examples/common.py (the role of the reference's test/examples/utils
helpers). Each script of this package defines a scenario and calls
`run_box_example`, `run_condensation_example` or `run_rainshaft_example`;
every one runs as

    python -m cloudy_tpu_torch.examples.<name> [--device cuda|cpu] [--outdir DIR]

on the card unless ``--device cpu`` is given (no card and no ``--device
cpu``: it raises, it does not fall back), in f64, writing its figures
(where matplotlib is installed: `figures`) and NetCDF files under
`--outdir` (default ``cloudy_tpu_torch/examples/output/``, never the JAX
package's examples/output/). ``CLOUDY_EXAMPLE_FAST=1`` shortens
the horizon and the column height as examples/common.py:48-52 does (at most
four steps, at most 16 levels), keeping each configuration's physics.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K  # noqa: F401 (re-export to the scripts)
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import box, rainshaft as rs
from cloudy_tpu_torch.spec import Family, SpectrumSpec  # noqa: F401 (re-export)
from cloudy_tpu_torch.utils import io, plotting

OUTDIR = Path(__file__).resolve().parent / "output"
NORMS = (1e6, 1e-9)
DTYPE = torch.float64


def fast() -> bool:
    """Whether CLOUDY_EXAMPLE_FAST asks for the short tier (read at each
    call, so that a caller may set it around an in-process run)."""
    return bool(int(os.environ.get("CLOUDY_EXAMPLE_FAST", "0")))


def parse_args(argv, description: Optional[str] = None) -> Dict:
    """``{"device", "outdir"}`` from the command line; the device is checked
    here: ``cuda`` without a card raises."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--outdir", default=str(OUTDIR),
                   help=f"where figures and NetCDF files go (default {OUTDIR})")
    a = p.parse_args(argv)
    return {"device": check_device(a.device), "outdir": a.outdir}


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); ask for "
            "--device cpu to run the example on the host")
    return device


def _fast_time(t_end, dt, n_steps_fast=4):
    return (min(t_end, n_steps_fast * dt), dt) if fast() else (t_end, dt)


def ensure_outdir(outdir) -> str:
    os.makedirs(outdir, exist_ok=True)
    return str(outdir)


def figures(name) -> bool:
    """Whether the example draws its figures: matplotlib installed, else it
    says that it skips them (its NetCDF file and printout are written all
    the same)."""
    if plotting.available():
        return True
    print(f"[{name}] figures skipped: matplotlib is not installed")
    return False


def run_box_example(
    name,
    spec,
    moments_init,
    kernel=None,
    kernel_func=None,
    thresholds=None,
    moving=False,
    t_end=120.0,
    dt=10.0,
    numerical=False,
    norms=NORMS,
    logxrange=(-12, -3),
    *,
    device="cuda",
    outdir=OUTDIR,
):
    """Analytical (kernel tensor) or numerical (kernel function) box run
    with the standard outputs (reference box_* examples); returns (ts, ys)
    with ys on `device`."""
    out = ensure_outdir(outdir)
    if thresholds is None:
        thresholds = (np.inf,) * spec.n_modes
    t_end, dt = _fast_time(t_end, dt)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=t_end, dt=dt)
    if numerical:
        rhs = box.make_box_rhs(config, kernel_func=kernel_func, numerical=True)
    else:
        data = build_coalescence_data(spec, kernel, thresholds, norms=norms, moving=moving)
        rhs = box.make_box_rhs(config, coal_data=data)
    y0 = torch.tensor(np.asarray(moments_init, np.float64), dtype=DTYPE, device=device)
    ts, ys = box.run_box(config, rhs, y0)

    if figures(name):
        plotting.plot_moments(spec, ts, ys, f"{out}/{name}_moments.png", norms)
        plotting.plot_params(spec, ts, ys, f"{out}/{name}_params.png", norms)
        plotting.plot_spectra(spec, ts, ys, f"{out}/{name}_spectra.png", norms, logxrange)
    io.box_output(f"{out}/{name}.nc", spec, ts, ys, norms)
    print(f"[{name}] final moments: {ys[-1].cpu().numpy()}")
    return ts, ys


def run_condensation_example(name, spec, moments_init, s=0.01, xi=1e-10,
                             t_end=10.0, dt=0.25, norms=NORMS, *, device="cuda",
                             outdir=OUTDIR):
    """Condensation-only box (reference condensation_* examples)."""
    out = ensure_outdir(outdir)
    t_end, dt = _fast_time(t_end, dt)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=t_end, dt=dt)
    rhs = box.make_box_condensation_rhs(config, s=s, xi=xi)
    y0 = torch.tensor(np.asarray(moments_init, np.float64), dtype=DTYPE, device=device)
    ts, ys = box.run_box(config, rhs, y0)
    if figures(name):
        plotting.plot_moments(spec, ts, ys, f"{out}/{name}_moments.png", norms)
    io.box_output(f"{out}/{name}.nc", spec, ts, ys, norms)
    print(f"[{name}] final moments: {ys[-1].cpu().numpy()}")
    return ts, ys


def run_rainshaft_example(
    name,
    spec,
    mom_amp,
    kernel=None,
    thresholds=None,
    nz=60,
    zmax=3000.0,
    # the reference rainshaft examples integrate to t = 1000 s
    # (rainshaft_single_gamma.jl:30, rainshaft_gamma_mixture.jl:32)
    t_end=1000.0,
    dt=1.0,
    norms=NORMS,
    *,
    device="cuda",
    outdir=OUTDIR,
):
    """1-D rainshaft run (reference rainshaft_* examples); returns (ts, z,
    ys) with ys on `device`."""
    out = ensure_outdir(outdir)
    if thresholds is None:
        thresholds = (np.inf,) * spec.n_modes
    t_end, dt = _fast_time(t_end, dt)
    if fast():
        nz = min(nz, 16)
    config = rs.RainshaftConfig(
        spec=spec, nz=nz, zmax=zmax, norms=norms, t_end=t_end, dt=dt,
        save_every=max(1, int(t_end / dt) // 20),
    )
    data = (build_coalescence_data(spec, kernel, thresholds, norms=norms)
            if kernel is not None else None)
    rhs = rs.make_rainshaft_rhs(config, data)
    ic = rs.initial_condition(config.z, mom_amp[: spec.nprogmoms[0]])
    if spec.n_modes > 1:
        pad = np.zeros((config.nz, spec.n_tot - ic.shape[1]))
        ic = np.concatenate([ic, pad], axis=-1)
    ts, ys = rs.run_rainshaft(config, rhs, ic, dtype=DTYPE, device=device)
    if figures(name):
        plotting.plot_rainshaft_results(spec, ts, config.z, ys, f"{out}/{name}.png", norms)
    io.rainshaft_output(f"{out}/{name}.nc", spec, ts, config.z, ys, norms)
    print(f"[{name}] total mass t0={float(ys[0][..., 1].sum()):.3e} "
          f"tend={float(ys[-1][..., 1].sum()):.3e}")
    return ts, config.z, ys
