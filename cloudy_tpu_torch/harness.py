"""Scenario harness: the pod column ensemble on one device.

Port of `cloudy_tpu.harness` for the production workload,
`_scenario_pod_ensemble` with variant ``fixed2gamma``: an ensemble of 1-D
rainshaft columns (two gamma modes, Golovin kernel fitted at order 1, fixed
threshold 5e-10 kg, 32 levels over 3000 m, v = 50·x^{1/6}, SSPRK33 at
dt = 1 s for 120 steps, exact F2 with the GL-12 incomplete gamma) in the flat
structure-of-arrays layout ``[6, n_columns·32]``, advanced one whole step per
launch of the CUDA whole-step kernel (`ops.fused_coalescence`). On a CPU
device the same wrapper runs its plain twin.

The state is built on the device. One warm-up step (on one column) builds
the kernels and loads the module before anything is timed; the timed run is
measured with CUDA events on a CUDA device (host clock on the CPU) and the
rate divides by the steps actually run.

    python -m cloudy_tpu_torch.harness pod_ensemble --columns 1048576 --device cuda

prints one JSON report; ``--outdir DIR`` also appends it to DIR/runs.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.utils import metrics

#: pod-scenario production variants: (families, fixed thresholds). The
#: moving and lognormal variants are ROADMAP A.7.
POD_VARIANTS = {
    "fixed2gamma": ((Family.GAMMA, Family.GAMMA), (5e-10, np.inf)),
}


def _scenario_pod_ensemble(
    n_columns: int = 1 << 20,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict:
    """The pod column ensemble (``fixed2gamma``): returns the configuration,
    the whole-step function (built and warmed up), the initial state and
    ``run``."""
    fams, thresholds = POD_VARIANTS["fixed2gamma"]
    device = torch.device(device)
    spec = SpectrumSpec(fams)
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, thresholds, norms=norms, fast_tier=True)
    nz = 32
    config = rs.RainshaftConfig(
        spec=spec, nz=nz, zmax=3000.0, norms=norms, t_end=120.0, dt=1.0
    )
    step = fc.make_rainshaft_step_fn(
        data, config.vel, config.norms, nz=nz, dz=config.dz, dt=config.dt,
        device=device, dtype=dtype,
    )
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)  # [nz, n_tot]
    column = torch.as_tensor(ic.T.copy(), dtype=dtype, device=device)
    state0 = column.repeat(1, n_columns)  # [n_tot, n_columns·nz], z fastest
    n_steps = int(round(config.t_end / config.dt))

    # warm-up outside any timed window: builds the kernels, loads the module
    step(column.contiguous())
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def run(n: int = n_steps):
        """Advance `state0` by `n` whole steps; returns (state, seconds,
        clock). Seconds come from CUDA events on a CUDA device."""
        y = state0
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                y = step(y)
            end.record()
            end.synchronize()
            return y, start.elapsed_time(end) / 1e3, "cuda_events"
        t0 = time.perf_counter()
        for _ in range(n):
            y = step(y)
        return y, time.perf_counter() - t0, "host"

    return {
        "spec": spec,
        "config": config,
        "step": step,
        "state0": state0,
        "n_columns": n_columns,
        "n_steps": n_steps,
        "run": run,
    }


SCENARIOS: Dict[str, Callable] = {
    "pod_ensemble": _scenario_pod_ensemble,
}


def run_scenario(
    name: str,
    n_columns: int = 1 << 20,
    device="cuda",
    outdir: Optional[str] = None,
):
    """Build, run and report one named scenario in its stated precision (f32).
    Returns (state, report); the report is appended to ``outdir/runs.jsonl``
    only with `outdir`."""
    sc = SCENARIOS[name](n_columns=n_columns, device=device)
    sc["step"].launches = 0
    y, seconds, clock = sc["run"]()
    nz = sc["config"].nz
    state = rs.from_soa(y, nz)  # [n_columns, nz, n_tot] view
    report = {
        "scenario": name,
        "device": (torch.cuda.get_device_name(y.device)
                   if y.device.type == "cuda" else y.device.type),
        "dtype": str(y.dtype).replace("torch.", ""),
        "n_columns": sc["n_columns"],
        "nz": nz,
        "n_steps": sc["n_steps"],
        "launches": sc["step"].launches,
        "seconds": seconds,
        "clock": clock,
        "finite": bool(torch.all(torch.isfinite(y))),
    }
    report.update(metrics.conservation_report(sc["spec"], state))
    report["column_updates_per_s"] = sc["n_columns"] * sc["n_steps"] / seconds
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "runs.jsonl"), "a") as f:
            f.write(json.dumps(report) + "\n")
    return state, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--columns", type=int, default=1 << 20)
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args(argv)
    _, report = run_scenario(
        args.scenario, n_columns=args.columns, device=args.device,
        outdir=args.outdir,
    )
    print(json.dumps(report))


if __name__ == "__main__":
    main()
