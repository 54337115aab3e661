"""Scenario harness: the pod column ensemble, the box scenarios and the
128-level rainshaft on one device.

Port of `cloudy_tpu.harness` for the production workload,
`_scenario_pod_ensemble` in its three variants (`POD_VARIANTS`): an
ensemble of 1-D rainshaft columns (Golovin kernel fitted at order 1, 32
levels over 3000 m, v = 50·x^{1/6}, SSPRK33 at dt = 1 s for 120 steps, the
fast tier: exact F2 with the GL-12 incomplete gamma) in the flat
structure-of-arrays layout ``[6, n_columns·32]``, advanced one whole step per
launch of the CUDA whole-step kernel (`ops.fused_coalescence`). On a CPU
device the same wrapper runs its plain twin.

- ``pod_ensemble``: two gamma modes, fixed threshold 5e-10 kg;
- ``pod_ensemble_moving``: two gamma modes, MovingThreshold at the 0.9
  percentile (per-column thresholds inverted in-kernel every RK stage);
- ``pod_ensemble_lognorm``: lognormal + gamma, fixed threshold 5e-10 kg,
  lognormal F2 by the GL-16 recentred window.

The state is built on the device. One warm-up step (on one column) builds
the kernels and loads the module before anything is timed; the timed run is
measured with CUDA events on a CUDA device (host clock on the CPU) and the
rate divides by the steps actually run.

    python -m cloudy_tpu_torch.harness pod_ensemble --columns 1048576 --device cuda
    python -m cloudy_tpu_torch.harness pod_ensemble_moving --columns 1048576 --device cuda
    python -m cloudy_tpu_torch.harness pod_ensemble_lognorm --columns 1048576 --device cuda

The three 0-D box scenarios (cloudy_tpu/harness.py:28-91) are single boxes
integrated in f64 through the torch reference path (`models.box`), each held
by tests against its stored trajectory under tests/golden/:

- ``box_single_gamma_golovin``: one gamma mode, Golovin kernel, 3 moments;
- ``box_exp_gamma_mixture``: exponential + gamma, constant + linear kernel
  tensor, threshold 5e-10 kg;
- ``box_long_numerical``: two gamma modes, the Long kernel by numerical
  quadrature (`coalescence_numerical.get_coal_ints_numerical`, the einsum
  path at (256, 96) nodes, as the JAX package runs it).

    python -m cloudy_tpu_torch.harness box_long_numerical --device cuda

``rainshaft_128`` (cloudy_tpu/harness.py:94-120) is one 1-D rainshaft
column of 128 levels over 3000 m, two gamma modes, Golovin 5.0 fitted at
order 1, fixed threshold 5e-10 kg, the default (reference, Simpson) tier,
SSPRK33 at dt = 1 s for 300 s, saved every 30 steps, in f64: the stored
golden tests/golden/rainshaft_128.npz. Its coalescence runs through torch
ops (`coalescence.get_coal_ints`) as in JAX, or with ``--hook`` through the
coalescence kernel's wrapper (`make_rainshaft_rhs(coal_fn=...)`, the plain
twin on the CPU):

    python -m cloudy_tpu_torch.harness rainshaft_128 --device cpu
    python -m cloudy_tpu_torch.harness rainshaft_128 --hook --device cuda

Each run prints one JSON report; ``--outdir DIR`` also appends it to DIR/runs.jsonl.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import box
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.utils import metrics

#: pod-scenario production variants (cloudy_tpu/harness.py:126-137):
#: (families, thresholds, moving, extra build_coalescence_data kwargs)
POD_VARIANTS = {
    "fixed2gamma": ((Family.GAMMA, Family.GAMMA), (5e-10, np.inf), False, {}),
    "moving": ((Family.GAMMA, Family.GAMMA), (0.9, 1.0), True, {}),
    "lognorm": ((Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf), False,
                {"lognorm_gl_nodes": 16}),
}


def pod_data(variant: str = "fixed2gamma"):
    """(spec, CoalescenceData) of one pod variant, fast tier, norms
    (1e6, 1e-9), Golovin 5.0 fitted at order 1."""
    fams, thresholds, moving, kw = POD_VARIANTS[variant]
    spec = SpectrumSpec(fams)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, thresholds, norms=(1e6, 1e-9),
                                  moving=moving, fast_tier=True, **kw)
    return spec, data


def _scenario_pod_ensemble(
    n_columns: int = 1 << 20,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    variant: str = "fixed2gamma",
) -> Dict:
    """The pod column ensemble in one of `POD_VARIANTS`: returns the
    configuration, the whole-step function (built and warmed up), the
    initial state (mode 1 seeded, mode 2 empty) and ``run``."""
    device = torch.device(device)
    spec, data = pod_data(variant)
    norms = (1e6, 1e-9)
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
        "data": data,
        "config": config,
        "step": step,
        "state0": state0,
        "n_columns": n_columns,
        "n_steps": n_steps,
        "run": run,
        "kind": "ensemble",
    }


def _box_scenario(spec, config, rhs, mom0, device, data=None) -> Dict:
    """A box scenario in its stated precision, f64; `data` the analytical
    coalescence data where the box has it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); ask for "
            "device='cpu' to run the box on the host"
        )
    state0 = torch.tensor(mom0, dtype=torch.float64, device=device)

    def run():
        """Integrate; returns (ys [n_steps + 1, n_tot], seconds, clock)."""
        t0 = time.perf_counter()
        _, ys = box.run_box(config, rhs, state0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ys, time.perf_counter() - t0, "host"

    return {"spec": spec, "config": config, "rhs": rhs, "state0": state0,
            "data": data, "run": run, "kind": "box",
            "n_steps": int(round(config.t_end / config.dt))}


def _scenario_box_single_gamma(device="cuda") -> Dict:
    """0-D box, single gamma, Golovin kernel, 3 moments."""
    spec = SpectrumSpec((Family.GAMMA,))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=norms)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=120.0, dt=1.0)
    rhs = box.make_box_rhs(config, coal_data=data)
    return _box_scenario(spec, config, rhs, [1e8, 1e-2, 2e-12], device, data)


def _scenario_box_exp_gamma_mixture(device="cuda") -> Dict:
    """0-D box, exponential+gamma mixture, 5 prognostic moments, constant +
    linear kernel (summed tensor), finite threshold."""
    spec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA))
    norms = (1e6, 1e-9)
    # constant rate chosen so 1/(B·M0) ≈ 50 s — stable at dt = 1 s
    const = K.CoalescenceTensor.from_function(K.ConstantKernelFunction(2e-10), 1, 1e-6)
    lin = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    combined = K.CoalescenceTensor(const.array + lin.array)
    data = build_coalescence_data(spec, combined, (5e-10, np.inf), norms=norms)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=120.0, dt=1.0)
    rhs = box.make_box_rhs(config, coal_data=data)
    return _box_scenario(spec, config, rhs, [1e8, 1e-2, 1.0, 1e-8, 2e-16], device, data)


def _scenario_box_long_numerical(device="cuda") -> Dict:
    """0-D box, Long kernel via numerical quadrature, two-mode closure with
    parameter inversion."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=60.0, dt=2.0)
    rhs = box.make_box_rhs(config, kernel_func=kf, numerical=True)
    return _box_scenario(spec, config, rhs, [1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13], device)


def _scenario_rainshaft_128(device="cuda", dtype: torch.dtype = torch.float64,
                            hook: bool = False, t_end: float = 300.0,
                            **coal_kwargs) -> Dict:
    """1-D rainshaft, 128 levels, coalescence + upwind sedimentation, the
    default tier, f64. ``hook=True`` routes the coalescence through the
    coalescence kernel's wrapper on `device` (`coal_kwargs`: its per-call
    overrides); `t_end` shortens the run (saves stay every 30 steps)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); ask for "
            "device='cpu' to run the rainshaft on the host"
        )
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(spec=spec, nz=128, zmax=3000.0, norms=norms,
                                t_end=t_end, dt=1.0, save_every=30)
    coal_fn = (fc.make_coal_fn(data, device=device, dtype=dtype, **coal_kwargs)
               if hook else None)
    rhs = rs.make_rainshaft_rhs(config, data, coal_fn=coal_fn)
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)

    def run():
        """Integrate; returns (ys [n_saves, nz, n_tot], seconds, clock)."""
        t0 = time.perf_counter()
        _, ys = rs.run_rainshaft(config, rhs, ic, dtype=dtype, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ys, time.perf_counter() - t0, "host"

    return {"spec": spec, "data": data, "config": config, "coal_fn": coal_fn,
            "ic": ic, "run": run, "kind": "rainshaft",
            "n_steps": int(round(config.t_end / config.dt))}


SCENARIOS: Dict[str, Callable] = {
    "box_single_gamma_golovin": _scenario_box_single_gamma,
    "box_exp_gamma_mixture": _scenario_box_exp_gamma_mixture,
    "box_long_numerical": _scenario_box_long_numerical,
    "rainshaft_128": _scenario_rainshaft_128,
    "pod_ensemble": _scenario_pod_ensemble,
    "pod_ensemble_moving": functools.partial(_scenario_pod_ensemble, variant="moving"),
    "pod_ensemble_lognorm": functools.partial(_scenario_pod_ensemble, variant="lognorm"),
}


def run_scenario(name: str, device="cuda", outdir: Optional[str] = None,
                 **scenario_args):
    """Build, run and report one named scenario in its stated precision (the
    pod ensembles f32, the boxes and the rainshaft f64). `scenario_args` go
    to the scenario's builder (`n_columns` for a pod ensemble; `hook`,
    `t_end` and the coalescence overrides for the rainshaft; a box takes
    none). Returns (state, report): the final ``[n_columns, nz, n_tot]``
    state of an ensemble, the saved trajectory of a box or of the rainshaft
    (``[n_saves, nz, n_tot]``). The report is appended to
    ``outdir/runs.jsonl`` only with `outdir`."""
    sc = SCENARIOS[name](device=device, **scenario_args)
    ensemble = sc["kind"] == "ensemble"
    hooked = sc.get("coal_fn") is not None
    if ensemble:
        sc["step"].launches = 0
    if hooked:
        sc["coal_fn"].launches = 0
    y, seconds, clock = sc["run"]()
    report = {
        "scenario": name,
        "device": (torch.cuda.get_device_name(y.device)
                   if y.device.type == "cuda" else y.device.type),
        "dtype": str(y.dtype).replace("torch.", ""),
        "n_steps": sc["n_steps"],
        "seconds": seconds,
        "clock": clock,
        "finite": bool(torch.all(torch.isfinite(y))),
    }
    if ensemble:
        nz = sc["config"].nz
        state = final = rs.from_soa(y, nz)  # [n_columns, nz, n_tot] view
        report.update({
            "n_columns": sc["n_columns"],
            "nz": nz,
            "launches": sc["step"].launches,
            "column_updates_per_s": sc["n_columns"] * sc["n_steps"] / seconds,
        })
    else:
        state, final = y, y[-1]
    if sc["kind"] == "rainshaft":
        report.update({"nz": sc["config"].nz, "save_every": sc["config"].save_every,
                       "coalescence": "kernel hook" if hooked else "torch ops"})
        if hooked:
            report["launches"] = sc["coal_fn"].launches
    report.update(metrics.conservation_report(sc["spec"], final))
    _log_report(report, outdir)
    return state, report


def _log_report(report: Dict, outdir: Optional[str]) -> None:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "runs.jsonl"), "a") as f:
            f.write(json.dumps(report) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--columns", type=int, default=None,
                    help="width of a pod ensemble (default 2^20); a box takes none")
    ap.add_argument("--hook", action="store_true",
                    help="rainshaft_128: coalescence through the kernel's wrapper")
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args(argv)
    scenario_args = {} if args.columns is None else {"n_columns": args.columns}
    if args.hook:
        scenario_args["hook"] = True
    _, report = run_scenario(
        args.scenario, device=args.device, outdir=args.outdir, **scenario_args
    )
    print(json.dumps(report))


if __name__ == "__main__":
    main()
