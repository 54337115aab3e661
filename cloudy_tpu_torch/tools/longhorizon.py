"""Long-horizon check of the production whole step: the f32 fast tier for
1000 steps against the f64 reference tier.

Port of tools/longhorizon.py and of the two long-horizon gates of
tests/test_golden.py (:194-317). The reference's flagship rainshaft examples
integrate to t = 1000 s (rainshaft_single_gamma.jl:30); the pod runs 120
steps. At the pod's depth (nz = 32, 128 columns) and the golden rainshaft's
(nz = 128, 32 columns), each one block of 4,096 lanes (z contiguous), the
columns start from `rainshaft_128`'s initial profile scaled by 0.7…1.3
across the block, and two whole-step wrappers (`make_rainshaft_step_fn`)
advance the same start:

- the f32 fast tier (exact F2 with the GL-12 incomplete gamma,
  ``gammainc_iters=12``): on the card the kernel generated for it;
- the f64 reference tier (the masked Simpson F2 grid, series/CF incomplete
  gamma): on the card the table-driven reference instance.

Both run over every column. At each of 10 checkpoints the record holds the
scaled trajectory error max |f32 − f64| / max |f64| (per moment over
columns and levels) and each type's total-mass drift since t = 0
(sedimentation drains the column, so the f32 drift is held against the
f64 drift, not against zero). The JAX gates' bounds: scaled error < 1e-3 at
t = 300, 600, 1000 (nz 32) and < 2e-3 at t = 500, 1000 (nz 128);
|drift32 − drift64| < 1e-4 at those times; every state finite.

One process does both types: no subprocess (the JAX tool spawns one for
x64, a workaround for the TPU's remote compiler). The run is timed by CUDA
events around each checkpoint's launches on the card, by the host clock on
the CPU, where the wrappers run their plain twins. Prints one JSON record
per depth and exits 1 if a record fails a gate; ``--outdir DIR`` also
appends the records to DIR/longhorizon.jsonl and writes nothing else.

    python -m cloudy_tpu_torch.tools.longhorizon
    python -m cloudy_tpu_torch.tools.longhorizon --device cpu --steps 10 --columns 2
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.utils import metrics

N_STEPS = 1000
CHECKPOINTS = 10
LANES = 4096  # one block of whole columns
DEPTHS = {"pod": 32, "rainshaft_128": 128}
#: scaled-error bound by checkpoint time, per depth (tests/test_golden.py:245-253, :309-317)
ERR_GATES = {32: {300: 1e-3, 600: 1e-3, 1000: 1e-3}, 128: {500: 2e-3, 1000: 2e-3}}
DRIFT_GATE = 1e-4  # |drift32 - drift64| at the gated times
NORMS = (1e6, 1e-9)


def config(nz: int, n_steps: int = N_STEPS) -> rs.RainshaftConfig:
    """The rainshaft of both runs: two gamma modes, 3000 m, dt = 1 s."""
    return rs.RainshaftConfig(spec=SpectrumSpec((Family.GAMMA, Family.GAMMA)), nz=nz,
                              zmax=3000.0, norms=NORMS, t_end=float(n_steps), dt=1.0)


def start_state(nz: int, columns: Optional[int] = None) -> np.ndarray:
    """``[E, nz, n_tot]`` f64, E = `columns` (default one 4,096-lane block):
    the initial profile (mode 1 seeded, mode 2 empty) scaled by
    linspace(0.7, 1.3, E) across the columns (tools/longhorizon.py `_build`)."""
    E = columns or LANES // nz
    ic1 = rs.initial_condition(config(nz).z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    return np.tile(ic[None], (E, 1, 1)) * np.linspace(0.7, 1.3, E)[:, None, None]


def make_steps(nz: int, device="cuda"):
    """(fast f32, reference f64) whole-step wrappers at depth `nz`."""
    cfg = config(nz)
    spec = cfg.spec
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    fast = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS, gammainc_iters=12,
                                  f2_exact=True, gammainc_gl_nodes=12)
    ref = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS)
    return tuple(
        fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=nz, dz=cfg.dz, dt=cfg.dt,
                                  device=device, dtype=dtype)
        for data, dtype in ((fast, torch.float32), (ref, torch.float64)))


def run_depth(name: str, nz: int, fast, ref, n_steps: int = N_STEPS,
              columns: Optional[int] = None):
    """Both runs at depth `nz` through the wrappers `fast` (f32) and `ref`
    (f64) from `start_state`; returns (record, states): ``states[tag]`` the
    ``[E, nz, n_tot]`` f64 host arrays at the checkpoints, tag "f32" or
    "f64"."""
    if n_steps % CHECKPOINTS:
        raise ValueError(f"steps={n_steps} is not a multiple of {CHECKPOINTS} checkpoints")
    seg = n_steps // CHECKPOINTS
    state = start_state(nz, columns)
    spec = config(nz).spec
    i_mass = [spec.dist_moment_ind(0, 1), spec.dist_moment_ind(1, 1)]
    mass0 = state[..., i_mass].sum()
    states: Dict[str, List[np.ndarray]] = {}
    seconds = {}
    for tag, fn in (("f32", fast), ("f64", ref)):
        y = rs.to_soa(torch.as_tensor(state)).to(fn.device, fn.dtype)
        fn.launches = 0
        states[tag], seconds[tag] = [], 0.0
        for _ in range(CHECKPOINTS):
            y, s, _ = metrics.timed_steps(fn, y, seg)
            seconds[tag] += s
            states[tag].append(rs.from_soa(y, nz).double().cpu().numpy())
    rows = []
    for ci, (a, b) in enumerate(zip(states["f32"], states["f64"])):
        scale = np.abs(b).max(axis=(0, 1))
        rows.append({
            "t": (ci + 1) * seg,
            "traj_err_max_scaled": float((np.abs(a - b) / scale).max()),
            "f32_mass_drift_vs_t0": float((a[..., i_mass].sum() - mass0) / mass0),
            "f64_mass_drift_vs_t0": float((b[..., i_mass].sum() - mass0) / mass0),
            "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
        })
    rec = {
        "scenario": f"longhorizon_{name}_f32_wholestep",
        "device": str(fast.device),
        "card": metrics.card_name(fast.device),
        "nz": nz,
        "n_columns": state.shape[0],
        "n_steps": n_steps,
        "clock": "cuda_events" if fast.device.type == "cuda" else "host",
        "ms_per_step_f32": seconds["f32"] / n_steps * 1e3,
        "ms_per_step_f64": seconds["f64"] / n_steps * 1e3,
        "launches_f32": fast.launches,
        "launches_f64": ref.launches,
        "route_f32": fast.route,
        "route_f64": ref.route,
        "finite": all(r["finite"] for r in rows),
        "checkpoints": rows,
    }
    rec["gate_failures"] = gate_failures(rec)
    return rec, states


def gate_failures(rec: Dict) -> List[str]:
    """The JAX gates' bounds at the record's checkpoints: each gated time's
    scaled error and drift difference, and every state finite."""
    out = [] if rec["finite"] else ["a state is not finite"]
    gates = ERR_GATES[rec["nz"]]
    for r in rec["checkpoints"]:
        if r["t"] not in gates:
            continue
        if not r["traj_err_max_scaled"] < gates[r["t"]]:
            out.append(f"t={r['t']}: scaled error {r['traj_err_max_scaled']:.3e} "
                       f">= {gates[r['t']]:.0e}")
        drift = abs(r["f32_mass_drift_vs_t0"] - r["f64_mass_drift_vs_t0"])
        if not drift < DRIFT_GATE:
            out.append(f"t={r['t']}: |drift32 - drift64| {drift:.3e} >= {DRIFT_GATE:.0e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--steps", type=int, default=N_STEPS,
                    help=f"steps of each run, a multiple of {CHECKPOINTS}")
    ap.add_argument("--columns", type=int, default=None,
                    help=f"columns of each run (default {LANES} lanes' worth)")
    ap.add_argument("--outdir", default=None,
                    help="append the records to DIR/longhorizon.jsonl")
    args = ap.parse_args(argv)
    failed = False
    for name, nz in DEPTHS.items():
        fast, ref = make_steps(nz, args.device)
        rec, _ = run_depth(name, nz, fast, ref, args.steps, args.columns)
        failed |= bool(rec["gate_failures"])
        print(json.dumps(rec), flush=True)
        if args.outdir:
            os.makedirs(args.outdir, exist_ok=True)
            with open(os.path.join(args.outdir, "longhorizon.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
