"""The whole SSPRK33 step (B1) at the pod's full scale: 2^20 columns × 32
levels on one card.

Port of tools/whole_step_1m.py: pod `fixed2gamma` (two gamma modes, the
Golovin tensor 5.0 fitted at order 1, threshold 5e-10 kg, norms (1e6,
1e-9), exact F2 with the GL-12 incomplete gamma at 12 iterations, v =
50·x^{1/6}, dt = 1 s, f32) through `fused_coalescence.make_rainshaft_step_fn`,
on the card the unit generated for that configuration. The start is
`rainshaft.initial_condition`'s profile in the first mode, scaled 0.5…1.5
across the columns, as the JAX tool builds it. Timing follows the JAX
tool's differenced chains: t(n) is the median over `--reps` chains of n
steps from the start (CUDA events on the card, the host clock on the CPU,
where the wrapper runs its plain twin), a pilot of 4 steps past n1 = 2 sizes
n2 to ~0.5 s, and one step costs (t(n2) − t(n1)) / (n2 − n1). Prints one
JSON record with the card's name and power limit; writes no file (the JAX
tool merges into SCALING.json, which the JAX package owns).

    python -m cloudy_tpu_torch.tools.whole_step_1m
    python -m cloudy_tpu_torch.tools.whole_step_1m --device cpu --columns 64 --reps 1
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.utils import metrics

COLUMNS = 1 << 20
NZ = 32


def make_step(device="cuda"):
    """(config, step): the f32 whole-step wrapper of pod `fixed2gamma` on
    `device` (the JAX tool's `CoalescenceData` switches)."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms, gammainc_iters=12,
                                  f2_exact=True, gammainc_gl_nodes=12)
    config = rs.RainshaftConfig(spec=spec, nz=NZ, zmax=3000.0, norms=norms, dt=1.0)
    step = fc.make_rainshaft_step_fn(data, config.vel, config.norms, nz=NZ, dz=config.dz,
                                     dt=1.0, device=device, dtype=torch.float32)
    return config, step


def start_state(config, n_columns: int = COLUMNS, device="cuda") -> torch.Tensor:
    """The start ``[6, n_columns·nz]``: the initial profile in the first
    mode, scaled 0.5…1.5 across the columns."""
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    cols = np.tile(ic[None], (n_columns, 1, 1)) * np.linspace(0.5, 1.5, n_columns)[:, None, None]
    return rs.to_soa(torch.as_tensor(cols, dtype=torch.float32, device=device))


def measure(n_columns: int = COLUMNS, device="cuda", reps: int = 5) -> Dict:
    """The record of one run (see the module's docstring)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); ask for "
                           "--device cpu to run the whole step's twin on the host")
    config, step = make_step(device)
    state = start_state(config, n_columns, device)
    step(state)  # builds and loads the unit, outside the timing

    def t(n):
        return float(np.median([metrics.timed_steps(step, state, n)[1] for _ in range(reps)]))

    n1 = 2
    step.launches = 0
    pilot = max((t(n1 + 4) - t(n1)) / 4, 1e-9)
    n2 = n1 + int(np.clip(round(0.5 / pilot), 8, 2000))
    sec = max((t(n2) - t(n1)) / (n2 - n1), 1e-12)
    return {
        "tool": "cloudy_tpu_torch.tools.whole_step_1m",
        "card": metrics.card_name(device),
        "clock": "cuda_events" if device.type == "cuda" else "host",
        "route": step.route,
        "workload": "whole SSPRK33 step (B1: 3 coalescence RHS + sedimentation flux + "
                    "upwind stencil + RK stages in one kernel; exact F2 with GL-12), "
                    f"pod fixed2gamma, nz={NZ}, f32, flat SoA",
        "n_columns": n_columns,
        "nz": NZ,
        "n1": n1,
        "n2": n2,
        "reps": reps,
        "ms_per_step": sec * 1e3,
        "column_updates_per_s": n_columns / sec,
        "level_updates_per_s": n_columns * NZ / sec,
        "launches": step.launches,
    }


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--columns", type=int, default=COLUMNS)
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args(argv)
    rec = measure(a.columns, a.device, a.reps)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
