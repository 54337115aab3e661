"""Whole-step family matrix: B1 through every family arm at pod width.

Port of tools/whole_step_ablation.py (:52-150). Nine configurations of the
whole SSPRK33 step kernel (`ops.fused_coalescence.make_rainshaft_step_fn`,
B1), each timed at 2^20 columns × 32 levels in f32 from the mode-1 pulse of
the pod ensemble:

- ``2gamma-exact`` (the pod ``fixed2gamma`` configuration) and
  ``exp-gamma-exact``: exact F2 with the GL incomplete gamma (the fast
  instance without arms);
- ``lognorm-gamma-window`` and its 8, 12 and 24-node points: the lognormal
  GL window rule (the fast instance with arms);
- ``moving-2gamma-exact``: MovingThreshold with the GL Halley inverse
  (``thr_newton_iters`` and ``thr_gammainc_iters`` are passed as the JAX
  tool passes them, and are not read at ``gammainc_gl_nodes > 0``);
- ``lognorm-gamma-grid``: the lognormal Φ grid on 12 Gauss nodes with the
  rational erf, and ``mono-gamma-closed``: the monodisperse closed form (the
  reference-tier instance, whose switches are read at run time).

Each case's data is built with ``gammainc_iters=12, f2_exact=<case>,
gammainc_gl_nodes=12`` (and the case's ``lognorm_gl_nodes``) as the JAX tool
builds it (:95-105). Its blocks hold whole columns (256 / nz of them), the
port's counterpart of ``block_cols``. Timing follows the JAX tool's protocol
(:133-150): a chain of n whole steps from the initial state, n1 = 2, a pilot
at n1 + 4, n2 = n1 + clip(round(0.5 s / pilot), 8, 2000), each chain the
median of `reps` runs after one warm-up run, seconds per step differenced
between n2 and n1. A CUDA device is timed with CUDA events, the build and
the warm-up outside the window.

One JSON record per case on stdout: the rates, ms per step, the kernel
instance, the launches of the case (one per step run), the least time the
card could take for one step (`tools.opcount`: each state row read and
written once against the twin's operations at the f32 peak) and the
measured step's share of it, and the card's name and power limit. The TPU
op-class model of the JAX tool (:151-214) is left out, and the tool writes
no ROOFLINE.json: at most the file named by ``--out``.

    python -m cloudy_tpu_torch.tools.whole_step_ablation
    python -m cloudy_tpu_torch.tools.whole_step_ablation --case mono-gamma-closed
    python -m cloudy_tpu_torch.tools.whole_step_ablation --device cpu --columns 64 --nz 8

``--device cpu`` runs the same protocol through the kernel's plain twin, for
small shapes only; its times are the host's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import opcount
from cloudy_tpu_torch.tools.calibration_bench import _seconds
from cloudy_tpu_torch.utils.metrics import card_name

NORMS = (1e6, 1e-9)
INF = float("inf")
G, E, L, M = Family.GAMMA, Family.EXPONENTIAL, Family.LOGNORMAL, Family.MONODISPERSE
#: (name, families, thresholds, moving, f2_exact, kernel keywords), as
#: tools/whole_step_ablation.py:52-86 lists them; ``lognorm_gl_nodes`` goes
#: to the data, the rest to the kernel
CASES = (
    ("2gamma-exact", (G, G), (5e-10, INF), False, True, {}),
    ("lognorm-gamma-grid", (L, G), (5e-10, INF), False, False,
     {"quad_rule": "gauss", "gauss_nodes": 12}),
    ("lognorm-gamma-window", (L, G), (5e-10, INF), False, True, {"lognorm_gl_nodes": 16}),
    ("lognorm-gamma-window12", (L, G), (5e-10, INF), False, True, {"lognorm_gl_nodes": 12}),
    ("lognorm-gamma-window8", (L, G), (5e-10, INF), False, True, {"lognorm_gl_nodes": 8}),
    ("lognorm-gamma-window24", (L, G), (5e-10, INF), False, True, {"lognorm_gl_nodes": 24}),
    ("moving-2gamma-exact", (G, G), (0.9, 1.0), True, True,
     {"thr_newton_iters": 8, "thr_gammainc_iters": 12}),
    ("exp-gamma-exact", (E, G), (5e-10, INF), False, True, {}),
    ("mono-gamma-closed", (M, G), (5e-10, INF), False, True, {}),
)
CASE_NAMES = tuple(c[0] for c in CASES)
INSTANCES = ("fast", "fast with arms", "reference tier")


def case_data(name: str):
    """(data, kernel keywords) of family-matrix case `name`: the Golovin 5.0
    kernel at order 1, built as tools/whole_step_ablation.py:95-105 builds
    it."""
    _, fams, thr, moving, f2x, kw = CASES[CASE_NAMES.index(name)]
    kw = dict(kw)
    data_kw = {"lognorm_gl_nodes": kw.pop("lognorm_gl_nodes")} if "lognorm_gl_nodes" in kw else {}
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(SpectrumSpec(fams), ker, thr, norms=NORMS, moving=moving,
                                  gammainc_iters=12, f2_exact=f2x, gammainc_gl_nodes=12,
                                  **data_kw)
    return data, kw


def build_case(name: str, nz: int = 32, device="cuda", dtype: torch.dtype = torch.float32):
    """(config, step) of family-matrix case `name`: the rainshaft
    configuration (32 levels over 3000 m, dt = 1 s) and its whole-step
    function."""
    data, kw = case_data(name)
    config = rs.RainshaftConfig(spec=data.spec, nz=nz, zmax=3000.0, norms=NORMS, dt=1.0)
    step = fc.make_rainshaft_step_fn(data, config.vel, config.norms, nz=nz, dz=config.dz,
                                     dt=1.0, device=device, dtype=dtype, **kw)
    return config, step


def initial_state(config, n_columns: int, device="cuda", dtype: torch.dtype = torch.float32):
    """The mode-1 pulse (:119-131): the first nprog moments of
    `initial_condition(z, [1e8, 1e-2, 2e-12])`, the higher modes empty,
    column c scaled by linspace(0.5, 1.5)[c]; SoA ``[n_tot, columns·nz]``."""
    spec = config.spec
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1[:, :spec.nprogmoms[0]],
                         np.zeros((ic1.shape[0], spec.n_tot - spec.nprogmoms[0]))], axis=-1)
    state = np.tile(ic[None], (n_columns, 1, 1)) * np.linspace(0.5, 1.5, n_columns)[:, None, None]
    return rs.to_soa(torch.as_tensor(state, dtype=dtype)).to(device)


def time_steps(step, state, device, reps: int = 5) -> dict:
    """Seconds per whole step by the JAX tool's protocol (:133-150); also
    the state after the last n2-step chain and the number of steps run."""
    out = {"steps_run": 0}

    def chain(n):
        y = state
        for _ in range(n):
            y = step(y)
        out["state"] = y
        out["steps_run"] += n

    def t(n):
        chain(n)  # warm-up
        return float(np.median([_seconds(lambda: chain(n), device) for _ in range(reps)]))

    n1 = 2
    dt_pilot = max((t(n1 + 4) - t(n1)) / 4, 1e-9)
    n2 = n1 + int(np.clip(round(0.5 / dt_pilot), 8, 2000))
    t1 = t(n1)
    sec = max((t(n2) - t1) / (n2 - n1), 1e-12)  # the n2 chain runs last
    return {"seconds_per_step": sec, "n1": n1, "n2": n2, **out}


def step_bound(step, state, n_lanes: int, nz: int) -> dict:
    """The least time the card could take for one step on `n_lanes` lanes:
    each state row read and written once against the twin's operations
    (counted on 8 columns of `state`, scaled) at the peak rate of the
    step's type."""
    small = state[:, :8 * nz].cpu().contiguous()
    ops = opcount.count_ops(step.plain, small) / small.shape[1]
    f64 = step.dtype == torch.float64
    n_bytes = 2 * step.plan.n_tot * n_lanes * (8 if f64 else 4)
    ms, by = opcount.bound_ms(n_bytes, ops * n_lanes, f64=f64)
    return {"bound_ms": ms, "bound_by": by, "ops_per_lane": ops}


def run_case(name: str, n_columns: int = 1 << 20, nz: int = 32, device="cuda",
             reps: int = 5, smi: str = None):
    """Time case `name`; returns ``(record, step, state0, timing)``, the
    timing with the state after the last n2-step chain."""
    device = torch.device(device)
    _, fams, _, moving, f2x, _ = CASES[CASE_NAMES.index(name)]
    config, step = build_case(name, nz, device)
    state = initial_state(config, n_columns, device)
    step(state[:, :nz].contiguous())  # builds and loads the kernels, outside the window
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step.launches = 0
    timing = time_steps(step, state, device, reps)
    sec = timing["seconds_per_step"]
    bnd = step_bound(step, state, n_columns * nz, nz)
    rec = {
        "name": name,
        "families": [f.name for f in fams],
        "moving": moving,
        "f2_exact": f2x,
        "n_columns": n_columns,
        "nz": nz,
        "column_updates_per_s": n_columns / sec,
        "level_updates_per_s": n_columns * nz / sec,
        "ms_per_step": sec * 1e3,
        "n1": timing["n1"],
        "n2": timing["n2"],
        "instance": INSTANCES[step.plan.instance],
        "route": step.route,
        "launches": step.launches,
        "steps_run": timing["steps_run"],
        **bnd,
        # a share of the card's least time only where the step ran on it
        "bound_share": bnd["bound_ms"] / (sec * 1e3) if device.type == "cuda" else None,
        "finite": bool(torch.isfinite(timing["state"]).all()),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": smi if smi is not None else card_name(device),
        "clock": "cuda_events" if device.type == "cuda" else "host",
    }
    return rec, step, state, timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--columns", type=int, default=1 << 20)
    ap.add_argument("--nz", type=int, default=32)
    ap.add_argument("--case", default=None, choices=CASE_NAMES, help="run only this case")
    ap.add_argument("--reps", type=int, default=5, help="timed runs of each chain (median)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    smi = card_name(device)
    records = []
    for name in CASE_NAMES if args.case is None else (args.case,):
        rec = run_case(name, args.columns, args.nz, device, args.reps, smi)[0]
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
