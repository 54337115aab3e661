"""Column-updates/s of the sharded rainshaft ensemble step.

Port of tools/scaling_measure.py's measurement (:40-100): the pod workload
(32 levels, two gamma modes, Golovin 5.0, exact F2 with the GL-12
incomplete gamma, one SSPRK33 step) through `parallel.ensemble`:

- the fused-RHS route (default): the fused per-level RHS kernel (B4,
  `ops.fused_coalescence.make_rainshaft_rhs_fn`) + the torch upwind
  stencil on the flat SoA layout ``[6, n_local·32]``, stepped by
  `ensemble_rainshaft_step_soa`;
- ``--aos``: the torch-ops RHS (`models.rainshaft.make_rainshaft_rhs`) on
  the AoS layout ``[n_local, 32, 6]``, stepped by `ensemble_rainshaft_step`.

Under a process group (torchrun, or any launcher `parallel.mesh`
recognises) each of W ranks steps ``columns / W`` columns on its own device
and the rate counts every rank's columns over the slowest rank's seconds;
without one, W = 1. Each point: one warm-up step, then `--reps` chains of
`--steps` steps, each timed by CUDA events on the card (the host clock on
the CPU, where B4's wrapper runs its plain twin and launches nothing), the
median kept. Prints one JSON record per column count (rank 0), the card's
name and power limit in it; writes no file (the JAX tool merges into
SCALING.json, which the JAX package owns).

    python -m cloudy_tpu_torch.tools.scaling_measure --device cuda
    torchrun --nproc_per_node=1 -m cloudy_tpu_torch.tools.scaling_measure --device cuda
    python -m cloudy_tpu_torch.tools.scaling_measure --device cpu --columns 64 --steps 2 --reps 1
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.parallel import ensemble, mesh as pmesh
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.utils import metrics

COLUMNS = (1 << 17, 1 << 19, 1 << 20)  # the JAX tool's single-chip batch sizes


def build_step(fused: bool = True, mesh=None, device="cuda", dtype=torch.float32):
    """(spec, config, step, fused_fn): one sharded SSPRK33 step of this
    rank's shard; `fused_fn` B4's wrapper on the fused-RHS route, None on
    the AoS route (the JAX tool's `build_step`). The coalescence data is
    the fast tier (exact F2, GL-12, 12 iterations: the JAX tool's
    switches), the pod `fixed2gamma`'s plan, so B4 is the pod's unit."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms, fast_tier=True)
    config = rs.RainshaftConfig(spec=spec, nz=32, zmax=3000.0, norms=norms, dt=1.0)
    if fused:
        fn = fc.make_rainshaft_rhs_fn(data, config.vel, config.norms, device=device,
                                      dtype=dtype)
        rhs = rs.make_rainshaft_rhs_fused(config, fn)
        return spec, config, ensemble.ensemble_rainshaft_step_soa(
            rhs, config.dt, mesh, nz=config.nz), fn
    rhs = rs.make_rainshaft_rhs(config, data)
    return spec, config, ensemble.ensemble_rainshaft_step(rhs, config.dt, mesh), None


def make_state(config, n_columns: int, fused: bool = True, device="cuda",
               dtype=torch.float32):
    """The pod's start (mode 1's top hat, mode 2 empty) over `n_columns`
    columns: SoA for the fused route, AoS otherwise."""
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    if fused:
        col = torch.as_tensor(ic.T.copy(), dtype=dtype, device=device)
        return col.repeat(1, n_columns)
    return torch.as_tensor(ic, dtype=dtype, device=device).repeat(n_columns, 1, 1)


def measure(n_columns: int, fused: bool = True, device="cuda", n_steps: int = 10,
            reps: int = 3, dtype=torch.float32) -> Dict:
    """One record: `n_columns` global columns split over the process
    group's ranks (every rank calls this), stepped `reps` times `n_steps`
    steps."""
    world, _ = pmesh.world()
    mesh = pmesh.make_mesh(("columns",)) if dist.is_initialized() else None
    device = pmesh.rank_device(device) if mesh is not None else torch.device(device)
    if n_columns % world:
        raise ValueError(f"{n_columns} columns do not split over {world} ranks")
    n_local = n_columns // world
    _, config, step, fn = build_step(fused, mesh, device, dtype)
    state = make_state(config, n_local, fused, device, dtype)
    step(state)  # warm-up: builds the kernel, loads the module
    if fn is not None:
        fn.launches = 0
    times = []
    for _ in range(reps):
        _, seconds, clock = metrics.timed_steps(step, state, n_steps)
        times.append(seconds)
    seconds = float(np.median(times))
    launches = None if fn is None else fn.launches
    if mesh is not None:
        seconds = pmesh.slowest(seconds, device, pmesh.axis_group(mesh, "columns")[0])
    rate = n_columns * n_steps / seconds
    return {
        "kind": "column_rate",
        "route": "fused_rhs" if fused else "aos_torch_ops",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": metrics.card_name(device),
        "dtype": str(dtype).replace("torch.", ""),
        "world_size": world,
        "n_columns": n_columns,
        "n_local_columns": n_local,
        "nz": config.nz,
        "n_steps": n_steps,
        "reps": reps,
        "ms_per_step": seconds / n_steps * 1e3,
        "column_updates_per_s": rate,
        "level_updates_per_s": rate * config.nz,
        "launches": launches,
        "clock": clock,
    }


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    ap.add_argument("--columns", type=int, nargs="+", default=list(COLUMNS),
                    help="global column counts, one record each")
    ap.add_argument("--aos", action="store_true", help="the torch-ops AoS route")
    ap.add_argument("--steps", type=int, default=10, help="steps per timed chain")
    ap.add_argument("--reps", type=int, default=3, help="timed chains per point (median)")
    args = ap.parse_args(argv)
    grouped = pmesh.initialize_distributed(device=args.device) or dist.is_initialized()
    try:
        t0 = time.perf_counter()
        for n in args.columns:
            rec = measure(n, fused=not args.aos, device=args.device, n_steps=args.steps,
                          reps=args.reps)
            if pmesh.world()[1] == 0:
                print(json.dumps({**rec, "host_s": time.perf_counter() - t0}), flush=True)
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
