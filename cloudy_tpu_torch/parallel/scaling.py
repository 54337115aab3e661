"""Column-updates/s scaling measurement: 1 rank → N ranks.

Port of `cloudy_tpu.parallel.scaling`: the column-updates/s scaling
efficiency of a column-sharded rainshaft ensemble under weak scaling.
JAX sweeps subsets of the devices of one process; here each rank is a
process (`parallel.mesh`), a sweep point of d ranks runs on a process group
of ranks 0..d-1 while the others wait, and the rate is the point's global
columns × steps over the slowest of its ranks' seconds. Seconds come from
CUDA events on a CUDA device and from the host clock on the CPU. The
records are printed by the caller, never merged into a file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cloudy_tpu_torch.parallel import mesh as _mesh
from cloudy_tpu_torch.parallel.ensemble import ensemble_rainshaft_step
from cloudy_tpu_torch.utils import metrics


def measure_column_rate(
    rhs,
    dt: float,
    n_columns: int,
    nz: int,
    n_tot: int,
    group=None,
    n_steps: int = 20,
    dtype=torch.float32,
    seed: int = 0,
    device="cuda",
) -> float:
    """Global columns/s of chained SSP-RK33 steps of `rhs` over `n_columns`
    columns split evenly over the ranks of `group` (every rank of the
    process group by default; a single process without one), the median of
    three timed chains after a warm-up. Every rank of `group` calls it and
    gets the same rate: columns × `n_steps` over the slowest rank's
    seconds. The state is seeded per rank on `device`."""
    device = _mesh.rank_device(device)
    n_ranks = dist.get_world_size(group) if dist.is_initialized() else 1
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    if n_columns % n_ranks:
        raise ValueError(f"{n_columns} columns do not split over {n_ranks} ranks")
    step = ensemble_rainshaft_step(rhs, dt, None)
    rng = np.random.default_rng([seed, rank])
    state = torch.as_tensor(np.abs(rng.normal(1.0, 0.2, (n_columns // n_ranks, nz, n_tot))),
                            dtype=dtype, device=device)

    def chain():
        _, seconds, _ = metrics.timed_steps(step, state, n_steps)
        return _mesh.slowest(seconds, device, group)

    chain()  # warm-up
    seconds = float(np.median([chain() for _ in range(3)]))
    return n_columns * n_steps / seconds


def scaling_sweep(rhs, dt, nz, n_tot, columns_per_device: int = 8192,
                  device_counts: Optional[Sequence[int]] = None, device="cuda",
                  **kwargs) -> List[Dict]:
    """Weak-scaling sweep: fixed columns per rank, growing rank count (1,
    2, 4, 8 up to the world size by default). Every rank of the process
    group calls it. Returns ``[{'devices': d, 'columns_per_s': r,
    'efficiency': e}]`` with e the rate over d × the 1-rank rate."""
    world, rank = _mesh.world()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= world]
    out, base = [], None
    for d in device_counts:
        if d > world:
            raise ValueError(f"{d} ranks asked of a world of {world}")
        group = None
        if dist.is_initialized() and d < world:
            group = dist.new_group(list(range(d)))  # every rank joins its creation
        rate = None
        if rank < d:
            rate = measure_column_rate(rhs, dt, columns_per_device * d, nz, n_tot,
                                       group=group, device=device, **kwargs)
        if dist.is_initialized():
            box = [rate]
            dist.broadcast_object_list(box, src=0)
            rate = box[0]
        if base is None:
            base = rate / d
        out.append({"devices": d, "columns_per_s": rate, "efficiency": rate / (base * d)})
    return out
