"""Column-ensemble data parallelism over `torch.distributed`.

Port of `cloudy_tpu.parallel.ensemble`. The pod workload is 10^6+
independent rainshaft columns; columns do not couple, so the ensemble is
split into whole columns over the mesh's column axis: zero communication
inside a step, collectives only for diagnostics. JAX's `shard_map` takes and
returns one global array; here every function takes and returns the
calling rank's LOCAL shard, and each rank runs the same calls (SPMD). A
``mesh`` of None is a single process: the step runs as it is and a
diagnostic reduces nothing.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from cloudy_tpu_torch import stepper as _st
from cloudy_tpu_torch.parallel import mesh as _mesh


def shard_columns(step_fn: Callable, mesh, axis_name: str = "columns"):
    """Wrap a batched per-column step ``y -> y_next`` (leading axis =
    columns) to run on this rank's shard of `axis_name`: the wrapped
    function takes and returns the local shard ``[n_local, ...]``. Columns
    are independent, so the step needs no collective."""
    _mesh.axis_group(mesh, axis_name)  # the axis must exist

    def sharded(y):
        return step_fn(y)

    return sharded


def _check_whole_columns(y: torch.Tensor, nz: int, what: str) -> None:
    if y.shape[-1] % nz != 0:
        raise ValueError(f"{what}: the local shard's {y.shape[-1]} lanes are not a whole "
                         f"number of {nz}-level columns")


def ensemble_rainshaft_step_soa(
    rhs: Callable,
    dt: float,
    mesh,
    axis_name: str = "columns",
    method: str = "ssprk33",
    *,
    nz: int,
):
    """One time step of this rank's shard of a column ensemble in the flat
    structure-of-arrays layout ``[n_tot, n_local·nz]`` (z contiguous within
    each column; `models.rainshaft.make_rainshaft_rhs_fused`). The shard
    must be a whole number of columns, so that z never crosses ranks and
    the upwind stencil stays local: a shard that is not raises (JAX states
    the requirement, ensemble.py:52-58). Zero collectives."""
    step = _st.STEPPERS[method]
    _mesh.axis_group(mesh, axis_name)

    def sharded(y):
        _check_whole_columns(y, nz, "ensemble_rainshaft_step_soa")
        return step(rhs, y, torch.zeros((), dtype=y.dtype), dt)

    return sharded


def ensemble_whole_step(step_fn: Callable, mesh, axis_name: str = "columns"):
    """Shard the whole-step kernel's wrapper (`ops.fused_coalescence.
    make_rainshaft_step_fn`, flat SoA ``[n_tot, n_local·nz]``) over the
    column axis: the wrapped function takes and returns this rank's shard.
    The shard must be a whole number of columns and a whole number of the
    kernel's blocks; the port's kernel masks the lanes past the last column
    of a partial block, so its block is one column (JAX's Pallas grid has no
    mask and needs multiples of `block_cols`). A shard that is not raises.
    The step contains zero collectives."""
    nz = step_fn.plan.nz
    _mesh.axis_group(mesh, axis_name)

    def sharded(y):
        _check_whole_columns(y, nz, "ensemble_whole_step")
        return step_fn(y)

    return sharded


def ensemble_rainshaft_step(
    rhs: Callable,
    dt: float,
    mesh,
    axis_name: str = "columns",
    method: str = "ssprk33",
    with_diagnostics: bool = False,
    spec=None,
):
    """One time step of this rank's shard ``[n_local, nz, n_tot]`` of a
    column ensemble.

    With `with_diagnostics=True` also returns the *global* total mass: Σ
    over every column of every rank, every level and **every mode** of that
    mode's M1 (flat index ``spec.dist_moment_ind(i, 1)``, the index math of
    `utils.metrics.conservation_report`), an all-reduce (SUM) over the
    axis, the only collective in the step, as a 0-d tensor on the state's
    device. `spec` is required then: summing one flat index would silently
    drop all mass promoted into higher modes."""
    step = _st.STEPPERS[method]

    def local_step(y):
        return step(rhs, y, torch.zeros((), dtype=y.dtype), dt)

    if not with_diagnostics:
        return shard_columns(local_step, mesh, axis_name)

    if spec is None:
        raise ValueError(
            "with_diagnostics=True needs the SpectrumSpec to locate every "
            "mode's mass moment in the flat state vector"
        )
    mass_idx = tuple(spec.dist_moment_ind(i, 1) for i in range(spec.n_modes))
    group, _, _ = _mesh.axis_group(mesh, axis_name)

    def sharded(y):
        y_next = local_step(y)
        local_mass = sum(torch.sum(y_next[..., o]) for o in mass_idx)
        return y_next, _mesh.all_reduce(local_mass, group=group) if mesh is not None else local_mass

    return sharded


def gather_columns(y: torch.Tensor, mesh, axis_name: str = "columns", dst: int = 0):
    """The global SoA state ``[n_tot, W·n_local·nz]`` gathered from every
    rank's shard `y` onto rank `dst` of the axis, in rank order (None on the
    other ranks); `y` itself without a mesh. Under gloo the shards travel
    through host memory and the result is a host tensor."""
    group, n, idx = _mesh.axis_group(mesh, axis_name)
    if mesh is None:
        return y
    part = y.cpu() if _mesh.via_host(y, group) else y.contiguous()
    parts = [torch.empty_like(part) for _ in range(n)] if idx == dst else None
    dist.gather(part, parts, dst=dist.get_global_rank(group, dst), group=group)
    return torch.cat(parts, dim=1) if idx == dst else None
