"""Process-group bring-up and device meshes over `torch.distributed`.

Port of `cloudy_tpu.parallel.mesh`. Columns are embarrassingly parallel, so
the primary mesh axis shards the column ensemble; an optional second axis
shards the vertical (z) dimension with a one-cell halo for the
sedimentation flux (`parallel.halo`). Where JAX's `shard_map` takes one
global array, torch runs SPMD: each rank is one process on one device and
holds only its shard. Collectives are diagnostics reductions and the z halo.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU.
Two ranks on one card (NCCL refuses that) run gloo by the caller's choice
(``backend="gloo"``); `parallel.halo` then stages its halo through host
memory.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: environment variables whose presence means "this run is part of a
#: cluster": torchrun / torch.distributed's env:// rendezvous, SLURM and
#: OpenMPI launchers (``WORLD_SIZE`` counts only above 1)
_CLUSTER_ENV_VARS = (
    "MASTER_ADDR",
    "TORCHELASTIC_RUN_ID",
    "SLURM_JOB_NUM_NODES",
    "OMPI_COMM_WORLD_SIZE",
)

#: how long a rank waits for the others to join (and for a collective)
_INIT_TIMEOUT = datetime.timedelta(seconds=300)

#: (world size, rank) variables of each launcher, in the order they are read
_LAUNCHER_VARS = (
    ("WORLD_SIZE", "RANK"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
    ("SLURM_NTASKS", "SLURM_PROCID"),
)


def cluster_env_detected() -> bool:
    """True when the environment indicates a multi-process launch."""
    if any(os.environ.get(v) for v in _CLUSTER_ENV_VARS):
        return True
    return int(os.environ.get("WORLD_SIZE", "1") or "1") > 1


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` where it names an index or the CPU,
    else ``cuda:{LOCAL_RANK}`` (0 without a launcher)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _launcher_world() -> Tuple[Optional[int], Optional[int]]:
    for size_var, rank_var in _LAUNCHER_VARS:
        if os.environ.get(size_var) and os.environ.get(rank_var):
            return int(os.environ[size_var]), int(os.environ[rank_var])
    return None, None


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Multi-process bring-up: `torch.distributed.init_process_group` with
    arguments resolved from the environment when omitted (torchrun's
    ``WORLD_SIZE``/``RANK`` and env:// rendezvous, OpenMPI, SLURM). Returns
    True when a process group of more than one rank is up.

    The backend follows `device` (this rank's device, `rank_device`): NCCL
    for CUDA, gloo for the CPU; `backend` overrides it (gloo for two ranks
    on one card). A CUDA device becomes the process's current device.

    Failure policy (the JAX package's): a misconfigured launch must not
    silently degrade into N independent single-process runs. If the caller
    passed `init_method` or `world_size`, or cluster environment variables
    are present, a failed initialisation RAISES. With a process group
    already up, returns whether it spans more than one rank. Only a
    genuinely single-process run (no cluster signal at all) returns False,
    and initialises nothing."""
    if dist.is_initialized():
        logger.info("torch.distributed already initialized")
        return dist.get_world_size() > 1
    explicit = init_method is not None or world_size is not None
    if not (explicit or cluster_env_detected()):
        logger.info("no cluster detected; running single-process")
        return False
    device = rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    env_size, env_rank = _launcher_world()
    world_size = env_size if world_size is None else world_size
    rank = env_rank if rank is None else rank
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            timeout=_INIT_TIMEOUT,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(
            "cluster launch detected (explicit arguments or cluster environment "
            "variables) but torch.distributed.init_process_group failed; refusing "
            "to continue as N independent single-process runs"
        ) from e
    n = dist.get_world_size()
    logger.info("torch.distributed initialized (%s): rank %d/%d on %s", backend,
                dist.get_rank(), n, device)
    if n < 2 and (world_size or 2) > 1:
        raise RuntimeError(f"cluster launch detected but only {n} process(es) joined")
    return n > 1


def world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def make_mesh(axis_names: Sequence[str] = ("columns",),
              axis_sizes: Optional[Sequence[int]] = None):
    """A `torch.distributed.device_mesh.DeviceMesh` over every rank of the
    process group (which must be up), with the given axis names. With
    ``axis_sizes=None`` every rank goes on the first axis and the others get
    size 1; sizes whose product is not the world size raise `ValueError`.
    Example: ``make_mesh(("columns", "z"), (4, 2))`` on 8 ranks. The mesh's
    device type follows the backend (``cuda`` under NCCL, ``cpu`` under
    gloo, whose collectives the ranks feed from host memory where they
    must); each rank computes on its own device whatever the type."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n or len(axis_sizes) != len(axis_names):
        raise ValueError(f"mesh {tuple(axis_sizes)} over axes {tuple(axis_names)} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def axis_group(mesh, axis_name: str):
    """(process group, size, this rank's index) of `mesh`'s axis; for
    ``mesh=None`` (no process group) (None, 1, 0)."""
    if mesh is None:
        return None, 1, 0
    return mesh.get_group(axis_name), mesh[axis_name].size(), mesh.get_local_rank(axis_name)


def via_host(tensor: torch.Tensor, group=None) -> bool:
    """Whether a collective of `group` takes `tensor` from host memory: a
    CUDA tensor under gloo, whose point-to-point and collectives are fed
    from the host here. NCCL takes device tensors directly."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """`tensor` reduced over `group` (returned; staged through the host
    where `via_host`), or `tensor` itself without a process group."""
    if not dist.is_initialized():
        return tensor
    if via_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(tensor.device)
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def slowest(seconds: float, device, group=None) -> float:
    """The largest of every rank's `seconds` over `group` (a timed run ends
    when its slowest rank does); `seconds` itself without a process group."""
    t = torch.tensor(seconds, dtype=torch.float64, device=device)
    return float(all_reduce(t, op=dist.ReduceOp.MAX, group=group))
