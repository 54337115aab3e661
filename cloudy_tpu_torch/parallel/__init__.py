"""Distributed backend over `torch.distributed`: process groups and device
meshes, sharded column ensembles, the z halo exchange (port of
`cloudy_tpu.parallel`)."""

from cloudy_tpu_torch.parallel.mesh import make_mesh, initialize_distributed
from cloudy_tpu_torch.parallel.ensemble import shard_columns, ensemble_rainshaft_step
from cloudy_tpu_torch.parallel.halo import make_z_sharded_rainshaft_rhs

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "shard_columns",
    "ensemble_rainshaft_step",
    "make_z_sharded_rainshaft_rhs",
]
