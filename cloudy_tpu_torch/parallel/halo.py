"""Vertical (z) domain decomposition with a point-to-point halo exchange.

Port of `cloudy_tpu.parallel.halo`. The column-sharded layout
(`parallel.ensemble`) needs no halo. Here the vertical axis is split into
contiguous blocks over a mesh axis, and the first-order upwind
sedimentation stencil ``dM_i = −(F[i+1] − F[i])/dz`` (reference
rainshaft_helpers.jl:80-86) needs exactly one cell of flux from the block
above.

Overlap: the halo's receive and send are posted on the *flux* (cheap,
computed first), then the expensive coalescence runs, then the exchange is
waited on and only the stencil's tail reads the received cell (JAX leaves
the overlap to XLA's scheduler, halo.py:71-90). NCCL sends device tensors
directly; under gloo, whose point-to-point takes host tensors, a CUDA
halo is staged through host memory (`parallel.mesh.via_host`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from cloudy_tpu_torch.spec import SpectrumSpec, get_moments_normalizing_factors
from cloudy_tpu_torch import distributions as pdists
from cloudy_tpu_torch import stepper as _st
from cloudy_tpu_torch.coalescence import CoalescenceData, get_coal_ints
from cloudy_tpu_torch.parallel import mesh as _mesh
from cloudy_tpu_torch.sedimentation import get_sedimentation_flux, normalized_velocity


class HaloExchange:
    """One posted exchange of the bottom cell ``x_block[..., 0:1, :]`` along
    a mesh axis: z blocks are ordered bottom → top by the axis's rank, block
    d receives from block d + 1 and sends to block d − 1; the topmost block
    receives `fill` (zero influx). `wait()` returns the received cell
    ``[..., 1, n]`` on `x_block`'s device."""

    def __init__(self, x_block: torch.Tensor, mesh, axis_name: str, fill: float = 0.0):
        group, n, idx = _mesh.axis_group(mesh, axis_name)
        bottom = x_block[..., :1, :].contiguous()
        self._device = x_block.device
        self._host = n > 1 and _mesh.via_host(bottom, group)
        if self._host:
            bottom = bottom.cpu()
        self._works = []
        self._recv = None
        if idx + 1 < n:  # post the receive from the block above first
            self._recv = torch.empty_like(bottom)
            self._works.append(dist.irecv(self._recv, dist.get_global_rank(group, idx + 1),
                                          group=group))
        else:
            self._fill = torch.full_like(x_block[..., :1, :], fill)
        if idx > 0:
            self._send = bottom  # kept alive until the send completes
            self._works.append(dist.isend(bottom, dist.get_global_rank(group, idx - 1),
                                          group=group))

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        if self._recv is None:
            return self._fill
        return self._recv.to(self._device) if self._host else self._recv


def halo_from_above(x_block: torch.Tensor, mesh, axis_name: str = "z", fill=0.0):
    """The bottom cell of the block above along `axis_name` (`fill` on the
    topmost block): post and wait at once."""
    return HaloExchange(x_block, mesh, axis_name, fill).wait()


def make_z_sharded_rainshaft_rhs(
    spec: SpectrumSpec,
    coal_data: Optional[CoalescenceData],
    dz: float,
    vel,
    norms: Tuple[float, float],
    mesh=None,
    axis_name: str = "z",
):
    """Local-block rainshaft RHS for this rank's state block ``[...,
    nz_local, n_tot]`` with z split along `axis_name` of `mesh`.

    The physics of `models.rainshaft.make_rainshaft_rhs`, and its
    operations: the divergence divides by `dz` as that RHS does (not the
    fused route's reciprocal), so a z-split step equals the unsplit one bit
    for bit. Only the topmost flux cell crosses a block boundary; its
    exchange is posted before the coalescence and waited on after it."""
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, norms)
    vel_n = normalized_velocity(vel, norms)

    def rhs(mom, t):
        del t
        dtype = mom.dtype
        norm = torch.as_tensor(mom_norms, dtype=dtype, device=mom.device)
        eps = torch.finfo(dtype).eps

        mom = torch.clamp(mom, min=0.0)
        mom_n = mom / norm
        params = pdists.params_from_moments(spec, mom_n)

        # flux first; post the halo exchange at once …
        flux = get_sedimentation_flux(spec, params, vel_n) * norm
        halo = HaloExchange(flux, mesh, axis_name)

        # … then the expensive part, while the cell is in flight
        if coal_data is not None:
            coal = get_coal_ints(coal_data, params) * norm
            empty = torch.all(mom_n < eps, dim=-1, keepdim=True)
            coal = torch.where(empty, torch.zeros_like(coal), coal)
        else:
            coal = torch.zeros_like(mom)

        flux_up = torch.cat([flux[..., 1:, :], halo.wait()], dim=-2)
        sedi = -(flux_up - flux) / dz
        return coal + sedi

    return rhs


def z_sharded_step(rhs, dt: float, mesh=None, col_axis: str = "columns",
                   z_axis: str = "z", method: str = "ssprk33"):
    """One SSP-RK step of this rank's block ``[n_col_local, nz_local,
    n_tot]`` of a column ensemble with columns split on `col_axis` and z on
    `z_axis` (a 2-D mesh); `rhs` from `make_z_sharded_rainshaft_rhs`."""
    step = _st.STEPPERS[method]
    for axis in (col_axis, z_axis):
        _mesh.axis_group(mesh, axis)

    def sharded(y):
        return step(rhs, y, torch.zeros((), dtype=y.dtype), dt)

    return sharded
