"""1-D rainshaft: coalescence + upwind finite-volume sedimentation.

Port of `cloudy_tpu.models.rainshaft` (reference script
test/examples/utils/rainshaft_helpers.jl:45-89). A column is a dense
``[nz, n_tot]`` tensor and any leading batch axes give a column ensemble
``[..., nz, n_tot]`` (the AoS layout of the torch reference path). The
whole-step CUDA kernel works on the flat structure-of-arrays layout
``[n_tot, n_columns·nz]``; `to_soa`/`from_soa` convert.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cloudy_tpu_torch.spec import SpectrumSpec, get_moments_normalizing_factors
from cloudy_tpu_torch import distributions as pdists
from cloudy_tpu_torch import stepper
from cloudy_tpu_torch.coalescence import CoalescenceData, get_coal_ints
from cloudy_tpu_torch.sedimentation import get_sedimentation_flux, normalized_velocity


@dataclasses.dataclass(frozen=True)
class RainshaftConfig:
    """One 1-D rainshaft scenario (reference rainshaft_single_gamma.jl)."""

    spec: SpectrumSpec
    nz: int = 128
    zmax: float = 3000.0
    norms: Tuple[float, float] = (1e6, 1e-9)
    #: terminal velocity v(x) = Σ c_k x^{e_k} (reference examples: 50 x^{1/6})
    vel: Tuple[Tuple[float, float], ...] = ((50.0, 1.0 / 6.0),)
    t_end: float = 1000.0
    dt: float = 1.0
    method: str = "ssprk33"
    save_every: int = 1

    @property
    def dz(self) -> float:
        return self.zmax / self.nz

    @property
    def z(self) -> np.ndarray:
        """Cell centers (evenly spaced grid)."""
        return (np.arange(self.nz) + 0.5) * self.dz


def initial_condition(z, mom_amp):
    """Top-hat profile in z ∈ [0.5, 0.75)·zmax scaled per moment
    (reference `initial_condition`, rainshaft_helpers.jl:17-36); numpy."""
    z = np.asarray(z)
    zmax = z.max()
    dz = z[1] - z[0]
    at = ((z >= 0.5 * zmax - dz / 2) & (z < 0.75 * zmax - dz / 2)).astype(np.float64)
    return at[:, None] * np.asarray(mom_amp)[None, :]


def make_rainshaft_rhs(config: RainshaftConfig, coal_data: Optional[CoalescenceData]):
    """RHS over physical moments ``[..., nz, n_tot]``: clip negative moments
    to zero, skip coalescence where all normalized moments < eps, per-level
    sedimentation flux, upwind divergence with zero influx at the top
    (rainshaft_helpers.jl:45-89). ``coal_data=None`` gives pure
    sedimentation."""
    spec = config.spec
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, config.norms)
    vel_n = normalized_velocity(config.vel, config.norms)

    def rhs(mom, t):
        del t
        dtype = mom.dtype
        norm = torch.as_tensor(mom_norms, dtype=dtype, device=mom.device)
        eps = torch.finfo(dtype).eps

        mom = torch.clamp(mom, min=0.0)  # negative clipping (:53)
        mom_n = mom / norm
        params = pdists.params_from_moments(spec, mom_n)

        if coal_data is not None:
            coal = get_coal_ints(coal_data, params) * norm
            # empty-cell skip (:67-68)
            empty = torch.all(mom_n < eps, dim=-1, keepdim=True)
            coal = torch.where(empty, torch.zeros_like(coal), coal)
        else:
            coal = torch.zeros_like(mom)

        flux = get_sedimentation_flux(spec, params, vel_n) * norm
        # upwind divergence, downward transport, zero influx at top (:80-86):
        # d m_i = -(F[i+1] - F[i]) / dz  with F[nz] = 0
        flux_top = torch.nn.functional.pad(flux, (0, 0, 0, 1))
        sedi = -(flux_top[..., 1:, :] - flux_top[..., :-1, :]) / config.dz
        return coal + sedi

    return rhs


def to_soa(state):
    """``[..., nz, n_tot]`` → flat SoA ``[n_tot, B]`` with z contiguous
    within each column (the whole-step kernel's layout)."""
    s = torch.movedim(torch.as_tensor(state), -1, 0)
    return s.reshape(s.shape[0], -1).contiguous()


def from_soa(state, nz: int):
    """Flat SoA ``[n_tot, B]`` → ``[B // nz, nz, n_tot]`` (a view)."""
    n_tot = state.shape[0]
    return torch.movedim(state.reshape(n_tot, -1, nz), 0, -1)


def run_rainshaft(config: RainshaftConfig, rhs, mom_init, dtype=torch.float64,
                  device="cpu"):
    """Integrate `rhs` from `mom_init` over ``t_end`` with the configured
    stepper; returns (ts, ys) with ``ys[s]`` every ``save_every`` steps."""
    n_steps = int(round(config.t_end / config.dt))
    y0 = torch.as_tensor(np.asarray(mom_init), dtype=dtype, device=device)
    return stepper.integrate(
        rhs, y0, 0.0, config.dt, n_steps,
        method=config.method, save_every=config.save_every,
    )
