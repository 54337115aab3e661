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


def make_rainshaft_rhs(config: RainshaftConfig, coal_data: Optional[CoalescenceData],
                       coal_fn=None):
    """RHS over physical moments ``[..., nz, n_tot]``: clip negative moments
    to zero, skip coalescence where all normalized moments < eps, per-level
    sedimentation flux, upwind divergence with zero influx at the top
    (rainshaft_helpers.jl:45-89). ``coal_data=None`` gives pure
    sedimentation.

    ``coal_fn`` replaces the torch-ops coalescence with a batched function
    of normalized moments ``[B, n_tot] -> [B, n_tot]``, such as the CUDA
    coalescence kernel's wrapper (`ops.fused_coalescence.make_coal_fn`): it
    gets the levels of every column flattened, and its tendencies are
    denormalized and masked at empty levels as the torch path's are."""
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

        if coal_fn is not None:
            flat = mom_n.reshape(-1, spec.n_tot)
            coal = coal_fn(flat).reshape(mom_n.shape) * norm
            empty = torch.all(mom_n < eps, dim=-1, keepdim=True)
            coal = torch.where(empty, torch.zeros_like(coal), coal)
        elif coal_data is not None:
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


def make_rainshaft_rhs_fused(config: RainshaftConfig, fused_fn):
    """RHS over physical moments in the flat SoA layout ``[n_tot, B]`` (z
    contiguous within each column) through the fused per-level RHS kernel
    (`ops.fused_coalescence.make_rainshaft_rhs_fn`): one launch gives the
    coalescence tendencies and the sedimentation fluxes; the upwind
    divergence, the only z-coupling, stays in plain torch as the JAX package
    leaves it to XLA (rainshaft_helpers.jl:80-86): level i's upstream flux
    is the next lane, zero at each column's top. It multiplies by the
    reciprocal 1/dz, as the whole-step kernel does, never divides by dz."""
    n_tot = config.spec.n_tot
    nz = config.nz
    inv_dz = 1.0 / float(config.dz)

    def rhs(mom, t):
        del t
        B = mom.shape[-1]
        out = fused_fn.soa(mom)
        coal, flux = out[:n_tot], out[n_tot:]
        top = (torch.arange(B, device=mom.device) % nz) == (nz - 1)
        f_up = torch.where(top, torch.zeros_like(flux), torch.roll(flux, -1, dims=-1))
        return coal - (f_up - flux) * inv_dz

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
                  device="cuda"):
    """Integrate `rhs` from `mom_init` over ``t_end`` with the configured
    stepper on `device` (the card unless the caller asks for the CPU);
    returns (ts, ys) with ``ys[s]`` every ``save_every`` steps."""
    n_steps = int(round(config.t_end / config.dt))
    y0 = torch.as_tensor(np.asarray(mom_init), dtype=dtype, device=device)
    return stepper.integrate(
        rhs, y0, 0.0, config.dt, n_steps,
        method=config.method, save_every=config.save_every,
    )


def analytical_sol_sedimentation(config: RainshaftConfig, spec_family, ic, coeff, t):
    """Semi-analytic pure-sedimentation moment profiles at time t
    (reference `analytical_sol`, rainshaft_helpers.jl:102-125; a copy of
    `cloudy_tpu.models.rainshaft.analytical_sol_sedimentation`): each
    particle mass m falls at v(m) = c0 + c1·m^{1/6}; the solution advects the
    initial moment profile along characteristics z0 = z + v(m)·t and
    re-integrates the moments over a mass grid of 10,000 points. Pure numpy
    on the host (exponential and gamma closures inlined).

    - `ic`: [nz, n_mom] initial moments of a single mode
    - `coeff`: (c0, c1)
    """
    import math

    from cloudy_tpu_torch.spec import Family

    z = config.z
    nz, nmom = ic.shape
    nm = 10000
    m_ = np.logspace(-5, 4, nm)
    eps = np.finfo(np.float64).eps

    def density_np(mom_z0, m):
        m0, m1 = mom_z0[0], mom_z0[1]
        if m0 <= eps or m1 <= eps:
            return 0.0
        if spec_family == Family.EXPONENTIAL:
            n, th = m0, m1 / m0
            return n / th * math.exp(-m / th)
        if spec_family == Family.GAMMA:
            m2 = mom_z0[2]
            mean = m1 / m0
            denom = m2 / m1 - mean
            k = min(max(mean / max(denom, eps), eps), 10.0)
            th = mean / k
            return m0 * m ** (k - 1.0) / th**k / math.gamma(k) * math.exp(-m / th)
        raise ValueError(spec_family)

    def interp_ic(z0):
        # linear interpolation with linear extrapolation (reference uses
        # Line() extrapolation)
        return np.array([np.interp(z0, z, ic[:, k]) for k in range(nmom)])

    mom = np.zeros((nz, nmom))
    for i, z_ in enumerate(z):
        for j in range(1, nm - 1):
            m = m_[j]
            dm = (m_[j + 1] - m_[j - 1]) / 2
            v = coeff[0] + coeff[1] * m ** (1.0 / 6.0)
            z0 = z_ + v * t
            if z0 > z.max():
                continue
            mom_z0 = np.maximum(interp_ic(z0), 0.0)
            dens = density_np(mom_z0, m)
            if dens == 0.0:
                continue
            for k in range(nmom):
                mom[i, k] += m**k * dens * dm
    return mom
