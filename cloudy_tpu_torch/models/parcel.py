"""Adiabatic rising-parcel model with Cloudy condensational growth.

Port of `cloudy_tpu.models.parcel` (reference
test/examples/Analytical/parcel_example.jl:15-145). State vector
``Y = [S_l, p, T, q_v, moments...]`` coupled through the condensation moment
source: the parcel rises at fixed updraft w; supersaturation is produced by
cooling (a1 term) and consumed by condensational growth (a2 + a3 terms);
moments evolve by `get_cond_evap`. Validated against the Rogers (1975)
digitized supersaturation/radius curves.

The state is seven or ten numbers, so on the card the run is bound by the
host: each RHS evaluation is a few dozen small torch launches, and no
hand-written kernel is on this path (the JAX package does not batch the
parcel either).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import distributions as pdists
from cloudy_tpu_torch import stepper
from cloudy_tpu_torch.condensation import get_cond_evap
from cloudy_tpu_torch.models import thermodynamics as th


@dataclasses.dataclass(frozen=True)
class ParcelConfig:
    spec: SpectrumSpec
    tps: th.ThermoParams = th.ThermoParams()
    w: float = 10.0  # updraft speed [m/s]
    dt: float = 0.5
    t_end: float = 20.0
    method: str = "ssprk33"


def make_parcel_rhs(config: ParcelConfig):
    """RHS over Y = [S_l, p, T, q_v, moments...] (reference
    parcel_model_cloudy, parcel_example.jl:15-85)."""
    spec = config.spec
    tps = config.tps
    mass_inds = tuple(spec.offsets[i] + 1 for i in range(spec.n_modes))

    def rhs(Y, t):
        del t
        S_l, p_air, T, q_v = Y[0], Y[1], Y[2], Y[3]
        moments = Y[4:]

        rho_l = tps.rho_w
        grav = tps.grav
        R_v = tps.R_v

        # water mass budget from the first-order (mass) moments
        m_l = sum(moments[i] for i in mass_inds)

        rho_air = th.air_density(tps, T, p_air, q_v)
        q_l = m_l / rho_air

        R_air = th.gas_constant_air(tps, q_v + q_l, q_l)
        cp_air = th.cp_m(tps, q_v + q_l, q_l)
        L_vap = th.latent_heat_vapor(tps, T)

        a1 = L_vap * grav / cp_air / T**2 / R_v - grav / R_air / T
        a2 = 1.0 / q_v
        a3 = L_vap**2 / R_v / T**2 / cp_air

        params = pdists.params_from_moments(spec, moments)
        xi = th.condensation_coefficient(tps, T)
        dmom = get_cond_evap(spec, params, S_l - 1.0, xi, rho_l)

        dql_dt = sum(dmom[i] for i in mass_inds) / rho_air

        dS_dt = a1 * config.w * S_l - (a2 + a3) * S_l * dql_dt
        dp_dt = -p_air * grav / R_air / T * config.w
        dT_dt = -grav / cp_air * config.w + L_vap / cp_air * dql_dt
        dqv_dt = -dql_dt

        return torch.cat([torch.stack([dS_dt, dp_dt, dT_dt, dqv_dt]), dmom])

    return rhs


def init_conditions(kind: str, tps: th.ThermoParams = th.ThermoParams()):
    """Reference `init_conditions` (parcel_example.jl:113-145): 200/cc of
    8 μm droplets as monodisperse / gamma(k=2) / exp+gamma mixture.
    Returns (spec, moments as a numpy array, liquid mass per volume)."""
    r0 = 8e-6
    N = 200.0 * 1e6
    m0 = 4.0 / 3.0 * np.pi * r0**3 * tps.rho_w
    if kind == "monodisperse":
        spec = SpectrumSpec((Family.MONODISPERSE,))
        params = np.array([[N, m0, 0.0]])
    elif kind == "gamma":
        spec = SpectrumSpec((Family.GAMMA,))
        k = 2.0
        params = np.array([[N, m0 / k, k]])
    elif kind == "mixture":
        spec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA))
        k = 2.0
        M0 = [9 * N / 10, N / 10]
        M1 = [N * m0 / 2, N * m0 / 2]
        params = np.array(
            [
                [M0[0], M1[0] / M0[0], 0.0],
                [M0[1], M1[1] / M0[1] / k, k],
            ]
        )
    else:
        raise ValueError(kind)
    moments = pdists.get_moments(spec, torch.from_numpy(params)).numpy()
    ml_v = sum(moments[spec.offsets[i] + 1] for i in range(spec.n_modes))
    return spec, moments, ml_v


def initial_state(config: ParcelConfig, moments, ml_v, p0=8e4, T0=280.15, S0=1.0):
    """Assemble Y0 as a numpy array (reference parcel_example.jl:160-175):
    ambient state at saturation with the liquid already condensed."""
    tps = config.tps
    e = float(th.saturation_vapor_pressure_liquid(tps, T0))
    md_v = (p0 - e) / tps.R_d / T0
    mv_v = e / tps.R_v / T0
    q_v = mv_v / (md_v + mv_v + ml_v)
    return np.concatenate([[S0, p0, T0, q_v], np.asarray(moments)])


def _state(Y0, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); ask for "
            "device='cpu' to run the parcel on the host"
        )
    return torch.as_tensor(np.asarray(Y0), dtype=torch.float64, device=device)


def run_parcel(config: ParcelConfig, Y0, device="cuda"):
    """Integrate the parcel from `Y0` in f64 on `device` (the card unless
    the caller asks for the CPU) at fixed dt; returns (ts, ys) as
    `stepper.integrate` does, ``ys`` on `device`."""
    n_steps = int(round(config.t_end / config.dt))
    rhs = make_parcel_rhs(config)
    return stepper.integrate(
        rhs, _state(Y0, device), 0.0, config.dt, n_steps, method=config.method
    )


def run_parcel_adaptive(config: ParcelConfig, Y0, rtol=1e-7, atol=1e-10, device="cuda"):
    """Adaptive-Δt parcel run, an added capability beyond the reference.

    The reference passes reltol/abstol to OrdinaryDiffEq's SSPRK33
    (parcel_example.jl:105-110), but SSPRK33 has no embedded error
    estimator and is fixed-step-only, so those tolerances are inert and the
    reference integrates at fixed dt, for which fixed-grid `run_parcel` is
    the parity path. This adds step-doubling adaptivity on top, one host
    read per trial on the card. Returns (Y_final, stats) from
    `stepper.integrate_adaptive`; check ``stats["reached"]``."""
    rhs = make_parcel_rhs(config)
    return stepper.integrate_adaptive(
        rhs, _state(Y0, device), 0.0, config.t_end, rtol=rtol, atol=atol,
        dt0=config.dt, method=config.method,
    )


# Rogers (1975) Figure 1 digitized data (reference parcel_example.jl:188-193)
ROGERS_TIME_SUPERSAT = np.array(
    [0.0645, 0.511, 0.883, 1.4, 2.07, 2.72, 3.24, 3.89, 4.53, 5.87, 7.16, 9.79, 16.0, 19.8]
)
ROGERS_SUPERSAT = np.array(
    [0.0268, 0.255, 0.393, 0.546, 0.707, 0.805, 0.863, 0.905, 0.938, 0.971, 0.978, 0.963, 0.910, 0.885]
)
ROGERS_TIME_RADIUS = np.array([0.561, 2, 3.99, 10.7, 14.9, 19.9])
ROGERS_RADIUS = np.array([8.0, 8.08, 8.26, 8.91, 9.26, 9.68])
