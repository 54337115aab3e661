"""Minimal moist thermodynamics for the parcel model.

Port of `cloudy_tpu.models.thermodynamics`: the gas constants, saturation
vapour pressure and condensational-growth coefficient G(T) that the
reference parcel example takes from Thermodynamics.jl / CloudMicrophysics.jl
(test/examples/Analytical/parcel_example.jl:4-8), inlined with standard
constant values. Each function takes numbers or tensors and keeps a tensor
argument's type and device; a number becomes an f64 tensor on the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ThermoParams:
    R_d: float = 287.04  # dry-air gas constant      [J/kg/K]
    R_v: float = 461.5  # water-vapor gas constant   [J/kg/K]
    cp_d: float = 1005.0  # dry-air isobaric heat capacity
    cp_v: float = 1860.0  # vapor heat capacity
    cp_l: float = 4181.0  # liquid water heat capacity
    grav: float = 9.81
    rho_w: float = 1000.0  # liquid water density     [kg/m^3]
    L_v0: float = 2.5008e6  # latent heat of vaporization at T0
    T0: float = 273.16  # triple point               [K]
    e_s0: float = 611.73  # saturation pressure at T0 [Pa]
    K_therm: float = 2.4e-2  # thermal conductivity of air [W/m/K]
    D_vapor: float = 2.26e-5  # vapor diffusivity          [m^2/s]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def latent_heat_vapor(tps: ThermoParams, T):
    """Kirchhoff's relation: L(T) = L0 + (cp_v − cp_l)(T − T0)."""
    return tps.L_v0 + (tps.cp_v - tps.cp_l) * (T - tps.T0)


def saturation_vapor_pressure_liquid(tps: ThermoParams, T):
    """Clausius–Clapeyron with temperature-dependent latent heat
    (Tetens-free, integrated form)."""
    T = _tensor(T)
    L0, dcp = tps.L_v0, tps.cp_v - tps.cp_l
    return tps.e_s0 * torch.exp(
        (L0 - dcp * tps.T0) / tps.R_v * (1.0 / tps.T0 - 1.0 / T)
        + dcp / tps.R_v * torch.log(T / tps.T0)
    )


def gas_constant_air(tps: ThermoParams, q_vap, q_liq=0.0, q_ice=0.0):
    """Moist-air gas constant for specific humidities (liquid/ice carry no
    pressure)."""
    q_dry = 1.0 - q_vap - q_liq - q_ice
    return tps.R_d * q_dry + tps.R_v * q_vap + 0.0 * (q_liq + q_ice)


def cp_m(tps: ThermoParams, q_vap, q_liq=0.0, q_ice=0.0):
    q_dry = 1.0 - q_vap - q_liq - q_ice
    return tps.cp_d * q_dry + tps.cp_v * q_vap + tps.cp_l * q_liq


def air_density(tps: ThermoParams, T, p, q_vap, q_liq=0.0, q_ice=0.0):
    return p / (gas_constant_air(tps, q_vap, q_liq, q_ice) * T)


def G_func_liquid(tps: ThermoParams, T):
    """Radius-based condensational growth coefficient G_r(T) [m²/s]:
    r·dr/dt = (S−1)·G_r with G_r = 1/(F_k + F_d),
    F_k = L ρ_w/(K T)(L/(R_v T) − 1), F_d = ρ_w R_v T/(D e_s(T))
    (Rogers & Yau eq. 7.17)."""
    L = latent_heat_vapor(tps, T)
    e_s = saturation_vapor_pressure_liquid(tps, T)
    F_k = L * tps.rho_w / (tps.K_therm * T) * (L / (tps.R_v * T) - 1.0)
    F_d = tps.rho_w * tps.R_v * T / (tps.D_vapor * e_s)
    return 1.0 / (F_k + F_d)


def condensation_coefficient(tps: ThermoParams, T):
    """Mass-based growth coefficient ξ(T) [kg/m/s] for the Cloudy moment
    source ``dm/dt = 3 ξ (S−1) (4π/3)^{2/3} ρ_l^{−1/3} m^{1/3}``
    (src/Sources/Condensation.jl:22-37): ξ = ρ_w · G_r(T)."""
    return tps.rho_w * G_func_liquid(tps, T)
