"""0-D box model: collision–coalescence, or condensation alone.

Port of `cloudy_tpu.models.box` (the reference's example helpers,
test/examples/utils/box_model_helpers.jl:22-67, and its box_* example
scripts): a config dataclass, the coalescence and condensation right-hand
sides, the fixed-step time loop, and the Golovin analytic benchmark
solution.
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
from cloudy_tpu_torch.coalescence_numerical import get_coal_ints_numerical
from cloudy_tpu_torch.condensation import get_cond_evap


@dataclasses.dataclass(frozen=True)
class BoxConfig:
    """One 0-D box scenario (the reference's ODE_parameters NamedTuple,
    e.g. test/examples/Analytical/box_single_gamma.jl:28-34)."""

    spec: SpectrumSpec
    norms: Tuple[float, float] = (1e6, 1e-9)
    t_end: float = 120.0
    dt: float = 10.0
    method: str = "ssprk33"
    save_every: int = 1


def make_box_rhs(
    config: BoxConfig,
    coal_data: Optional[CoalescenceData] = None,
    kernel_func=None,
    numerical: bool = False,
):
    """RHS over physical flat moments (reference `rhs_coal!`,
    box_model_helpers.jl:29-53): normalize → invert closure → coalescence
    tendencies → denormalize. `numerical=True` uses the fixed-node quadrature
    path (`get_coal_ints_numerical` at its (256, 96) node budgets) with
    `kernel_func` (reference NumericalCoalStyle)."""
    spec = config.spec
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, config.norms)
    nkern = kernel_func.normalized(config.norms) if numerical else None

    def rhs(mom, t):
        del t
        norm = torch.as_tensor(mom_norms, dtype=mom.dtype, device=mom.device)
        params = pdists.params_from_moments(spec, mom / norm)
        if numerical:
            dm = get_coal_ints_numerical(spec, params, nkern)
        else:
            dm = get_coal_ints(coal_data, params)
        return dm * norm

    return rhs


def make_box_condensation_rhs(config: BoxConfig, s: float, xi: float, rho_l=1000.0):
    """Condensation-only box RHS (reference `rhs_condensation!`,
    box_model_helpers.jl:55-67): ξ is normalized by the mass scale^(2/3)
    before `get_cond_evap` sees the normalized moments, and the tendencies
    are denormalized by the moment norms."""
    spec = config.spec
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, config.norms)
    xi_n = xi / config.norms[1] ** (2.0 / 3.0)

    def rhs(mom, t):
        del t
        norm = torch.as_tensor(mom_norms, dtype=mom.dtype, device=mom.device)
        params = pdists.params_from_moments(spec, mom / norm)
        return get_cond_evap(spec, params, s, xi_n, rho_l) * norm

    return rhs


def run_box(config: BoxConfig, rhs, moments_init):
    """Integrate and return (ts, moment trajectory [n_saved+1, n_tot]);
    the trajectory has `moments_init`'s type and device."""
    n_steps = int(round(config.t_end / config.dt))
    return stepper.integrate(
        rhs,
        moments_init,
        0.0,
        config.dt,
        n_steps,
        method=config.method,
        save_every=config.save_every,
    )


def golovin_analytical_solution(x, x0, t, b=1.5e-3, n=1.0):
    """Exact SCE spectrum for the Golovin kernel K = b(x+y) from an
    exponential initial condition (reference box_model_helpers.jl:79-89).
    Host-side numpy/scipy (validation only)."""
    from scipy.special import ive

    x = np.asarray(x, dtype=np.float64)
    if t < np.finfo(np.float64).eps:
        return n / x0 * np.exp(-x / x0)
    tau = 1.0 - np.exp(-n * b * x0 * t)
    sqrt_tau = np.sqrt(tau)
    return (
        n
        * (1.0 - tau)
        / (x * sqrt_tau)
        * ive(1, 2.0 * x / x0 * sqrt_tau)
        * np.exp(-(1.0 + tau - 2.0 * sqrt_tau) * x / x0)
    )


def golovin_moments(x0, t, b=1.5e-3, n=1.0, orders=(0, 1, 2)):
    """Moments of the Golovin analytic solution by high-resolution log-grid
    quadrature (host-side validation helper)."""
    xs = np.logspace(-6, 4, 20000) * x0
    f = golovin_analytical_solution(xs, x0, t, b, n)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    return np.array([trapezoid(xs**q * f, xs) for q in orders])
