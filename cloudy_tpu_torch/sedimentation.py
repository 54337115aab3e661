"""Sedimentation moment fluxes.

Port of `cloudy_tpu.sedimentation` (reference src/Sources/Sedimentation.jl:22-37):
for a power-law terminal velocity ``v(x) = Σ_k c_k x^{e_k}`` the flux of
prognostic moment m is ``−Σ_k c_k · M_{m + e_k}`` (fractional moments).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from cloudy_tpu_torch.spec import SpectrumSpec
from cloudy_tpu_torch import distributions as pdists


def get_sedimentation_flux(
    spec: SpectrumSpec, params, vel: Sequence[Tuple[float, float]]
) -> torch.Tensor:
    """Flux of all prognostic moments, shape [..., n_tot]; `vel` is a static
    sequence of (coefficient, exponent) pairs."""
    out = []
    for i in range(spec.n_modes):
        for m in range(spec.nprogmoms[i]):
            acc = 0.0
            for coef, expo in vel:
                acc = acc - coef * pdists.moment(spec, params, m + expo)[..., i]
            out.append(acc)
    return torch.stack(out, dim=-1)


def normalized_velocity(vel, norms) -> Tuple[Tuple[float, float], ...]:
    """Velocity coefficients in mass-normalized units ``(c · m_norm^e, e)``
    (reference rainshaft helpers, test/examples/utils/rainshaft_helpers.jl:72-75)."""
    return tuple((c * norms[1] ** e, e) for (c, e) in vel)
