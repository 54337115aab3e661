"""Condensation / evaporation moment tendencies.

Port of `cloudy_tpu.condensation` (reference src/Sources/Condensation.jl:
22-37): the growth-law projection
``dM_m = 3 ξ s · m · M_{m−2/3} · (4π/3)^{2/3} / ρ_l^{1/3}`` (zero for the
number moment m = 0) through *fractional* analytic moments.
"""

from __future__ import annotations

import numpy as np
import torch

from cloudy_tpu_torch.spec import SpectrumSpec
from cloudy_tpu_torch import distributions as pdists


def get_cond_evap(spec: SpectrumSpec, params, s, xi, rho_l=1000.0) -> torch.Tensor:
    """Tendency of all prognostic moments, shape [..., n_tot].

    - `s`: supersaturation (S_l − 1), may be batched
    - `xi`: condensation coefficient ξ(T, p)
    - `rho_l`: liquid water density
    """
    params = torch.as_tensor(params)
    dtype, device = params.dtype, params.device
    s = torch.as_tensor(s, dtype=dtype, device=device)
    xi = torch.as_tensor(xi, dtype=dtype, device=device)
    coef = 3.0 * xi * s * (4.0 * np.pi / 3.0) ** (2.0 / 3.0) / rho_l ** (1.0 / 3.0)
    zero_shape = torch.broadcast_shapes(params[..., 0, 0].shape, s.shape)

    out = []
    for i in range(spec.n_modes):
        for m in range(spec.nprogmoms[i]):
            if m == 0:
                out.append(torch.zeros(zero_shape, dtype=dtype, device=device))
            else:
                frac = pdists.moment(spec, params, m - 2.0 / 3.0)[..., i]
                out.append(coef * m * frac)
    return torch.stack(out, dim=-1)
