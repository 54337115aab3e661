"""Observability: physics invariant monitors.

Port of `cloudy_tpu.utils.metrics.conservation_report`; the reductions run
where the state lies (on the card for a CUDA state).
"""

from __future__ import annotations

from typing import Dict

import torch


def conservation_report(spec, mom_flat) -> Dict[str, float]:
    """Mass/number totals + positivity violations for a state
    ``[..., n_tot]`` (the SCE's gain−loss structure conserves total M1;
    M0 must fall, M2 rise)."""
    mom = mom_flat
    m0 = sum(mom[..., spec.dist_moment_ind(i, 0)] for i in range(spec.n_modes))
    m1 = sum(mom[..., spec.dist_moment_ind(i, 1)] for i in range(spec.n_modes))
    return {
        "total_number": float(torch.sum(m0)),
        "total_mass": float(torch.sum(m1)),
        "negative_fraction": float(torch.mean((mom < 0).to(torch.float32))),
        "nonfinite_fraction": float(
            torch.mean((~torch.isfinite(mom)).to(torch.float32))
        ),
    }
