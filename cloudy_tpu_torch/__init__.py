"""cloudy_tpu_torch — the PyTorch/CUDA port of `cloudy_tpu`.

A moment-based cloud-microphysics solver (rebuilding CliMA/Cloudy.jl) on
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) where the JAX
package runs Pallas kernels on a TPU. The JAX package `cloudy_tpu` stays the
reference: every module here mirrors its counterpart's name and layout, and
tests/test_torch_*.py hold the two against each other on the same inputs.

This package imports torch and numpy only — never jax or `cloudy_tpu`. The
CUDA kernels are built from csrc/ at first use (ops/_build.py).

Ported so far (ROADMAP A.1-A.8): spec, kernels, distributions, coalescence,
coalescence_numerical, sedimentation, stepper, models.rainshaft, models.box,
ops.special/gauss/simpson, ops.fused_coalescence (the whole-step,
coalescence-RHS and fused per-level RHS kernels), ops.numerical_coalescence
(the direct-quadrature kernel), utils.metrics, harness (the pod ensembles
and the box scenarios) and bench.
"""

from cloudy_tpu_torch.spec import (
    Family,
    SpectrumSpec,
    get_dist_moment_ind,
    get_dist_moments_ind_range,
    get_moments_normalizing_factors,
)

__version__ = "0.1.0"

__all__ = [
    "Family",
    "SpectrumSpec",
    "get_dist_moment_ind",
    "get_dist_moments_ind_range",
    "get_moments_normalizing_factors",
]
