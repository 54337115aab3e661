"""cloudy_tpu_torch — the PyTorch/CUDA port of `cloudy_tpu`.

A moment-based cloud-microphysics solver (rebuilding CliMA/Cloudy.jl) on
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) where the JAX
package runs Pallas kernels on a TPU. The JAX package `cloudy_tpu` stays the
reference: every module here mirrors its counterpart's name and layout, and
tests/test_torch_*.py hold the two against each other on the same inputs.

This package imports torch and numpy (matplotlib and scipy where the JAX
module uses them) — never jax or `cloudy_tpu`. The CUDA kernels are built
from csrc/ at first use (ops/_build.py); the native oracle from
native/cloudy_golden.cc with g++ (`native`).

Ported: every module of the JAX package — spec, kernels, distributions,
coalescence, coalescence_numerical, condensation, sedimentation, stepper,
calibrate, native; models (box, rainshaft, parcel, thermodynamics); ops
(special, gauss, simpson; the kernels of every Pallas call: the whole step,
its scaled form, the coalescence RHS and the fused per-level RHS in
ops.fused_coalescence and ops.codegen, the direct-quadrature kernel in
ops.numerical_coalescence with any kernel function through ops.kernel_expr,
the operation chains in ops.op_chains); parallel; utils (checkpoint, debug,
io, metrics, plotting); harness, bench, examples and tools — except what
ROADMAP.md names as code the port does not need (the TPU cost model, HLO
probes, orbax, the TPU workarounds).
"""

from cloudy_tpu_torch.spec import (
    Family,
    SpectrumSpec,
    get_dist_moment_ind,
    get_dist_moments_ind_range,
    get_moments_normalizing_factors,
)
from cloudy_tpu_torch import kernels
from cloudy_tpu_torch import distributions
from cloudy_tpu_torch import coalescence
from cloudy_tpu_torch import coalescence_numerical
from cloudy_tpu_torch import condensation
from cloudy_tpu_torch import sedimentation
from cloudy_tpu_torch import stepper
from cloudy_tpu_torch import calibrate

__version__ = "0.1.0"

__all__ = [
    "Family",
    "SpectrumSpec",
    "get_dist_moment_ind",
    "get_dist_moments_ind_range",
    "get_moments_normalizing_factors",
    "kernels",
    "distributions",
    "coalescence",
    "coalescence_numerical",
    "condensation",
    "sedimentation",
    "stepper",
    "calibrate",
]
