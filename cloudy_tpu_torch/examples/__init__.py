"""The port's example scripts: one per script of the JAX package's
examples/ (the reference's box, rainshaft, condensation, numerical-
quadrature and parcel examples, the kernel-tensor approximation figure and
the calibration example), each runnable as

    python -m cloudy_tpu_torch.examples.<name> [--device cuda|cpu] [--outdir DIR]

and each with a ``main(argv=None)`` that returns what it computed (see
`common`).
"""

#: every example script, by module name (the 23 of examples/)
EXAMPLES = (
    "box_gamma_mix_moving", "box_gamma_mixture", "box_gamma_mixture_3modes",
    "box_gamma_mixture_4modes", "box_gamma_mixture_hydro", "box_gamma_mixture_long",
    "box_lognorm_mixture", "box_mono_gamma_mixture", "box_single_gamma",
    "box_single_gamma_hydro", "box_single_lognorm", "calibration_example",
    "condensation_exp_gamma", "condensation_single_gamma", "n_particles_exp",
    "n_particles_gamma", "n_particles_lognorm", "parcel_example",
    "rainshaft_gamma_mixture", "rainshaft_single_gamma", "single_particle_exp",
    "single_particle_gamma", "test_kernel_tensor_approximation",
)
