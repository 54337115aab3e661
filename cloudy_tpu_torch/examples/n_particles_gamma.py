"""Numerical-quadrature box with N gamma modes (reference n_particles_gamma.jl).

Port of examples/n_particles_gamma.py."""

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "n_particles_gamma",
        SpectrumSpec((Family.GAMMA, Family.GAMMA)),
        [1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16],
        kernel_func=K.LinearKernelFunction(5.0),
        numerical=True,
        t_end=60.0, dt=5.0,
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
