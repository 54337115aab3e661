"""Numerical-quadrature box, one gamma mode (reference single_particle_gamma.jl).

Port of examples/single_particle_gamma.py."""

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "single_particle_gamma",
        SpectrumSpec((Family.GAMMA,)),
        [1e8, 1e-2, 2e-12],
        kernel_func=K.LinearKernelFunction(5.0),
        numerical=True,
        t_end=120.0, dt=10.0,
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
