"""Single gamma mode, hydrodynamic kernel (reference box_single_gamma_hydro.jl).

Port of examples/box_single_gamma_hydro.py."""

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "box_single_gamma_hydro",
        SpectrumSpec((Family.GAMMA,)),
        [1e8, 1e-2, 2e-12],
        kernel=K.CoalescenceTensor.from_function(K.HydrodynamicKernelFunction(5.0), 2, 1e-6),
        t_end=3600.0, dt=60.0,
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
