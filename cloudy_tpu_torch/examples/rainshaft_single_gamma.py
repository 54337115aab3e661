"""1-D rainshaft, single gamma (reference rainshaft_single_gamma.jl).

Port of examples/rainshaft_single_gamma.py."""

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_rainshaft_example


def main(argv=None):
    return run_rainshaft_example(
        "rainshaft_single_gamma",
        SpectrumSpec((Family.GAMMA,)),
        [1e8, 1e-2, 2e-12],
        kernel=K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6),
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
