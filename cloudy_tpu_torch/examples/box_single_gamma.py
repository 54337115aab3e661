"""Box model with a single gamma mode (reference box_single_gamma.jl).

Port of examples/box_single_gamma.py."""

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "box_single_gamma",
        SpectrumSpec((Family.GAMMA,)),
        [1e8, 1e-2, 2e-12],
        kernel=K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6),
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
