"""Condensation-only box, exp+gamma mixture (reference condensation_exp_gamma.jl).

Port of examples/condensation_exp_gamma.py."""

from cloudy_tpu_torch.examples.common import Family, SpectrumSpec, parse_args, run_condensation_example


def main(argv=None):
    return run_condensation_example(
        "condensation_exp_gamma",
        SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA)),
        [9e7, 5e-3, 1e7, 5e-3, 6e-13],
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
