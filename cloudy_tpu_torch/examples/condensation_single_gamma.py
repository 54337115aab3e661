"""Condensation-only box, single gamma (reference condensation_single_gamma.jl).

Port of examples/condensation_single_gamma.py."""

from cloudy_tpu_torch.examples.common import Family, SpectrumSpec, parse_args, run_condensation_example


def main(argv=None):
    return run_condensation_example(
        "condensation_single_gamma",
        SpectrumSpec((Family.GAMMA,)),
        [1e8, 1e-2, 2e-12],
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
