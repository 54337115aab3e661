"""Four gamma modes with MovingThreshold percentile promotion
(reference box_gamma_mix_moving.jl).

Port of examples/box_gamma_mix_moving.py."""

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "box_gamma_mix_moving",
        SpectrumSpec((Family.GAMMA,) * 4),
        [1e8, 1e-2, 2e-12] + [0.0] * 9,
        kernel=K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6),
        thresholds=(0.99, 0.99, 0.99, 1.0),
        moving=True,
        t_end=120.0, dt=1.0,
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
