"""Two gamma modes, Long's piecewise kernel via a 2x2 matrix of tensors with
different fit windows (reference box_gamma_mixture_long.jl:22-30).

Port of examples/box_gamma_mixture_long.py."""

import numpy as np

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example

kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
below = K.CoalescenceTensor.from_function(kf, 2, 5e-10)
above = K.CoalescenceTensor.from_function(kf, 2, 1e-6, 5e-10)
matrix = [[below, above], [above, above]]


def main(argv=None):
    return run_box_example(
        "box_gamma_mixture_long",
        SpectrumSpec((Family.GAMMA, Family.GAMMA)),
        [1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13],
        kernel=matrix,
        thresholds=(5e-10, np.inf),
        t_end=120.0, dt=1.0, logxrange=(-11, -4),
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
