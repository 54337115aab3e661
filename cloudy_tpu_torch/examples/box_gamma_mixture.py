"""Box model with two gamma modes (reference box_gamma_mixture.jl).

Port of examples/box_gamma_mixture.py."""

import numpy as np

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "box_gamma_mixture",
        SpectrumSpec((Family.GAMMA, Family.GAMMA)),
        [1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16],
        kernel=K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6),
        thresholds=(5e-10, np.inf),
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
