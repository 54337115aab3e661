"""Two gamma modes, hydrodynamic kernel (reference box_gamma_mixture_hydro.jl).

Port of examples/box_gamma_mixture_hydro.py."""

import numpy as np

from cloudy_tpu_torch.examples.common import Family, K, SpectrumSpec, parse_args, run_box_example


def main(argv=None):
    return run_box_example(
        "box_gamma_mixture_hydro",
        SpectrumSpec((Family.GAMMA, Family.GAMMA)),
        [1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16],
        kernel=K.CoalescenceTensor.from_function(K.HydrodynamicKernelFunction(5.0), 2, 1e-6),
        thresholds=(5e-10, np.inf),
        t_end=3600.0, dt=60.0,
        **parse_args(argv, __doc__),
    )


if __name__ == "__main__":
    main()
