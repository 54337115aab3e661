"""Kernel-tensor against kernel-function contour comparison (reference
test_kernel_tensor_approximation.jl).

Port of examples/test_kernel_tensor_approximation.py: the kernels evaluated
on numpy arrays on the host (no device work; `--device` is checked all the
same).
"""

import numpy as np

from cloudy_tpu_torch.examples.common import K, ensure_outdir, figures, parse_args
from cloudy_tpu_torch.utils import plotting


def main(argv=None):
    out = ensure_outdir(parse_args(argv, __doc__)["outdir"])
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    below = K.CoalescenceTensor.from_function(kf, 2, 5e-10)
    above = K.CoalescenceTensor.from_function(kf, 2, 1e-6, 5e-10)

    x = np.logspace(-11, -6, 80)
    X, Y = np.meshgrid(x, x)
    exact = np.asarray(kf(X, Y))
    approx = np.where((X < 5.236e-10) & (Y < 5.236e-10), np.asarray(below(X, Y)),
                      np.asarray(above(X, Y)))
    rel = np.abs(approx - exact) / (exact + 1e-300)
    if figures("test_kernel_tensor_approximation"):
        plt = plotting._mpl()
        fig, axes = plt.subplots(1, 3, figsize=(12, 3.4))
        for ax, z, title in zip(axes, [exact, approx, rel],
                                ["K(x,y) exact", "tensor approx", "relative error"]):
            c = ax.pcolormesh(X, Y, np.log10(np.maximum(z, 1e-300)), shading="auto")
            ax.set_xscale("log")
            ax.set_yscale("log")
            ax.set_title(title)
            fig.colorbar(c, ax=ax)
        fig.tight_layout()
        fig.savefig(f"{out}/kernel_tensor_approximation.png", dpi=110)
        plt.close(fig)
    print("max rel error in fit windows:", np.max(rel))
    return float(np.max(rel))


if __name__ == "__main__":
    main()
