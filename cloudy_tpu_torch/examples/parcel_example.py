"""Adiabatic parcel with condensational growth, three size-distribution
closures, against Rogers (1975) data (reference parcel_example.jl).

Port of examples/parcel_example.py.
"""

import numpy as np

from cloudy_tpu_torch.examples.common import ensure_outdir, figures, parse_args
from cloudy_tpu_torch.models import parcel as pm
from cloudy_tpu_torch.utils import plotting

KINDS = ("monodisperse", "gamma", "mixture")


def main(argv=None):
    args = parse_args(argv, __doc__)
    out = ensure_outdir(args["outdir"])
    runs = {}
    for kind in KINDS:
        spec, mom0, ml_v = pm.init_conditions(kind)
        config = pm.ParcelConfig(spec=spec)
        Y0 = pm.initial_state(config, mom0, ml_v)
        ts, ys = pm.run_parcel(config, Y0, device=args["device"])
        ts, ys = ts.numpy(), ys.cpu().numpy()
        N_l, M_l = ys[:, 4], ys[:, 5]
        r_um = (M_l / N_l / config.tps.rho_w * 3 / 4 / np.pi) ** (1 / 3) * 1e6
        runs[kind] = (ts, ys, r_um)
    if figures("parcel_example"):
        plt = plotting._mpl()
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3.6))
        ax1.plot(pm.ROGERS_TIME_SUPERSAT, pm.ROGERS_SUPERSAT, "ko", ms=3, label="Rogers 1975")
        ax2.plot(pm.ROGERS_TIME_RADIUS, pm.ROGERS_RADIUS, "ko", ms=3)
        for kind, (ts, ys, r_um) in runs.items():
            ax1.plot(ts, (ys[:, 0] - 1) * 100, label=kind)
            ax2.plot(ts, r_um)
        ax1.set_xlabel("time [s]")
        ax1.set_ylabel("supersaturation [%]")
        ax1.legend(fontsize=7)
        ax2.set_xlabel("time [s]")
        ax2.set_ylabel("mean radius [μm]")
        fig.tight_layout()
        fig.savefig(f"{out}/parcel_example.png", dpi=110)
        plt.close(fig)
    print("parcel example done")
    return runs


if __name__ == "__main__":
    main()
