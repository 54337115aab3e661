"""Matplotlib figures of box and rainshaft results.

Port of `cloudy_tpu.utils.plotting` (reference test/examples/utils/
plotting_helpers.jl:26-437): moment time series, reconstructed mass spectra
``3x² f(x)`` against radius, parameter evolution, and rainshaft profiles
with analytic overlays. Figures are drawn with the Agg backend; times,
heights and trajectories may be tensors on any device or arrays (they are
read to the host), and the closure is inverted there in f64 through the
port's `distributions`. `available` says whether matplotlib is installed;
the examples skip their figures, saying so, where it is not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cloudy_tpu_torch import distributions as pdists


def available() -> bool:
    """Whether matplotlib is installed (an environment may lack it; each
    plot raises ImportError there)."""
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _mom_norms(spec, norms):
    return np.concatenate(
        [norms[0] * norms[1] ** np.arange(n) for n in spec.nprogmoms]
    )


def plot_moments(spec, ts, ys, file_name, norms=(1e6, 1e-9)):
    """Per-mode moment time series (reference `plot_moments!`)."""
    plt = _mpl()
    ts, ys = _host(ts), _host(ys)
    n_max = max(spec.nprogmoms)
    fig, axes = plt.subplots(1, n_max, figsize=(4 * n_max, 3.2))
    axes = np.atleast_1d(axes)
    for m in range(n_max):
        ax = axes[m]
        total = None
        for i in range(spec.n_modes):
            if m >= spec.nprogmoms[i]:
                continue
            y = ys[:, spec.dist_moment_ind(i, m)]
            total = y if total is None else total + y
            ax.plot(ts, y, label=f"mode {i}")
        ax.plot(ts, total, "k--", label="total")
        ax.set_xlabel("time [s]")
        ax.set_ylabel(f"M{m}")
        ax.set_yscale("log")
        if m == 0:
            ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(file_name, dpi=110)
    plt.close(fig)


def plot_params(spec, ts, ys, file_name, norms=(1e6, 1e-9)):
    """Distribution-parameter evolution (reference `plot_params!`)."""
    plt = _mpl()
    ts, ys = _host(ts), _host(ys).astype(np.float64)
    params = pdists.params_from_moments(
        spec, torch.from_numpy(ys / _mom_norms(spec, norms))).numpy()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    names = ["n", "θ / μ", "k / σ"]
    for j in range(3):
        for i in range(spec.n_modes):
            axes[j].plot(ts, params[:, i, j], label=f"mode {i}")
        axes[j].set_xlabel("time [s]")
        axes[j].set_ylabel(names[j])
        axes[j].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(file_name, dpi=110)
    plt.close(fig)


def plot_spectra(
    spec,
    ts,
    ys,
    file_name,
    norms=(1e6, 1e-9),
    logxrange=(-12, -3),
    times: Optional[Sequence[float]] = None,
    overlay=None,
):
    """Reconstructed mass spectra 3x²f(x) against radius at selected times
    (reference `plot_spectra!`); `overlay` is an optional (x, f(x)) analytic
    curve (e.g. the Golovin solution)."""
    plt = _mpl()
    ts, ys = _host(ts), _host(ys).astype(np.float64)
    if times is None:
        idxs = [0, len(ts) // 2, len(ts) - 1]
    else:
        idxs = [int(np.argmin(np.abs(ts - t))) for t in times]

    x = np.logspace(logxrange[0], logxrange[1], 200)  # kg
    r_um = (x / 1000.0 * 3.0 / 4.0 / np.pi) ** (1.0 / 3.0) * 1e6
    mom_norms = _mom_norms(spec, norms)

    fig, ax = plt.subplots(figsize=(5.5, 3.6))
    for idx in idxs:
        params = pdists.params_from_moments(spec, torch.from_numpy(ys[idx] / mom_norms))
        dens = (pdists.density(spec, params, torch.from_numpy(x / norms[1])).numpy().sum(-1)
                * norms[0] / norms[1])
        ax.plot(r_um, 3 * x**2 * dens, label=f"t = {ts[idx]:.0f} s")
    if overlay is not None:
        ox, of = (_host(v) for v in overlay)
        orum = (ox / 1000.0 * 3 / 4 / np.pi) ** (1 / 3) * 1e6
        ax.plot(orum, 3 * ox**2 * of, "k:", label="analytic")
    ax.set_xscale("log")
    ax.set_xlabel("radius [μm]")
    ax.set_ylabel("mass spectrum 3x²f(x)")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(file_name, dpi=110)
    plt.close(fig)


def plot_rainshaft_results(
    spec, ts, z, ys, file_name, norms=(1e6, 1e-9), analytic=None
):
    """Moment profiles against height at several times (reference
    `plot_rainshaft_results`); `analytic` is an optional [nz, n_mom] overlay
    for the final time."""
    plt = _mpl()
    ts, z, ys = _host(ts), _host(z), _host(ys)
    if analytic is not None:
        analytic = _host(analytic)
    n_tot = ys.shape[-1]
    idxs = [0, len(ts) // 2, len(ts) - 1]
    fig, axes = plt.subplots(1, n_tot, figsize=(2.6 * n_tot, 3.4))
    axes = np.atleast_1d(axes)
    for m in range(n_tot):
        for idx in idxs:
            axes[m].plot(ys[idx, :, m], z, label=f"t={ts[idx]:.0f}s")
        if analytic is not None and m < analytic.shape[-1]:
            axes[m].plot(analytic[:, m], z, "k:", label="analytic")
        axes[m].set_xlabel(f"moment {m}")
        if m == 0:
            axes[m].set_ylabel("z [m]")
            axes[m].legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(file_name, dpi=110)
    plt.close(fig)
