"""NetCDF / npz output writers.

Port of `cloudy_tpu.utils.io` (reference test/examples/utils/
netcdf_helpers.jl:10-125, `box_output` and `rainshaft_output`): dimensions
(time, [z], dist, order, param), per-mode and summed moments, the
re-inverted distribution parameters, and the cloud/rain partition at a fixed
mass cutoff (5.236e-10 kg), written through `scipy.io.netcdf_file`
(NetCDF-3). Trajectories may be tensors on any device or arrays; they are
moved to the host, and the closure is inverted there in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from cloudy_tpu_torch import distributions as pdists
from cloudy_tpu_torch.spec import SpectrumSpec

RAIN_CUTOFF_KG = 5.236e-10  # reference netcdf_helpers.jl:104-121


def _host(a) -> np.ndarray:
    """`a` as a host array, in its own type."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _per_mode_series(spec: SpectrumSpec, ys: np.ndarray):
    """Split a flat trajectory [..., n_tot] into per-mode padded moments
    [..., n_modes, max_nprog] (nan padding)."""
    n_max = max(spec.nprogmoms)
    out = np.full(ys.shape[:-1] + (spec.n_modes, n_max), np.nan)
    for i in range(spec.n_modes):
        o, n = spec.offsets[i], spec.nprogmoms[i]
        out[..., i, :n] = ys[..., o: o + n]
    return out


def _diagnostics(spec: SpectrumSpec, ys: np.ndarray, norms, cutoff):
    """(params, partition) of a trajectory: the closure inverted on the
    normalized moments in f64, the partition at `cutoff` kg, denormalized."""
    mom_norms = np.concatenate(
        [norms[0] * norms[1] ** np.arange(n) for n in spec.nprogmoms]
    )
    params = pdists.params_from_moments(spec, torch.from_numpy(ys / mom_norms))
    nq = pdists.get_standard_N_q(spec, params, cutoff / norms[1])
    part = {
        "N_liq": nq["N_liq"].numpy() * norms[0],
        "N_rai": nq["N_rai"].numpy() * norms[0],
        "M_liq": nq["M_liq"].numpy() * norms[0] * norms[1],
        "M_rai": nq["M_rai"].numpy() * norms[0] * norms[1],
    }
    return params.numpy(), part


def _write(path: str, dims, variables) -> None:
    """A NetCDF-3 file of f64 variables: `dims` {name: size} in order,
    `variables` [(name, dims, data)]."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as f:
        for name, size in dims.items():
            f.createDimension(name, size)
        for name, vdims, data in variables:
            v = f.createVariable(name, "d", vdims)
            v[:] = np.asarray(data, dtype=np.float64)


def box_output(path: str, spec: SpectrumSpec, ts, ys, norms=(1e6, 1e-9),
               cutoff: float = RAIN_CUTOFF_KG):
    """Write a 0-D box trajectory ``[n_t, n_tot]`` (reference `box_output`)."""
    ts, ys = _host(ts), _host(ys)
    per_mode = _per_mode_series(spec, ys)
    params, part = _diagnostics(spec, ys, norms, cutoff)
    _write(path, {"time": ts.shape[0], "dist": spec.n_modes,
                  "order": max(spec.nprogmoms), "param": 3}, [
        ("time", ("time",), ts),
        ("moments", ("time", "dist", "order"), np.nan_to_num(per_mode)),
        ("moments_sum", ("time", "order"), np.nansum(per_mode, axis=-2)),
        ("params", ("time", "dist", "param"), params),
        *((k, ("time",), v) for k, v in part.items()),
    ])


def rainshaft_output(path: str, spec: SpectrumSpec, ts, z, ys, norms=(1e6, 1e-9),
                     cutoff: float = RAIN_CUTOFF_KG):
    """Write a 1-D rainshaft trajectory ``[n_t, nz, n_tot]`` (reference
    `rainshaft_output`)."""
    ts, z, ys = _host(ts), _host(z), _host(ys)
    per_mode = _per_mode_series(spec, ys)
    params, part = _diagnostics(spec, ys, norms, cutoff)
    _write(path, {"time": ts.shape[0], "z": z.shape[0], "dist": spec.n_modes,
                  "order": max(spec.nprogmoms), "param": 3}, [
        ("time", ("time",), ts),
        ("z", ("z",), z),
        ("moments", ("time", "z", "dist", "order"), np.nan_to_num(per_mode)),
        ("moments_sum", ("time", "z", "order"), np.nansum(per_mode, axis=-2)),
        ("params", ("time", "z", "dist", "param"), params),
        *((k, ("time", "z"), v) for k, v in part.items()),
    ])


def save_npz(path: str, **arrays):
    """Fast binary trajectory dump (large ensembles)."""
    np.savez_compressed(path, **{k: _host(v) for k, v in arrays.items()})


def load_npz(path: str):
    with np.load(path) as data:
        return dict(data)
