"""The port's figures (`utils.plotting`) on the CPU: each of the four
writes its PNG from tensor input (a box trajectory and a rainshaft
trajectory of the port, f64), with and without the analytic overlays; a
figure is a PNG file of more than a few bytes (matplotlib's Agg backend)."""

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import box, rainshaft as rs
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.utils import plotting

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
PNG = b"\x89PNG\r\n\x1a\n"
SPEC = SpectrumSpec((Family.GAMMA, Family.GAMMA))
KER = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)


def _png(path):
    data = path.read_bytes()
    assert data[:8] == PNG and len(data) > 1000, path
    return data


def _box():
    config = box.BoxConfig(spec=SPEC, norms=NORMS, t_end=40.0, dt=10.0)
    data = build_coalescence_data(SPEC, KER, (5e-10, np.inf), norms=NORMS)
    y0 = torch.tensor([1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16], dtype=torch.float64)
    return box.run_box(config, box.make_box_rhs(config, coal_data=data), y0)


def test_box_figures_from_tensors(tmp_path):
    ts, ys = _box()
    assert isinstance(ys, torch.Tensor)
    plotting.plot_moments(SPEC, ts, ys, tmp_path / "m.png", NORMS)
    plotting.plot_params(SPEC, ts, ys, tmp_path / "p.png", NORMS)
    plotting.plot_spectra(SPEC, ts, ys, tmp_path / "s.png", NORMS, (-12, -3))
    x = torch.logspace(-12, -3, 50, dtype=torch.float64)
    plotting.plot_spectra(SPEC, ts, ys, tmp_path / "so.png", NORMS, (-12, -3),
                          times=[0.0, 40.0], overlay=(x, 1e3 * torch.exp(-x / 1e-9)))
    for name in ("m", "p", "s", "so"):
        _png(tmp_path / f"{name}.png")


def test_rainshaft_figure_from_tensors(tmp_path):
    spec = SpectrumSpec((Family.GAMMA,))
    config = rs.RainshaftConfig(spec=spec, nz=16, zmax=3000.0, norms=NORMS, t_end=4.0, dt=1.0)
    data = build_coalescence_data(spec, KER, (np.inf,), norms=NORMS)
    ic = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ts, ys = rs.run_rainshaft(config, rs.make_rainshaft_rhs(config, data), ic, device="cpu")
    assert tuple(ys.shape) == (5, 16, 3)
    plotting.plot_rainshaft_results(spec, ts, torch.as_tensor(config.z), ys,
                                    tmp_path / "r.png", NORMS)
    plotting.plot_rainshaft_results(spec, ts, config.z, ys, tmp_path / "ra.png", NORMS,
                                    analytic=ys[-1] * 0.9)
    assert _png(tmp_path / "r.png") != _png(tmp_path / "ra.png")
