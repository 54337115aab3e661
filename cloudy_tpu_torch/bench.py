"""Benchmark: coalescence-RHS moment-updates/s on one CUDA device.

Port of the repository's bench.py configuration (bench.py:43-46, 62-85):
two gamma modes, Golovin kernel 5.0 fitted at order 1, fixed threshold
5e-10 kg, norms (1e6, 1e-9), exact F2 with the GL-12 incomplete gamma
(``gammainc_iters=12``), 2^20 independent boxes in the SoA layout
``[6, B]``, and the Euler relaxation chain ``m ← m + 1e-9·rhs(m)`` whose
data dependency keeps every evaluation (bench.py:103-104). The RHS is the
CUDA coalescence kernel (`ops.fused_coalescence.make_coal_fn`).

Timed with CUDA events after a warm-up; the build is outside the timed
window. Needs a CUDA device:

    python -m cloudy_tpu_torch.bench
"""

from __future__ import annotations

import json

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.ops import fused_coalescence as fc

BENCH_F2_EXACT = True
BENCH_GAMMAINC_ITERS = 12
BENCH_GL_NODES = 12
BENCH_COLUMNS = 1 << 20
BENCH_RELAX = 1e-9


def bench_data():
    """(spec, CoalescenceData) of bench.py's configuration."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=norms,
        gammainc_iters=BENCH_GAMMAINC_ITERS, f2_exact=BENCH_F2_EXACT,
        gammainc_gl_nodes=BENCH_GL_NODES,
    )
    return spec, data


def bench_moments(n_columns: int, seed: int = 0) -> np.ndarray:
    """Normalized moments ``[n_columns, 6]`` (float64) with bench.py's
    physically consistent per-column variation: joint amplitude and mass
    scalings per mode (independent per-moment noise drives the gamma k-clip
    into f32 overflow)."""
    rng = np.random.default_rng(seed)
    mom_norms = np.concatenate([1e6 * 1e-9 ** np.arange(3)] * 2)
    base = np.array([1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16]) / mom_norms
    amp = np.repeat(rng.uniform(0.5, 2.0, (n_columns, 2)), 3, axis=1)
    msc = np.repeat(rng.uniform(0.8, 1.25, (n_columns, 2)), 3, axis=1) ** np.tile(
        np.arange(3.0), 2
    )
    return base[None, :] * amp * msc


def relax_chain(rhs_soa, mom: torch.Tensor, n: int) -> torch.Tensor:
    """`n` dependent Euler relaxation steps ``m + 1e-9·rhs(m)``."""
    for _ in range(n):
        mom = mom + BENCH_RELAX * rhs_soa(mom)
    return mom


def time_chain(rhs_soa, mom: torch.Tensor, n: int, warmup: int = 3) -> float:
    """Seconds per chain step on a CUDA device (CUDA events, after
    `warmup` untimed steps)."""
    relax_chain(rhs_soa, mom, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    relax_chain(rhs_soa, mom, n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def main(n_columns: int = BENCH_COLUMNS, n_steps: int = 100):
    if not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA device: torch.cuda.is_available() is False")
    spec, data = bench_data()
    fn = fc.make_coal_fn(data, device="cuda", dtype=torch.float32)
    mom = torch.as_tensor(bench_moments(n_columns).T.copy(), dtype=torch.float32,
                          device="cuda")
    s = time_chain(fn.soa, mom, n_steps)
    print(json.dumps({
        "metric": "coalescence_moment_updates_per_s",
        "value": n_columns * spec.n_tot / s,
        "unit": "moment-updates/s",
        "device": torch.cuda.get_device_name(0),
        "n_columns": n_columns,
        "s_per_step": s,
    }))


if __name__ == "__main__":
    main()
