"""The CUDA kernels against their plain twins on the card.

These tests need a CUDA device and the CUDA toolkit; without them they skip
(marker ``cuda``). They import no jax, so they also run where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerances (row-scaled, as chip_smoke.py): f32 1e-4 and f64 1e-9 — the
kernels and the twins run the same operations in the same order; nvcc's FMA
contraction and CUDA's exp/log differ from torch's in the last bits.
"""

import numpy as np
import pytest
import torch

from cloudy_tpu_torch import bench
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

pytestmark = pytest.mark.cuda

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)
TOL = {torch.float32: 1e-4, torch.float64: 1e-9}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _fast_data(families=(Family.GAMMA, Family.GAMMA)):
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    return build_coalescence_data(SpectrumSpec(families), ker, (5e-10, np.inf),
                                  norms=NORMS, fast_tier=True)


def _row_scaled(got, want):
    d = (got.double() - want.double()).abs().amax(dim=1)
    return float((d / want.double().abs().amax(dim=1).clamp_min(1e-300)).max())


def _column_state(n_cols, nz, seed):
    z = (np.arange(nz) + 0.5) * 3000.0 / nz
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12]),
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 2)).repeat(3, axis=2)
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, nz // 2, 0] *= -1.0
    st[-1, nz // 2 + 1, :] = -1e-3
    return rs.to_soa(torch.as_tensor(st))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_coal_kernel_matches_twin(cuda, dtype):
    _, data = bench.bench_data()
    fn = fc.make_coal_fn(data, device=cuda, dtype=dtype)
    x = torch.as_tensor(bench.bench_moments(4099, seed=3).T.copy(), dtype=dtype,
                        device=cuda)  # ragged tail: 4099 % 256 != 0
    got = fn.soa(x)
    assert fn.launches == 1
    want = fn.plain(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, want) < TOL[dtype]


@pytest.mark.parametrize("nz,n_cols", [(32, 9), (16, 40), (128, 3)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_step_kernel_matches_twin(cuda, dtype, nz, n_cols):
    """Whole columns per block for several nz, with a partial last block."""
    fn = fc.make_rainshaft_step_fn(_fast_data(), VEL, NORMS, nz=nz,
                                   dz=3000.0 / nz, dt=1.0, device=cuda, dtype=dtype)
    x = _column_state(n_cols, nz, seed=nz).to(cuda, dtype)
    got = fn(x)
    assert fn.launches == 1
    want = fn.plain(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, want) < TOL[dtype]


def test_exponential_gamma_mixture_matches_twin(cuda):
    """An exponential thresholded mode exercises the other family branch."""
    data = _fast_data((Family.EXPONENTIAL, Family.GAMMA))
    fn = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                   device=cuda, dtype=torch.float64)
    z = (np.arange(32) + 0.5) * 93.75
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2]),
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    x = rs.to_soa(torch.as_tensor(np.tile(ic[None], (16, 1, 1)))).to(cuda)
    assert _row_scaled(fn(x), fn.plain(x)) < TOL[torch.float64]


def test_wrapper_raises_on_device_mismatch(cuda):
    fn = fc.make_coal_fn(_fast_data(), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="cuda"):
        fn.soa(torch.ones(6, 8, device=cuda))
