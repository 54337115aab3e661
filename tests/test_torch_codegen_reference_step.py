"""The generated reference-tier whole step (B1) and its scaled form (B1s)
compiled as host C++ (tests/_codegen_host.py: g++ through a shim that
defines the CUDA qualifiers away and runs each warp's shuffle stencil on 32
threads), on the CPU against the plain twins:

(a) the whole step over every arm of the reference tier (the fixed Simpson
    and Gauss grids, the moving Simpson grid with the Newton inverse and the
    moving Gauss grid, exact F2 on series/CF, an exponential mode, mono +
    gamma, the lognormal Φ grid with the series and the rational erf; the
    Lanczos flux in each gamma arm; the Simpson grid at 32 series/CF
    iterations too), 4 columns × 8 levels, row-scaled in
    normalized units: f64 < 1e-12, f32 < 1e-5 (the twin's operations in its
    order, without contraction; glibc's and torch's exp/log differ in the
    last bits);
(b) the scaled step at a different s per column against the scaled twin,
    and at s = 1 bit for bit the unscaled unit.

The twins are held against JAX's Pallas whole step in interpret mode by
tests/test_torch_reference_tier.py, the generated body against
`make_pallas_coal_fn` by tests/test_torch_codegen_reference.py. Host
libraries are compiled once per module.
"""

import shutil

import numpy as np
import pytest
import torch

import _codegen_host as ch
from _codegen_host import ARMS, DTYPES, HOST_TOL, arm_plans, call, row_scaled
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc

torch.set_num_threads(1)

N_COLS = 4
#: the arms whose scaled step is held too
SCALED_ARMS = ("fixed Simpson", "mono + gamma")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """`host_libs(arm)`: the arm's whole-step configurations in both types
    (``host_step_*``, ``host_scaled_*``), compiled once per module."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the generated body on the host")
    libs = {}

    def get(arm):
        if arm not in libs:
            kinds = ("step", "scaled") if arm in SCALED_ARMS else ("step",)
            libs[arm] = ch.compile_arm(tmp_path_factory.mktemp("arm"), arm, kinds)
        return libs[arm]

    return get


def column_state(plan, dtype, seed=3):
    """[n_tot, N_COLS · NZ] physical: mode j's top hat
    (`models.rainshaft.initial_condition`) from number 1e8 / 10^j and mean
    mass 1e-10 · 10^j (k = 1), the first mode's mean mass times a seeded
    factor in [0.5, 4] per column (a monodisperse mode's θ on both sides of
    T/2), a seeded amplitude per column; one negative moment and one level
    of negative moments."""
    rng = np.random.default_rng(seed)
    z = (np.arange(ch.NZ) + 0.5) * ch.DZ
    cols = []
    for f, a in zip(rng.uniform(0.5, 4.0, N_COLS), rng.uniform(0.5, 1.5, N_COLS)):
        modes = []
        for j, k in enumerate(plan.nprog):
            n, m = 1e8 / 10.0 ** j, 1e-10 * 10.0 ** j * (f if j == 0 else 1.0)
            modes.append(rs.initial_condition(z, [n, n * m, 2.0 * n * m * m])[:, :k])
        cols.append(np.concatenate(modes, axis=-1) * a)
    st = np.stack(cols)
    st[0, ch.NZ // 2, 0] *= -1.0
    st[1, ch.NZ // 2 + 1, :] = -1e-3
    return rs.to_soa(torch.as_tensor(st)).to(dtype).contiguous()


def _tag(dtype):
    return "f32" if dtype == torch.float32 else "f64"


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("arm", list(ARMS))
def test_generated_reference_step_matches_twin(host_libs, arm, dtype):
    splan, _ = arm_plans(arm)
    x = column_state(splan, dtype)
    if splan.families[0] == ch.M:
        theta = (x[1] / x[0]).double() / (splan.mom_norms[1] / splan.mom_norms[0])
        half = float(np.float32(splan.thr_const[0])) / 2
        assert bool((theta[x[0] > 0] < half).any()) and bool((theta[x[0] > 0] > half).any())
    got = call(getattr(host_libs(arm), f"host_step_{_tag(dtype)}"), x, splan.n_tot, None)
    want = fc.rainshaft_step_soa_plain(x, splan)
    assert bool(torch.isfinite(got).all())
    assert row_scaled(got, want, splan) < HOST_TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("arm", ["fixed Simpson", "mono + gamma"])
def test_generated_reference_scaled_step(host_libs, arm, dtype):
    """s from 0.4 to 2.5 by column against the scaled twin; s = 1 gives the
    unscaled unit's state bit for bit."""
    splan, _ = arm_plans(arm)
    lib = host_libs(arm)
    x = column_state(splan, dtype, seed=5)
    s_row = torch.linspace(0.4, 2.5, N_COLS, dtype=dtype).repeat_interleave(ch.NZ).contiguous()
    got = call(getattr(lib, f"host_scaled_{_tag(dtype)}"), x, splan.n_tot, s_row.data_ptr())
    want = fc.rainshaft_step_soa_plain(x, splan, s_row)
    assert row_scaled(got, want, splan) < HOST_TOL[dtype]
    ones = torch.ones_like(s_row)
    got1 = call(getattr(lib, f"host_scaled_{_tag(dtype)}"), x, splan.n_tot, ones.data_ptr())
    assert torch.equal(got1, call(getattr(lib, f"host_step_{_tag(dtype)}"), x, splan.n_tot,
                                  None))

