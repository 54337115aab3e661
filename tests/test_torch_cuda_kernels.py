"""The CUDA kernels against their plain twins on the card.

These tests need a CUDA device and the CUDA toolkit; without them they skip
(marker ``cuda``). They import no jax, so they also run where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerances (row-scaled, as chip_smoke.py): f32 1e-4 and f64 1e-9 — the
kernels and the twins run the same operations in the same order; nvcc's FMA
contraction and CUDA's exp/log differ from torch's in the last bits. The
quadrature kernel sums its nodes in another order than the twin's
`torch.sum` and its assembly subtracts sums of like size: f32 1e-3 there.
The chain kernels (B6) are compared per element, relative: f32 1e-5, f64
1e-12; the f32 lgamma chains, whose links cancel, against the f64 twin at
2e-5.
"""

import numpy as np
import pytest
import torch

from cloudy_tpu_torch import bench, harness
from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.ops import op_chains
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import longhorizon, traced_kernels
from cloudy_tpu_torch.utils import checkpoint as ck

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


@pytest.fixture(scope="module", autouse=True)
def _generated_units():
    """On a card, build the generated kernels this module launches in one
    batch (one nvcc each, all at once) instead of one by one at first use."""
    if not torch.cuda.is_available():
        return
    from cloudy_tpu_torch.ops import _build

    fns = []
    for variant in ("fixed2gamma", "moving", "lognorm"):
        _, data = harness.pod_data(variant)
        for dtype in DTYPES:
            for nz in (32, 16, 128):
                fns.append(fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=nz, dz=3000.0 / nz,
                                                     dt=1.0, device="cuda", dtype=dtype))
            fns.append(fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device="cuda", dtype=dtype))
            fns.append(fc.make_coal_fn(data, device="cuda", dtype=dtype))
    for dtype in DTYPES:
        fns.append(fc.make_coal_fn(bench.bench_data()[1], device="cuda", dtype=dtype))
    fns.append(fc.make_rainshaft_step_fn(_fast_data((Family.EXPONENTIAL, Family.GAMMA)), VEL,
                                         NORMS, nz=32, dz=93.75, dt=1.0, device="cuda",
                                         dtype=torch.float64))
    for dtype in DTYPES:
        fns += _four_mode_fns("cuda", dtype, fast=True) + _four_mode_fns("cuda", dtype, fast=False)
        fns.append(nc.make_numerical_fn(SpectrumSpec((Family.GAMMA,) * 4), NUM_KERNELS["long"],
                                        64, 32, device="cuda", dtype=dtype))
        fns += [nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), kf, 64, 32, device="cuda",
                                     dtype=dtype) for kf in _traced_kernels().values()]
        for variant in ("fixed2gamma", "moving", "lognorm"):
            _, data = harness.pod_data(variant)
            fns.append(fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                                 device="cuda", dtype=dtype, kernel_scale=True))
    for nz in longhorizon.DEPTHS.values():
        fns += list(longhorizon.make_steps(nz, "cuda"))
    fns += _reference_fns("cuda")
    _build.build_generated([u for f in fns for u in f.build_units()])


def _fast_data(families=(Family.GAMMA, Family.GAMMA)):
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    return build_coalescence_data(SpectrumSpec(families), ker, (5e-10, np.inf),
                                  norms=NORMS, fast_tier=True)


def _row_scaled(got, want, cancelling=()):
    """max over rows of |got - want| over the row's max |want|. A row in
    `cancelling` is zero in exact arithmetic (a lone mode's mass tendency:
    what is left of two sums of like size), so its own values are no scale:
    it takes the geometric mean of its neighbours', the size of those sums."""
    d = (got.double() - want.double()).abs().amax(dim=1)
    scale = want.double().abs().amax(dim=1).clamp_min(1e-300)
    for r in cancelling:
        scale[r] = (scale[r - 1] * scale[r + 1]).sqrt()
    return float((d / scale).max())


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


def _variant_moments(variant, n, seed):
    """Normalized moments [n_tot, n] drawn as parameters first (lognormal
    μ ∈ [−2, 0.5], σ ∈ [0.3, 1.2]; gamma θ ∈ [0.05, 5], k ∈ [0.5, 5])."""
    spec, _ = harness.pod_data(variant)
    rng = np.random.default_rng(seed)
    cols = []
    for fam in spec.families:
        p1, p2 = ((-2.0, 0.5), (0.3, 1.2)) if fam == Family.LOGNORMAL else ((0.05, 5.0), (0.5, 5.0))
        cols.append(np.stack([rng.uniform(10, 200, n), rng.uniform(*p1, n),
                              rng.uniform(*p2, n)], -1))
    return pd.get_moments(spec, torch.tensor(np.stack(cols, 1))).T.contiguous()


@pytest.mark.parametrize("variant", ["moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_coal_kernel_arms_match_twin(cuda, dtype, variant):
    _, data = harness.pod_data(variant)
    fn = fc.make_coal_fn(data, device=cuda, dtype=dtype)
    x = _variant_moments(variant, 4099, seed=5).to(cuda, dtype)
    got = fn.soa(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x)) < TOL[dtype]


@pytest.mark.parametrize("variant", ["moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_step_kernel_arms_match_twin(cuda, dtype, variant):
    _, data = harness.pod_data(variant)
    fn = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                   device=cuda, dtype=dtype)
    x = _column_state(9, 32, seed=7).to(cuda, dtype)
    got = fn(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x)) < TOL[dtype]


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_scaled_step_kernel_matches_twin(cuda, dtype, variant):
    """B1s: a different kernel scale per column (and a partial last block),
    both kernel instances (`fixed2gamma` kArms = false, the others true)."""
    _, data = harness.pod_data(variant)
    fn = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                   device=cuda, dtype=dtype, kernel_scale=True)
    x = _column_state(9, 32, seed=11).to(cuda, dtype)
    s = torch.linspace(0.4, 2.5, 9, dtype=dtype, device=cuda).repeat_interleave(32)
    got = fn(x, s)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x, s)) < TOL[dtype]
    unscaled = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                         device=cuda, dtype=dtype)(x)
    assert _row_scaled(unscaled, got) > 1e-3  # the scale acts


def test_scaled_step_kernel_equals_scaled_tensor(cuda):
    """B1s at s = 1.7 (a number, broadcast) against B1 built from the
    1.7-scaled kernel tensor, f64 (tests/test_pallas.py:659-703)."""
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data_s = build_coalescence_data(SpectrumSpec((Family.GAMMA, Family.GAMMA)),
                                    K.CoalescenceTensor(1.7 * ker.array), (5e-10, np.inf),
                                    norms=NORMS, fast_tier=True)
    kw = dict(nz=32, dz=93.75, dt=1.0, device=cuda, dtype=torch.float64)
    scaled = fc.make_rainshaft_step_fn(_fast_data(), VEL, NORMS, kernel_scale=True, **kw)
    x = _column_state(9, 32, seed=12).to(cuda, torch.float64)
    want = fc.make_rainshaft_step_fn(data_s, VEL, NORMS, **kw)(x)
    assert _row_scaled(scaled(x, 1.7), want) < TOL[torch.float64]


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_rhs_kernel_matches_twin(cuda, dtype, variant):
    """The fused per-level RHS: [coal; flux] rows, a ragged last block."""
    _, data = harness.pod_data(variant)
    fn = fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device=cuda, dtype=dtype)
    x = _column_state(9, 31, seed=9).to(cuda, dtype)  # 279 lanes
    got = fn.soa(x)
    assert fn.launches == 1 and got.shape == (12, x.shape[1])
    assert bool(torch.isfinite(got).all())
    norm = torch.tensor(fn.plan.mom_norms * 2, dtype=dtype, device=cuda)[:, None]
    assert _row_scaled(got / norm, fn.plain(x) / norm) < TOL[dtype]


# --------------------------------------------------------------------------
# the whole step and the fused RHS generated per configuration (ops.codegen)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nz,n_cols", [(32, 9), (16, 40), (128, 3)],
                         ids=["shuffle-32", "shuffle-16", "smem-128"])
@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generated_step_matches_twin(cuda, dtype, variant, nz, n_cols):
    """The generated whole step at nz 32 and 16 (the z-stencil a warp
    shuffle) and 128 (shared memory), each with a ragged last block (288,
    640 and 384 lanes in blocks of 256)."""
    _, data = harness.pod_data(variant)
    fn = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=nz, dz=3000.0 / nz, dt=1.0,
                                   device=cuda, dtype=dtype)
    assert fn.route == "generated" and fn.unit.shfl == (nz <= 32)
    x = _column_state(n_cols, nz, seed=nz + 1).to(cuda, dtype)
    got = fn(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x)) < TOL[dtype]


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generated_rhs_matches_twin(cuda, dtype, variant):
    """The generated fused RHS, 279 lanes (a ragged last block), and the
    table-driven fast instance on the same input."""
    _, data = harness.pod_data(variant)
    fn = fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device=cuda, dtype=dtype)
    table = fc.RainshaftRhsFn(fn.plan, cuda, dtype, _table=True)
    assert (fn.route, table.route) == ("generated", "table")
    x = _column_state(9, 31, seed=10).to(cuda, dtype)
    got = fn.soa(x)
    assert fn.launches == 1 and got.shape == (12, x.shape[1])
    assert bool(torch.isfinite(got).all())
    norm = torch.tensor(fn.plan.mom_norms * 2, dtype=dtype, device=cuda)[:, None]
    want = fn.plain(x) / norm
    assert _row_scaled(got / norm, want) < TOL[dtype]
    assert _row_scaled(table.soa(x) / norm, want) < TOL[dtype]


def test_routes_on_the_card(cuda):
    """The whole step and the fused RHS launch the kernel generated for the
    plan at either tier; each wrapper counts its own launches."""
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    ref = build_coalescence_data(SpectrumSpec((Family.GAMMA, Family.GAMMA)), ker,
                                 (5e-10, np.inf), norms=NORMS)
    kw = dict(nz=32, dz=93.75, dt=1.0, device=cuda, dtype=torch.float32)
    fast_step = fc.make_rainshaft_step_fn(_fast_data(), VEL, NORMS, **kw)
    ref_step = fc.make_rainshaft_step_fn(ref, VEL, NORMS, **kw)
    fast_rhs = fc.make_rainshaft_rhs_fn(_fast_data(), VEL, NORMS, device=cuda)
    ref_rhs = fc.make_rainshaft_rhs_fn(ref, VEL, NORMS, device=cuda)
    assert [f.route for f in (fast_step, ref_step, fast_rhs, ref_rhs)] == ["generated"] * 4
    assert "kRef = true" in ref_step.unit.cfg and "kRef = false" in fast_step.unit.cfg
    x = _column_state(4, 32, seed=11).to(cuda, torch.float32)
    for f in (fast_step, ref_step):
        assert _row_scaled(f(x), f.plain(x)) < TOL[torch.float32]
    for f in (fast_rhs, ref_rhs):
        assert f.soa(x).shape == (12, x.shape[1])
    assert [f.launches for f in (fast_step, ref_step, fast_rhs, ref_rhs)] == [1, 1, 1, 1]


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generated_coal_matches_twin(cuda, dtype, variant):
    """B3's generated kernel (route "generated") and its table-driven fast
    instance (`_table`) against the twin, 4,099 boxes (a ragged last block)."""
    _, data = harness.pod_data(variant)
    fn = fc.make_coal_fn(data, device=cuda, dtype=dtype)
    table = fc.CoalFn(fn.plan, cuda, dtype, _table=True)
    assert (fn.route, fn.unit.kind, table.route) == ("generated", "coal", "table")
    x = torch.as_tensor(_variant_moments(variant, 4099, seed=12), dtype=dtype, device=cuda)
    got = fn.soa(x)
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    want = fn.plain(x)
    assert _row_scaled(got, want) < TOL[dtype]
    assert _row_scaled(table.soa(x), want) < TOL[dtype]


@pytest.mark.parametrize("n_box", [128, 1024])
@pytest.mark.parametrize("case", ["bench_grid_gl", "exp_gamma", "fixed_gauss",
                                  "fixed_simpson", "moving_gauss", "moving_simpson"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_reference_coal_warp_per_box_matches_twin(cuda, dtype, case, n_box):
    """B3's reference tier with a warp per box (the layout the wrapper takes
    at these batches) against the twin and against a thread per box; two
    launches agree bit for bit."""
    bkw, ckw = REF_CASES[case]
    data = _ref_data(**bkw)
    fn = fc.make_coal_fn(data, device=cuda, dtype=dtype, **ckw)
    thread = fc.CoalFn(fn.plan, cuda, dtype, _layout="thread")
    assert fn.layout(n_box) == "warp" and thread.layout(n_box) == "thread"
    x = _param_moments(data.spec.families, n_box, seed=8).to(cuda, dtype)
    x[:, 5] = 0.0  # an empty box
    got = fn.soa(x)
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    assert bool((got[:, 5] == 0).all())
    assert torch.equal(got, fn.soa(x))
    want = fn.plain(x)
    assert _row_scaled(got, want) < TOL[dtype]
    assert _row_scaled(thread.soa(x), want) < TOL[dtype]


# --------------------------------------------------------------------------
# the direct-quadrature kernel
# --------------------------------------------------------------------------

NUM_TOL = {torch.float32: 1e-3, torch.float64: 1e-9}
NUM_KERNELS = {
    "linear": K.LinearKernelFunction(5e-3),
    "constant": K.ConstantKernelFunction(1e-3),
    "long": K.LongKernelFunction(2.0, 1e-3, 5e-3),
    "hydro": K.HydrodynamicKernelFunction(1e-2),
}
TWO_GAMMA = (Family.GAMMA, Family.GAMMA)
THREE_MODE = (Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL)


def _numerical_moments(families, n, seed):
    """Normalized moments [n_tot, n], parameters drawn first
    (tests/test_pallas_numerical.py:16-29)."""
    rng = np.random.default_rng(seed)
    cols = []
    for fam in families:
        p1, p2 = ((-1.0, 1.0), (0.3, 1.0)) if fam == Family.LOGNORMAL else ((0.05, 5.0), (0.5, 5.0))
        cols.append(np.stack([rng.uniform(10, 200, n), rng.uniform(*p1, n),
                              rng.uniform(*p2, n)], -1))
    spec = SpectrumSpec(families)
    return pd.get_moments(spec, torch.tensor(np.stack(cols, 1))).T.contiguous()


@pytest.mark.parametrize("families,kname", [
    (TWO_GAMMA, "linear"), (TWO_GAMMA, "constant"), (TWO_GAMMA, "long"),
    (TWO_GAMMA, "hydro"), (THREE_MODE, "long"),
    ((Family.MONODISPERSE, Family.GAMMA), "linear"),
    ((Family.GAMMA,), "long"), ((Family.GAMMA,), "linear")],
    ids=["linear", "constant", "long", "hydro", "three_mode_long", "mono_gamma",
         "one_mode_long", "one_mode_linear"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_numerical_kernel_matches_twin(cuda, dtype, families, kname):
    spec = SpectrumSpec(families)
    fn = nc.make_numerical_fn(spec, NUM_KERNELS[kname], 64, 32, device=cuda, dtype=dtype)
    x = _numerical_moments(families, 131, seed=5).to(cuda, dtype)
    x[:, 7] = 0.0  # an empty box
    if spec.n_modes > 1:
        x[spec.offsets[1]:, 9] = 0.0  # a box with only its first mode
    got = fn.soa(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all()) and bool((got[:, 7] == 0).all())
    cancelling = (1,) if spec.n_modes == 1 else ()  # a lone mode keeps its mass
    assert _row_scaled(got, fn.plain(x), cancelling) < NUM_TOL[dtype]
    assert torch.equal(got, fn.soa(x))  # fixed summation order: bit for bit
    assert torch.equal(fn(x.T.contiguous()), got.T)


class _ScaledLinear(K.LinearKernelFunction):
    """A subclass of a tagged class with a K(x, y) of its own (traced)."""

    def __call__(self, x, y):
        return 2.0 * super().__call__(x, y) + self.coll_coal_rate * x * y


def _traced_kernels():
    """The kernel functions of B5's generated arm (KT_GEN): the Long kernel
    fitted as a tensor (order 2, normalized), a torch lambda, a subclass,
    a separable term that changes sign ((x − 1)(y − 1), its block sums of
    both signs), and `tools.traced_kernels`' collection efficiency, the
    unit that calls the arithmetic, trigonometric, error, rounding and
    modulus forms (`coverage`), the one that calls the special functions,
    closed forms, masks and cleanups (`special`) and the one that calls
    `torch.nn.functional`'s activations (`activations`)."""
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    return {
        "tensor": K.CoalescenceTensor.from_function(kf, 2, 5e-10).normalized(NORMS),
        "lambda": lambda x, y: 1e-3 * (x * x + y * y) + 1e-4 * torch.sqrt(x * y),
        "subclass": _ScaledLinear(5e-3),
        "sign": lambda x, y: 1e-3 * (x + y) + 1e-4 * (x - 1.0) * (y - 1.0),
        **traced_kernels.KERNELS,
    }


@pytest.mark.parametrize("kname", ["tensor", "lambda", "subclass", "sign", "efficiency",
                                   "coverage", "special", "activations"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_traced_kernel_function_matches_twin(cuda, dtype, kname):
    """B5 with a kernel function traced into its generated unit against the
    twin on the CPU, which calls the callable itself: the reference
    semantics (torch's CUDA hardsigmoid and hardswish multiply by a float
    one sixth where its CPU kernels, and JAX's, divide by 6)."""
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), _traced_kernels()[kname], 64, 32,
                              device=cuda, dtype=dtype)
    assert fn.plan.ktag == nc.KT_GEN and fn.unit is not None
    x = _numerical_moments(TWO_GAMMA, 131, seed=5).to(cuda, dtype)
    x[:, 7] = 0.0
    got = fn.soa(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all()) and bool((got[:, 7] == 0).all())
    assert _row_scaled(got.cpu(), fn.plain(x.cpu())) < NUM_TOL[dtype]
    assert torch.equal(got, fn.soa(x))


@pytest.mark.parametrize("families,kname", [
    (TWO_GAMMA, "linear"), (TWO_GAMMA, "constant"), (TWO_GAMMA, "long"),
    (TWO_GAMMA, "hydro"), (THREE_MODE, "long")],
    ids=["linear", "constant", "long", "hydro", "three_mode_long"])
def test_numerical_kernel_against_its_yardstick_and_f64(cuda, families, kname):
    """`quad_kernel` and the body it replaced (`_direct`) against the twin;
    the f32 kernel against the f64 twin."""
    spec = SpectrumSpec(families)
    x = _numerical_moments(families, 131, seed=6).to(cuda)
    want64 = nc.numerical_soa_plain(x, nc.build_plan(spec, NUM_KERNELS[kname], 64, 32))
    for dtype in DTYPES:
        fn = nc.make_numerical_fn(spec, NUM_KERNELS[kname], 64, 32, device=cuda, dtype=dtype)
        direct = nc.NumericalFn(fn.plan, cuda, dtype, _direct=True)
        xt = x.to(dtype)
        want = fn.plain(xt)
        got = fn.soa(xt)
        assert _row_scaled(got, want) < NUM_TOL[dtype]
        assert _row_scaled(direct.soa(xt), want) < NUM_TOL[dtype]
        assert _row_scaled(got, want64) < NUM_TOL[torch.float32]


def test_numerical_kernel_matches_einsum_path_at_box_nodes(cuda):
    """One launch at the box model's (256, 96) budgets (3 x 85 outer nodes,
    256 threads) on the numerical box's initial state, against the einsum
    path on the card."""
    from cloudy_tpu_torch import coalescence_numerical as cn
    from cloudy_tpu_torch.spec import get_moments_normalizing_factors

    spec = SpectrumSpec(TWO_GAMMA)
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(NORMS)
    norm = np.asarray(get_moments_normalizing_factors(spec.nprogmoms, NORMS))
    mom = torch.tensor(np.array([1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13]) / norm,
                       device=cuda)[:, None].contiguous()
    fn = nc.make_numerical_fn(spec, kf, 256, 96, device=cuda, dtype=torch.float64)
    assert fn.plan.g_total == 255
    got = fn.soa(mom)[:, 0]
    want = cn.get_coal_ints_numerical(spec, pd.params_from_moments(spec, mom.T), kf)[0]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-8,
                               atol=1e-13 * float(want.abs().max()))


def test_numerical_bench_shape_matches_twin(cuda):
    """The bench configuration (Long kernel, 3 x 32 and 3 x 16 nodes, f32) on
    a slice of the bench state, the twin in chunks."""
    fn = bench.numerical_fn(cuda)
    x = torch.as_tensor(bench.numerical_moments(4099).T.copy(), dtype=torch.float32,
                        device=cuda)
    got = fn.soa(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x, chunk=1024)) < NUM_TOL[torch.float32]


# --------------------------------------------------------------------------
# the reference tier (quadrature-grid F2, series/CF, Newton inverse)
# --------------------------------------------------------------------------


def _ref_data(families=(Family.GAMMA, Family.GAMMA), moving=False, **kw):
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    thresholds = (0.9, 1.0) if moving else (5e-10, np.inf)
    return build_coalescence_data(SpectrumSpec(families), ker, thresholds, norms=NORMS,
                                  moving=moving, **kw)


def _param_moments(families, n, seed):
    """Normalized moments [n_tot, n] from parameters drawn first: moving
    thresholds on both sides of T = 1."""
    rng = np.random.default_rng(seed)
    par = np.stack([np.stack([rng.uniform(10, 200, n), rng.uniform(0.05, 5.0, n),
                              rng.uniform(0.5, 5.0, n)], -1) for _ in families], axis=1)
    return pd.get_moments(SpectrumSpec(families), torch.as_tensor(par)).T.contiguous()


REF_CASES = {
    "fixed_simpson": ({}, {}),
    "fixed_gauss": ({}, {"quad_rule": "gauss"}),
    "moving_simpson": ({"moving": True}, {}),
    "moving_gauss": ({"moving": True}, {"quad_rule": "gauss"}),
    "exact_series_cf": ({"f2_exact": True}, {}),
    "exp_gamma": ({"families": (Family.EXPONENTIAL, Family.GAMMA)}, {}),
    "bench_grid_gl": ({"gammainc_iters": 12, "gammainc_gl_nodes": 12},
                      {"quad_rule": "gauss", "gauss_nodes": 12, "gammainc_iters": 12}),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_reference_coal_kernel_matches_twin(cuda, dtype, case):
    """B3's reference-tier instance against its twin, 4,099 boxes."""
    bkw, ckw = REF_CASES[case]
    data = _ref_data(**bkw)
    fn = fc.make_coal_fn(data, device=cuda, dtype=dtype, **ckw)
    assert fn.plan.instance == 2
    x = _param_moments(data.spec.families, 4099, seed=7).to(cuda, dtype)
    got = fn.soa(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x)) < TOL[dtype]


@pytest.mark.parametrize("moving", [False, True], ids=["fixed", "moving"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_reference_step_and_rhs_kernels_match_twins(cuda, dtype, moving):
    """B1's and B4's reference tier (series/CF, Lanczos flux), generated
    for the plan, against their twins, 9 columns × 32 levels."""
    data = _ref_data(moving=moving)
    step = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                     device=cuda, dtype=dtype)
    rhs = fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device=cuda, dtype=dtype)
    assert step.plan.instance == 2 and rhs.plan.instance == 2
    assert step.route == rhs.route == "generated"
    x = _column_state(9, 32, seed=4).to(cuda, dtype)
    norm = torch.tensor(step.plan.mom_norms, dtype=dtype, device=cuda)[:, None]
    got = step(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got / norm, step.plain(x) / norm) < TOL[dtype]
    norm2 = torch.cat([norm, norm])
    got = rhs.soa(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got / norm2, rhs.plain(x) / norm2) < TOL[dtype]


def test_moving_bins_on_the_card_match_the_twin(cuda):
    """The moving Simpson grid's bin count sits on an integer (75 for every
    T ≤ 1): the card's division, log and floor give the twin's count at the
    ratios next to 1e5."""
    for dtype in DTYPES:
        t = torch.logspace(-6, 0, 20001, dtype=torch.float64).to(dtype)
        assert bool((fc.moving_bins(t.to(cuda)).cpu() == fc.moving_bins(t)).all())


def test_rainshaft_128_hook_through_kernel_matches_golden(cuda):
    """`rainshaft_128` through B3's reference-tier instance on the card
    (f64, 30 steps) against its golden's first saved frame."""
    from _golden_cases import load_golden

    ys, report = harness.run_scenario("rainshaft_128", device=cuda, hook=True, t_end=30.0)
    assert report["launches"] == 90
    _, ys_g = load_golden("rainshaft_128")
    scale = np.abs(ys_g).max(axis=(0, 1))
    assert (np.abs(ys.cpu().numpy() - ys_g[:2]) / scale).max() < 1e-6


# --------------------------------------------------------------------------
# the monodisperse and lognormal-Φ-grid arms (reference-tier instance)
# --------------------------------------------------------------------------

#: name: (families, thresholds, moving, build kwargs, call kwargs)
ARM_CASES = {
    "mono_gamma_fixed": ((Family.MONODISPERSE, Family.GAMMA), (5e-10, np.inf), False, {}, {}),
    "mono_gamma_moving": ((Family.MONODISPERSE, Family.GAMMA), (0.9, 1.0), True, {}, {}),
    "gamma_mono_last": ((Family.GAMMA, Family.MONODISPERSE), (5e-10, np.inf), False, {}, {}),
    "lognorm_simpson_series": ((Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf), False,
                               {}, {}),
    "lognorm_gauss_approx": ((Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf), False,
                             {"gammainc_gl_nodes": 12}, {"quad_rule": "gauss",
                                                         "gauss_nodes": 12}),
    "lognorm_moving_simpson": ((Family.LOGNORMAL, Family.GAMMA), (0.9, 1.0), True, {}, {}),
    "lognorm_moving_gauss": ((Family.LOGNORMAL, Family.GAMMA), (0.9, 1.0), True,
                             {"gammainc_gl_nodes": 12}, {"quad_rule": "gauss",
                                                         "gauss_nodes": 12}),
    "exp_lognorm_gamma": ((Family.EXPONENTIAL, Family.LOGNORMAL, Family.GAMMA),
                          (2e-10, 5e-10, np.inf), False, {}, {}),
}


def _arm_moments(families, n, seed):
    """Normalized moments [n_tot, n] from parameters drawn first: lognormal
    (μ, σ), monodisperse θ on both sides of T/2 = 0.25, exponential θ,
    gamma (θ, k)."""
    rng = np.random.default_rng(seed)
    ranges = {Family.GAMMA: ((0.05, 5.0), (0.5, 5.0)),
              Family.LOGNORMAL: ((-2.0, 0.5), (0.3, 1.2)),
              Family.MONODISPERSE: ((0.05, 0.6), (0.0, 0.0)),
              Family.EXPONENTIAL: ((0.02, 0.5), (0.0, 0.0))}
    par = np.stack([np.stack([rng.uniform(10, 200, n), rng.uniform(*ranges[f][0], n),
                              rng.uniform(*ranges[f][1], n)], -1) for f in families], axis=1)
    return pd.get_moments(SpectrumSpec(families), torch.as_tensor(par)).T.contiguous()


@pytest.mark.parametrize("case", sorted(ARM_CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_arm_coal_kernel_matches_twin(cuda, dtype, case):
    """B3's reference-tier instance through the monodisperse and lognormal
    Φ-grid arms against its twin, 4,099 boxes."""
    fams, thr, moving, bkw, ckw = ARM_CASES[case]
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(SpectrumSpec(fams), ker, thr, norms=NORMS, moving=moving,
                                  **bkw)
    fn = fc.make_coal_fn(data, device=cuda, dtype=dtype, **ckw)
    assert fn.plan.instance == 2
    x = _arm_moments(fams, 4099, seed=9).to(cuda, dtype)
    got = fn.soa(x)
    assert fn.launches == 1
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x)) < TOL[dtype]


@pytest.mark.parametrize("name", ["mono-gamma-closed", "lognorm-gamma-grid"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_arm_step_and_rhs_kernels_match_twins(cuda, dtype, name):
    """B1 and B4 at the family matrix's two reference-tier cases against
    their twins, 9 columns × 32 levels: the case's mode-1 pulse with a seeded
    gamma mode 2, per-column amplitudes (as chip_smoke.py's phase 20). From
    the bare pulse a few steps leave mode 2 with moments of rounding size,
    whose tendencies are rounding noise in relative terms; a seeded mode 2
    keeps every row's values resolved."""
    from cloudy_tpu_torch.tools import whole_step_ablation as wsa

    config, step = wsa.build_case(name, 32, cuda, dtype)
    data, kw = wsa.case_data(name)
    rhs = fc.make_rainshaft_rhs_fn(data, config.vel, NORMS, device=cuda, dtype=dtype, **kw)
    assert step.plan.instance == 2 and rhs.plan.instance == 2
    n1 = config.spec.nprogmoms[0]
    ic = np.concatenate([rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])[:, :n1],
                         rs.initial_condition(config.z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(2).uniform(0.5, 1.5, (9, 1, 1))
    x = rs.to_soa(torch.as_tensor(np.tile(ic[None], (9, 1, 1)) * amp)).to(cuda, dtype)
    norm = torch.tensor(step.plan.mom_norms, dtype=dtype, device=cuda)[:, None]
    got = step(x)
    assert step.launches == 1 and bool(torch.isfinite(got).all())
    assert _row_scaled(got / norm, step.plain(x) / norm) < TOL[dtype]
    norm2 = torch.cat([norm, norm])
    got = rhs.soa(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got / norm2, rhs.plain(x) / norm2) < TOL[dtype]



@pytest.mark.parametrize("name", list(op_chains.CHAINS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_chain_kernel_matches_twin(cuda, dtype, name):
    """Each B6 chain kernel against its twin at the chain's K1 links, ILP 8
    over 4,099 columns (a ragged last block), relative per element: f64
    1e-12, f32 1e-5; the f32 kernel of a cancelling chain (lgamma,
    lgamma_stirling) against the f64 twin at 2e-5
    (`tools.op_microbench.compare`)."""
    from cloudy_tpu_torch.tools import op_microbench as om

    x = om.inputs(8, 4099, dtype, cuda, seed=4)
    fn = op_chains.chain_kernel(name, dtype)
    before = fn.launches
    rec = om.compare(name, dtype, x)  # raises above the tolerance
    assert fn.launches == before + 1
    if dtype == torch.float32 and name in om.CANCELLING:
        assert rec["vs"] == "f64 twin" and rec["f64_rel_err"] <= om.TOL_CANCELLING == 2e-5
    else:
        assert rec["vs"] == "twin" and rec["max_rel_err"] <= om.TOL[dtype]
    got = op_chains.chain_kernel(name, dtype)(x, 0)
    assert torch.equal(got, x)  # zero links copy the input


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_mul_chain_above_the_floor(cuda, dtype):
    """The mul chain's time per element per link, at the tool's sizes,
    cannot read below one instruction per lane and clock on every SM."""
    from cloudy_tpu_torch.tools import op_microbench as om

    fn = op_chains.chain_kernel("mul", dtype)
    x = om.inputs(8, om.columns(fn, cuda), dtype, cuda)
    rec = om.measure("mul", dtype, x, reps=3)
    assert rec["k2_ms"] >= om.MIN_K2_MS
    assert rec["sec_per_elem_link"] >= om.floor_sec(dtype, cuda)


# --------------------------------------------------------------------------
# past the prebuilt capacities (four gamma modes), the scaled whole step on
# the generated body and at the reference tier, B5's strided outer nodes
# --------------------------------------------------------------------------


def _four_mode_fns(device, dtype, fast=True, kernel_scale=False):
    """[coal, rhs, step, scaled step] of the four-gamma-mode configuration
    (tests/_four_modes_reference.py) at 8 levels."""
    import _four_modes_reference as ref

    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(SpectrumSpec((Family.GAMMA,) * 4), ker, ref.THR4,
                                  norms=NORMS, fast_tier=fast)
    kw = dict(device=device, dtype=dtype)
    sk = dict(nz=ref.NZ, dz=ref.DZ, dt=1.0, **kw)
    return [fc.make_coal_fn(data, **kw), fc.make_rainshaft_rhs_fn(data, VEL, NORMS, **kw),
            fc.make_rainshaft_step_fn(data, VEL, NORMS, **sk),
            fc.make_rainshaft_step_fn(data, VEL, NORMS, kernel_scale=True, **sk)]


@pytest.mark.parametrize("fast", [True, False], ids=["generated", "reference_unit"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_four_mode_kernels_match_twins(cuda, dtype, fast):
    """Four gamma modes (n_tot 12, past the prebuilt 3 modes and 9 moments)
    through B3, B4, B1 and B1s: the fast tier's kernels generated for the
    plan at either tier, the reference tier's B3 from units built at
    capacities (4, 12, 5) in both layouts; 80 columns × 8 levels (a ragged
    last block), a different scale per column."""
    import _four_modes_reference as ref

    coal, rhs, step, scaled = _four_mode_fns(cuda, dtype, fast)
    assert {f.route for f in (rhs, step, scaled)} == {"generated"}
    assert coal.route == ("generated" if fast else "table")
    assert step.unit.n_tot == 12 and scaled.unit.scaled
    if not fast:
        assert coal.caps == (4, 12, 5) and coal.build_units()[0].kind == "ref_coal"
    x = torch.as_tensor(ref.state(80, seed=7), dtype=dtype, device=cuda)
    norm = torch.tensor(step.plan.mom_norms, dtype=dtype, device=cuda)[:, None]
    xn = (x.clamp_min(0) / norm).contiguous()
    s = torch.linspace(0.4, 2.5, 80, dtype=dtype, device=cuda).repeat_interleave(ref.NZ)
    layouts = [coal] if fast else [fc.CoalFn(coal.plan, cuda, dtype, _layout=lay)
                                   for lay in ("thread", "warp")]
    for fn in layouts:
        got = fn.soa(xn)
        assert fn.launches == 1 and bool(torch.isfinite(got).all())
        assert _row_scaled(got, fn.plain(xn)) < TOL[dtype]
    got = rhs.soa(x)
    n2 = torch.cat([norm, norm])
    assert _row_scaled(got / n2, rhs.plain(x) / n2) < TOL[dtype]
    got = step(x)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got / norm, step.plain(x) / norm) < TOL[dtype]
    got = scaled(x, s)
    assert _row_scaled(got / norm, scaled.plain(x, s) / norm) < TOL[dtype]
    assert [f.launches for f in (rhs, step, scaled)] == [1, 1, 1]


def test_four_mode_kernels_match_jax(cuda):
    """The card's kernels in f64 against JAX's outputs stored by
    tests/_four_modes_reference.py (the Pallas kernels in interpret mode,
    JAX's XLA path for the reference tier): B3, B4 and B1 generated for four
    gamma modes, the reference tier's B3 (its units) and B1 (generated), B5
    at four modes (its unit), and B1s at the reference tier (generated),
    row-scaled 1e-9."""
    import _four_modes_reference as ref

    st = ref.load()
    f64 = torch.float64
    t = {k: torch.as_tensor(v, dtype=f64, device=cuda) for k, v in st.items()}
    coal, rhs, step, _ = _four_mode_fns(cuda, f64, fast=True)
    rcoal, _, rstep, _ = _four_mode_fns(cuda, f64, fast=False)
    norm = torch.tensor(step.plan.mom_norms, dtype=f64, device=cuda)[:, None]
    n2 = torch.cat([norm, norm])
    assert _row_scaled(coal.soa(t["coal_mom"]), t["coal_fast"]) < TOL[f64]
    assert _row_scaled(rhs.soa(t["state"]) / n2, t["rhs_fast"] / n2) < TOL[f64]
    assert _row_scaled(step(t["state"]) / norm, t["step_fast"] / norm) < TOL[f64]
    assert _row_scaled(rcoal.soa(t["coal_mom"]) * norm, t["coal_ref_phys"]) < TOL[f64]
    assert _row_scaled(rstep(t["state"]) / norm, t["step_ref"] / norm) < TOL[f64]
    num = nc.make_numerical_fn(SpectrumSpec((Family.GAMMA,) * 4),
                               K.LinearKernelFunction(5.0).normalized(NORMS), **ref.NUM_NODES,
                               device=cuda, dtype=f64)
    assert num.unit is not None
    assert _row_scaled(num.soa(t["num_mom"]), t["num"]) < NUM_TOL[f64]
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    two = build_coalescence_data(SpectrumSpec(TWO_GAMMA), ker, ref.THR2, norms=NORMS)
    scaled = fc.make_rainshaft_step_fn(two, VEL, NORMS, nz=ref.NZ, dz=ref.DZ, dt=1.0,
                                       device=cuda, dtype=f64, kernel_scale=True,
                                       gammainc_iters=ref.SCALED_REF_ITERS)
    assert scaled.plan.instance == 2 and scaled.route == "generated" and scaled.unit.scaled
    got = scaled(t["scaled_state"], t["scale"])
    norm2 = norm[:6]
    assert _row_scaled(got / norm2, t["scaled_ref"] / norm2) < TOL[f64]


@pytest.mark.parametrize("case", ["fixed_simpson", "moving_gauss", "exact_series_cf"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_scaled_reference_step_matches_twin(cuda, dtype, case):
    """B1s at the reference tier (the scaled unit generated for the plan)
    against its twin, a different scale per column; at s = 1.7 against the
    unscaled reference kernel built from the 1.7-scaled tensor (f64)."""
    bkw, ckw = REF_CASES[case]
    data = _ref_data(**bkw)
    kw = dict(nz=32, dz=93.75, dt=1.0, device=cuda, dtype=dtype, **ckw)
    fn = fc.make_rainshaft_step_fn(data, VEL, NORMS, kernel_scale=True, **kw)
    assert fn.plan.instance == 2 and fn.route == "generated" and fn.unit.scaled
    x = _column_state(9, 32, seed=13).to(cuda, dtype)
    s = torch.linspace(0.4, 2.5, 9, dtype=dtype, device=cuda).repeat_interleave(32)
    got = fn(x, s)
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    assert _row_scaled(got, fn.plain(x, s)) < TOL[dtype]
    if dtype == torch.float64:
        ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
        data_s = build_coalescence_data(data.spec, K.CoalescenceTensor(1.7 * ker.array),
                                        (0.9, 1.0) if bkw.get("moving") else (5e-10, np.inf),
                                        norms=NORMS, **bkw)
        want = fc.make_rainshaft_step_fn(data_s, VEL, NORMS, **kw)(x)
        assert _row_scaled(fn(x, 1.7), want) < TOL[dtype]


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generated_scaled_step_matches_table_and_twin(cuda, dtype, variant):
    """B1s on the generated body (route "generated", its own unit) against
    the twin and the table-driven B1s (`_table`) on the same input; a scaled
    unit refuses a null scale."""
    _, data = harness.pod_data(variant)
    fn = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0, device=cuda,
                                   dtype=dtype, kernel_scale=True)
    table = fc.ScaledRainshaftStepFn(fn.plan, cuda, dtype, _table=True)
    assert (fn.route, table.route) == ("generated", "table") and fn.unit.scaled
    x = _column_state(9, 32, seed=14).to(cuda, dtype)
    s = torch.linspace(0.4, 2.5, 9, dtype=dtype, device=cuda).repeat_interleave(32)
    got = fn(x, s)
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    want = fn.plain(x, s)
    assert _row_scaled(got, want) < TOL[dtype]
    assert _row_scaled(table(x, s), want) < TOL[dtype]
    from cloudy_tpu_torch.ops import _build

    lib = _build.load_generated(fn.unit)
    out = torch.empty_like(x)
    err = lib.cloudy_gen_launch(x.data_ptr(), out.data_ptr(), x.shape[1], None,
                                torch.cuda.current_stream().cuda_stream)
    assert err != 0  # cudaErrorInvalidValue: no scale row


@pytest.mark.parametrize("families,kname", [
    (TWO_GAMMA, "long"), (TWO_GAMMA, "hydro"), ((Family.GAMMA,) * 4, "long")],
    ids=["two_gamma_long", "two_gamma_hydro", "four_gamma_long"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_numerical_kernel_strided_nodes_and_modes_match_twin(cuda, dtype, families, kname):
    """B5 with more outer nodes than a block has threads (3 x 171 = 513 at
    the Long kernel, 512 otherwise: two or three passes per thread) and at
    four modes (the unit built for them), against the twin; two launches
    agree bit for bit."""
    spec = SpectrumSpec(families)
    fn = nc.make_numerical_fn(spec, NUM_KERNELS[kname], 512, 16, device=cuda, dtype=dtype)
    assert fn.plan.g_total > 256
    assert (fn.unit is not None) == (spec.n_modes > 3)
    x = _numerical_moments(families, 67, seed=15).to(cuda, dtype)
    x[:, 7] = 0.0
    got = fn.soa(x)
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    assert bool((got[:, 7] == 0).all())
    assert _row_scaled(got, fn.plain(x)) < NUM_TOL[dtype]
    assert torch.equal(got, fn.soa(x))


def test_tables_past_the_card_limit_raise(cuda):
    """A packed configuration larger than a block of the card may opt into
    (a fixed Gauss grid of 20,000 nodes: 320 KB in f64) raises, saying so;
    one that needs the opt-in (4,000 nodes, 64 KB) runs."""
    data = _ref_data()
    for nodes, fits in ((4000, True), (20000, False)):
        fn = fc.make_coal_fn(data, device=cuda, dtype=torch.float64, quad_rule="gauss",
                             gauss_nodes=nodes)
        x = _param_moments(data.spec.families, 64, seed=16).to(cuda, torch.float64)
        if fits:
            assert fc.pack_config(fn.plan, torch.float64).size > 48 * 1024
            assert _row_scaled(fn.soa(x), fn.plain(x)) < TOL[torch.float64]
        else:
            with pytest.raises(RuntimeError, match="opt"):
                fn.soa(x)


@pytest.mark.parametrize("variant", ["pod_ensemble", "pod_ensemble_moving"])
def test_pod_checkpoint_resume_on_the_card(cuda, variant, tmp_path):
    """A pod run (4,096 columns x 32 levels, f32, the generated whole step)
    cut after one 40-step segment and resumed is the uninterrupted run bit
    for bit: the state crosses the host and the file exactly, and the kernel
    is deterministic."""
    sc = harness.SCENARIOS[variant](n_columns=4096, device=cuda)
    path = str(tmp_path / "pod")
    assert sc["run_checkpointed"](path, segment=40, max_segments=1) is None
    assert ck.latest_step(path) == 40
    sc["step"].launches = 0
    y_res, seconds, clock, info = sc["run_checkpointed"](path, segment=40)
    assert sc["step"].launches == 80 and info["n_steps_run"] == 80
    assert clock == "cuda_events" and seconds > 0 and y_res.is_cuda
    y, _, _ = sc["run"]()
    assert torch.equal(y_res, y)


@pytest.mark.parametrize("nz", sorted(longhorizon.DEPTHS.values()))
def test_longhorizon_pair_matches_twins(cuda, nz):
    """100 steps of the long-horizon pair at [6, 4096]: the generated f32
    step and the f64 reference step against their twins run on the card
    over every column (f32 1e-4, f64 1e-9), and the f32 run within the JAX
    gate's bound of the f64 one."""
    fast, ref = longhorizon.make_steps(nz, cuda)
    assert fast.route == "generated" and ref.route == "generated" and ref.plan.ref
    name = {v: k for k, v in longhorizon.DEPTHS.items()}[nz]
    rec, states = longhorizon.run_depth(name, nz, fast, ref, n_steps=100)
    assert rec["launches_f32"] == rec["launches_f64"] == 100 and rec["finite"]
    assert rec["checkpoints"][-1]["traj_err_max_scaled"] < longhorizon.ERR_GATES[nz][1000]
    x0 = rs.to_soa(torch.as_tensor(longhorizon.start_state(nz)))
    for tag, fn in (("f32", fast), ("f64", ref)):
        y = x0.to(cuda, fn.dtype)
        for _ in range(100):
            y = fn.plain(y)
        got = rs.to_soa(torch.as_tensor(states[tag][-1])).to(cuda)
        assert _row_scaled(got, y) < TOL[fn.dtype], tag


# --------------------------------------------------------------------------
# the reference tier generated per configuration against the table-driven
# instances it replaced
# --------------------------------------------------------------------------

#: (reference case of `REF_CASES` or family-matrix case, kernel)
GEN_REF = [(c, k) for c in ("fixed_simpson", "moving_simpson", "moving_gauss", "exact_series_cf",
                            "exp_gamma") for k in ("step", "scaled", "rhs")]
GEN_REF += [(c, k) for c in ("mono-gamma-closed", "lognorm-gamma-grid")
            for k in ("step", "scaled", "rhs")]


def _gen_ref_pair(case, kind, device, dtype):
    """(generated, table-driven) wrappers of one reference-tier plan."""
    from cloudy_tpu_torch.tools import whole_step_ablation as wsa

    if case in REF_CASES:
        bkw, ckw = REF_CASES[case]
        data = _ref_data(**bkw)
    else:
        data, ckw = wsa.case_data(case)
    if kind == "rhs":
        gen = fc.make_rainshaft_rhs_fn(data, VEL, NORMS, device=device, dtype=dtype, **ckw)
    else:
        gen = fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                        device=device, dtype=dtype,
                                        kernel_scale=kind == "scaled", **ckw)
    return gen, type(gen)(gen.plan, device, dtype, _table=True)


def _reference_fns(device):
    return [f for dt in DTYPES for c, k in GEN_REF for f in _gen_ref_pair(c, k, device, dt)]


@pytest.mark.parametrize("case,kind", GEN_REF)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generated_reference_kernels_match_twin_and_table(cuda, dtype, case, kind):
    """B1, B1s and B4 at the reference tier, generated for the plan, against
    their twins and against the table-driven instance (`_table`) on the same
    input, 9 columns × 32 levels of two seeded modes; a monodisperse plan's
    unit carries no FMA contraction."""
    gen, table = _gen_ref_pair(case, kind, cuda, dtype)
    assert (gen.route, table.route) == ("generated", "table") and gen.plan.ref
    assert ("-fmad=false" in gen.unit.flags) == (Family.MONODISPERSE in gen.plan.families)
    n1 = gen.plan.nprog[0]
    z = (np.arange(32) + 0.5) * 93.75
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12])[:, :n1],
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(21).uniform(0.5, 1.5, (9, 1, 1))
    x = rs.to_soa(torch.as_tensor(np.tile(ic[None], (9, 1, 1)) * amp)).to(cuda, dtype)
    norm = torch.tensor(gen.plan.mom_norms, dtype=dtype, device=cuda)[:, None]
    s = torch.linspace(0.4, 2.5, 9, dtype=dtype, device=cuda).repeat_interleave(32)
    if kind == "rhs":
        norm = torch.cat([norm, norm])
        got, want, ref = gen.soa(x), gen.plain(x), table.soa(x)
    else:
        args = (x,) if kind == "step" else (x, s)
        got, want, ref = gen(*args), gen.plain(*args), table(*args)
    assert gen.launches == table.launches == 1 and bool(torch.isfinite(got).all())
    assert _row_scaled(got / norm, want / norm) < TOL[dtype]
    assert _row_scaled(got / norm, ref / norm) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_generated_mono_trajectory_is_the_twins(cuda, dtype):
    """The family matrix's `mono-gamma-closed` pulse, 128 columns × 40
    steps: the generated unit (no FMA contraction) keeps the twin's
    trajectory bit for bit, as the table-driven reference step did: the
    pulse is ill-conditioned (ROADMAP.md §C), so any other rounding would
    leave it."""
    from cloudy_tpu_torch.tools import whole_step_ablation as wsa

    config, step = wsa.build_case("mono-gamma-closed", 32, cuda, dtype)
    assert step.route == "generated" and step.unit.flags == ("-fmad=false",)
    y = yt = wsa.initial_state(config, 128, cuda, dtype)
    for _ in range(40):
        y, yt = step(y), step.plain(yt)
    assert bool(torch.isfinite(y).all()) and torch.equal(y, yt)


def test_step_timer_times_a_cuda_call_by_events(cuda):
    """`StepTimer.timed_call` on a call that returns a CUDA tensor records
    the device seconds between CUDA events around it."""
    from cloudy_tpu_torch.utils import metrics

    timer = metrics.StepTimer()
    x = torch.ones(1 << 20, device=cuda)
    for _ in range(3):
        out = timer.timed_call(lambda v: v * 2.0, x)
    assert out.is_cuda and float(out[0]) == 2.0
    assert len(timer.times) == 3 and all(0.0 < s < 1.0 for s in timer.times)
    assert timer.summary()["n"] == 3
