"""The twins' lower series stopped lane by lane
(`fused_coalescence.series_exit`: the rule of the generated reference-tier
kernels, csrc/common.cuh `gammainc_sc` with ``kExit``), on the CPU:

(a) the series sum stops each lane at the first term that leaves its sum
    as it was: the sums are the fixed loop's bit for bit, and the operations
    counted are each lane's terms up to that point (a plain Python loop
    over the same IEEE doubles says how many);
(b) the whole step and the fused RHS under the rule equal the fixed loop's,
    bit for bit, over the reference tier's series arms in f32 and f64;
(c) `tools.opcount` counts a generated reference wrapper's twin under the
    rule and the table-driven instance's at the fixed count, which is
    larger: the roofline bound of a kernel that stops early counts the work
    it does.
"""

import numpy as np
import pytest
import torch

import _codegen_host as ch
from _codegen_host import DTYPES, NORMS, arm_plans
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.ops import special
from cloudy_tpu_torch.tools import opcount, reference_tune

torch.set_num_threads(1)

#: the reference tier's arms that sum the series: the F2 grid, the Newton
#: inverse of a moving threshold, exact F2 and the series erf
SERIES_ARMS = ("fixed Simpson", "moving Simpson, Newton", "exact F2, series/CF",
               "lognormal Φ grid, series erf")


def series_terms(a, x, n_iters):
    """(sum, iterations) per lane of the lower series in Python floats
    (IEEE doubles), stopped where a term leaves the sum unchanged."""
    sums, iters = [], []
    for ai, xi in zip(a, x):
        term = 1.0 / ai
        total, ap, k = term, ai, 0
        for _ in range(n_iters):
            k += 1
            ap = ap + 1.0
            term = term * xi / ap
            nxt = total + term
            if nxt == total:
                break
            total = nxt
        sums.append(total)
        iters.append(k)
    return np.asarray(sums), np.asarray(iters)


@pytest.mark.parametrize("n_iters", [12, 128])
def test_series_sum_stops_each_lane_and_counts_its_terms(n_iters):
    """(a) on 2,000 lanes below a + 1, a ∈ [0.5, 16]."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 16.0, 2000)
    x = rng.uniform(0.0, 1.0, 2000) * (a + 1.0)
    at, xt = torch.as_tensor(a), torch.as_tensor(x)
    want, iters = series_terms(a, x, n_iters)
    got = fc._series_sum_exit(at, xt, n_iters)
    fixed = special._gammainc_series_sum(at, xt, n_iters)
    assert got.numpy().tobytes() == want.tobytes() == fixed.numpy().tobytes()
    # the first term 1 / a (torch: a reciprocal and a multiply), then per
    # iteration ap + 1, term · x, / ap and the sum
    assert opcount.count_ops(fc._series_sum_exit, at, xt, n_iters) == 2 * a.size + 4 * iters.sum()
    assert iters.max() <= n_iters and (n_iters < 128 or iters.mean() < 0.5 * n_iters)


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("arm", SERIES_ARMS)
def test_twins_under_series_exit_are_the_fixed_loop(arm, dtype):
    """(b) 2 columns × 8 levels, every mode seeded."""
    splan, rplan = arm_plans(arm)
    spec = ch.arm_data(arm)[0].spec
    x = reference_tune.seeded_state(spec, 2, nz=ch.NZ).to(dtype)
    want = (fc.rainshaft_step_soa_plain(x, splan), fc.rainshaft_rhs_soa_plain(x, rplan))
    with fc.series_exit():
        got = (fc.rainshaft_step_soa_plain(x, splan), fc.rainshaft_rhs_soa_plain(x, rplan))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert g.numpy().tobytes() == w.numpy().tobytes()


def test_opcount_counts_the_series_as_the_kernel_sums_it():
    """(c) the fixed Simpson arm's whole step and fused RHS, f64."""
    data, ckw = ch.arm_data("fixed Simpson")
    step = fc.make_rainshaft_step_fn(data, ch.VEL, NORMS, nz=ch.NZ, dz=ch.DZ, dt=ch.DT,
                                     device="cpu", dtype=torch.float64, **ckw)
    rhs = fc.make_rainshaft_rhs_fn(data, ch.VEL, NORMS, device="cpu", dtype=torch.float64)
    x = reference_tune.seeded_state(data.spec, 2, nz=ch.NZ)
    for fn in (step, rhs):
        table = type(fn)(fn.plan, "cpu", torch.float64, _table=True)
        assert fn.series_exit and not table.series_exit
        n_gen, n_tab = opcount.count_ops(fn.plain, x), opcount.count_ops(table.plain, x)
        assert n_gen == opcount.count_ops(fn.plain, x, series_exit=True)
        assert n_tab == opcount.count_ops(fn.plain, x, series_exit=False)
        assert n_gen < 0.8 * n_tab
        by_class = opcount.count_ops_by_class(fn.plain, x)
        assert sum(by_class[c] for c in ("mul", "add", "div", "exp", "log", "sqrt", "sel")) \
            + sum(by_class["other"].values()) == n_gen
    fast = fc.make_rainshaft_step_fn(
        reference_tune.ref_data(fast_tier=True), ch.VEL, NORMS, nz=ch.NZ, dz=ch.DZ, dt=ch.DT,
        device="cpu", dtype=torch.float64)
    assert not fast.plan.ref and not fast.series_exit
