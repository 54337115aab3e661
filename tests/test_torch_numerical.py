"""The port's numerical-coalescence path against the JAX package on the CPU.

The same numpy inputs (parameters drawn from a seed, then mapped to moments,
as tests/test_pallas_numerical.py does) go through the JAX functions and
their counterparts in `cloudy_tpu_torch`: the densities, the support bounds,
the einsum path `get_coal_ints_numerical`, and the plain twin of the CUDA
quadrature kernel (`ops.numerical_coalescence.numerical_soa_plain`, which a
CPU tensor reaches through `make_numerical_fn`). All in f64 at B = 128 boxes
and (64, 32) nodes unless stated.

Tolerances: densities rtol 1e-12 (same operations, libm against XLA);
einsum path rtol 1e-9, atol 1e-13 (the einsum contraction orders differ);
twin against the einsum path rtol 1e-8, atol 1e-13 (the reference's own
tolerance between its Pallas kernel and its einsum path).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudy_tpu.spec import Family as JFamily, SpectrumSpec as JSpec
from cloudy_tpu import distributions as jpd
from cloudy_tpu import kernels as JK
from cloudy_tpu import coalescence_numerical as jcn

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import bench
from cloudy_tpu_torch import coalescence_numerical as cn
from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.tools import opcount

torch.set_num_threads(1)

B = 128
NODES = dict(n_outer=64, n_inner=32)
KERNEL_ARGS = {
    "linear": ("LinearKernelFunction", (5e-3,)),
    "constant": ("ConstantKernelFunction", (1e-3,)),
    "long": ("LongKernelFunction", (2.0, 1e-3, 5e-3)),
    "hydro": ("HydrodynamicKernelFunction", (1e-2,)),
}
TWO_GAMMA = (Family.GAMMA, Family.GAMMA)
THREE_MODE = (Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL)
#: (families, kernel, seed): two gamma modes with each kernel function, and
#: exponential + gamma + lognormal with the Long and the linear kernel
CASES = [(TWO_GAMMA, k, 0) for k in sorted(KERNEL_ARGS)] + [
    (THREE_MODE, "long", 5), (THREE_MODE, "linear", 5)]
CASE_IDS = [f"{len(f)}modes-{k}" for f, k, _ in CASES]


def _kernel(module, name):
    cls, args = KERNEL_ARGS[name]
    return getattr(module, cls)(*args)


def _moments(families, n, seed=0):
    """Physically consistent moments [n, n_tot] (numpy f64): parameters
    first, then `get_moments` (tests/test_pallas_numerical.py:16-29)."""
    rng = np.random.default_rng(seed)
    cols = []
    for fam in families:
        num = rng.uniform(10, 200, n)
        if fam == Family.LOGNORMAL:
            p1, p2 = rng.uniform(-1.0, 1.0, n), rng.uniform(0.3, 1.0, n)
        else:
            p1, p2 = rng.uniform(0.05, 5.0, n), rng.uniform(0.5, 5.0, n)
        cols.append(np.stack([num, p1, p2], -1))
    params = np.stack(cols, axis=1)
    spec = SpectrumSpec(families)
    return pd.get_moments(spec, torch.as_tensor(params)).numpy(), params


@functools.lru_cache(maxsize=None)
def _jax_reference(families, kname, seed):
    """(moments, JAX tendencies [B, n_tot]) of one case by the JAX einsum
    path; shared by the einsum and the twin tests."""
    mom, _ = _moments(families, B, seed)
    jspec = JSpec(tuple(JFamily(int(f)) for f in families))
    jparams = jpd.params_from_moments(jspec, jnp.asarray(mom))
    want = np.asarray(jcn.get_coal_ints_numerical(
        jspec, jparams, _kernel(JK, kname), **NODES))
    lo, hi = jcn.support_bounds(jspec, jparams)
    return mom, want, np.asarray(lo), np.asarray(hi)


def _finite_reference(families, kname, want):
    """The entries of the JAX result to compare. XLA:CPU flushes denormals,
    so the lognormal density's denominator x·σ·√2π vanishes at the zero-width
    inner panels of the Long kernel (y = 0) and JAX returns NaN in the
    lognormal mode's rows; torch keeps denormals and stays finite. Those
    rows, and only those, are left out."""
    ok = np.isfinite(want)
    if kname == "long" and Family.LOGNORMAL in families:
        spec = SpectrumSpec(families)
        i = families.index(Family.LOGNORMAL)
        rows = np.zeros(spec.n_tot, bool)
        rows[spec.offsets[i]:spec.offsets[i] + spec.nprogmoms[i]] = True
        assert ok[:, ~rows].all()
    else:
        assert ok.all()
    return ok


@pytest.mark.parametrize("normed", [False, True], ids=["density", "normed"])
@pytest.mark.parametrize("family", list(Family), ids=lambda f: f.name.lower())
def test_density_matches_jax(family, normed):
    families = (family, Family.GAMMA)
    _, params = _moments(families, 32, seed=3)
    x = np.geomspace(1e-6, 50.0, 40)[:, None]  # [40, 1] against params [32, …]
    jspec = JSpec(tuple(JFamily(int(f)) for f in families))
    jfn = jpd.normed_density if normed else jpd.density
    tfn = pd.normed_density if normed else pd.density
    want = np.asarray(jfn(jspec, jnp.asarray(params), jnp.asarray(x)))
    got = tfn(SpectrumSpec(families), torch.as_tensor(params), torch.as_tensor(x))
    assert got.shape == want.shape == (40, 32, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-300)
    total = pd.total_density(SpectrumSpec(families), torch.as_tensor(params),
                             torch.as_tensor(x))
    np.testing.assert_allclose(
        total.numpy(), np.asarray(jpd.total_density(jspec, jnp.asarray(params),
                                                    jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("families,kname,seed", CASES, ids=CASE_IDS)
def test_einsum_path_matches_jax(families, kname, seed):
    mom, want, lo, hi = _jax_reference(families, kname, seed)
    spec = SpectrumSpec(families)
    params = pd.params_from_moments(spec, torch.as_tensor(mom))
    x_lo, x_hi = cn.support_bounds(spec, params)
    np.testing.assert_allclose(x_lo.numpy(), lo, rtol=1e-13)
    np.testing.assert_allclose(x_hi.numpy(), hi, rtol=1e-13)
    got = cn.get_coal_ints_numerical(spec, params, _kernel(K, kname), **NODES).numpy()
    assert np.isfinite(got).all()
    ok = _finite_reference(families, kname, want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("families,kname,seed", CASES, ids=CASE_IDS)
def test_twin_matches_jax(families, kname, seed):
    mom, want, _, _ = _jax_reference(families, kname, seed)
    spec = SpectrumSpec(families)
    fn = nc.make_numerical_fn(spec, _kernel(K, kname), **NODES, device="cpu",
                              dtype=torch.float64)
    got = fn(torch.as_tensor(mom)).numpy()
    assert fn.launches == 0 and got.shape == want.shape
    assert np.isfinite(got).all()
    ok = _finite_reference(families, kname, want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-8, atol=1e-13)
    # the lognormal rows that JAX loses agree with the port's einsum path
    params = pd.params_from_moments(spec, torch.as_tensor(mom))
    ein = cn.get_coal_ints_numerical(spec, params, _kernel(K, kname), **NODES).numpy()
    np.testing.assert_allclose(got, ein, rtol=1e-8, atol=1e-13)


def test_twin_matches_pallas_interpret():
    """The twin against the Pallas kernel itself (interpret mode), for the
    linear kernel as the JAX package's default tier runs it; (32, 16) nodes
    keep the interpreter's unrolled trace short."""
    from cloudy_tpu.ops import pallas_numerical as pn

    nodes = dict(n_outer=32, n_inner=16)
    mom, _ = _moments(TWO_GAMMA, B, seed=0)
    jfn = pn.make_pallas_numerical_fn(
        JSpec((JFamily.GAMMA, JFamily.GAMMA)), _kernel(JK, "linear"), **nodes,
        block_cols=128, interpret=True)
    want = np.asarray(jfn(jnp.asarray(mom)))
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), _kernel(K, "linear"), **nodes,
                              device="cpu", dtype=torch.float64)
    got = fn.soa(torch.as_tensor(mom.T.copy())).numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)


def test_empty_and_one_mode_empty_boxes():
    """All-empty boxes give exact zeros, and a box with an empty second mode
    the JAX value (tests/test_pallas_numerical.py:111-131)."""
    spec = SpectrumSpec(TWO_GAMMA)
    mom = np.zeros((B, 6))
    mom[0] = [1e2, 1e1, 2e0, 0, 0, 0]
    fn = nc.make_numerical_fn(spec, _kernel(K, "linear"), **NODES, device="cpu",
                              dtype=torch.float64)
    got = fn(torch.as_tensor(mom)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1:], 0.0)
    jspec = JSpec((JFamily.GAMMA, JFamily.GAMMA))
    want = np.asarray(jcn.get_coal_ints_numerical(
        jspec, jpd.params_from_moments(jspec, jnp.asarray(mom[:1])),
        _kernel(JK, "linear"), **NODES))
    np.testing.assert_allclose(got[:1], want, rtol=1e-8, atol=1e-13)
    for dtype in (torch.float32, torch.float64):  # the Long kernel's panels too
        fn = nc.make_numerical_fn(spec, _kernel(K, "long"), **NODES, device="cpu",
                                  dtype=dtype)
        got = fn(torch.as_tensor(mom, dtype=dtype))
        assert bool(torch.isfinite(got).all()) and bool((got[1:] == 0).all())


@pytest.mark.parametrize("kname", ["linear", "long"])
def test_f32_twin_finite_and_close(kname):
    """The f32 twin at the default budgets against the f64 twin: rtol 5e-2,
    atol 1e-4 of the largest tendency (tests/test_pallas_numerical.py:135-146)."""
    spec = SpectrumSpec(TWO_GAMMA)
    mom, _ = _moments(TWO_GAMMA, B, seed=7)
    kf = _kernel(K, kname)
    want = nc.make_numerical_fn(spec, kf, device="cpu", dtype=torch.float64)(
        torch.as_tensor(mom)).numpy()
    got = nc.make_numerical_fn(spec, kf, device="cpu", dtype=torch.float32)(
        torch.as_tensor(mom, dtype=torch.float32))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2,
                               atol=np.abs(want).max() * 1e-4)


@pytest.mark.parametrize("kname", ["linear", "long"])
def test_one_mode_twin_matches_jax_and_mass_row_cancels(kname):
    """A lone gamma mode: the f64 twin against the JAX einsum path, and why
    its mass row needs a scale of its own. Coalescence keeps a lone mode's
    mass, so that row is S1 - R, two sums of like size: what is left is the
    quadrature's residue, orders below the sums. The f32 twin's rounding of
    the sums is then large against the row itself and small against the
    geometric mean of the neighbouring rows, which is the sums' size."""
    families = (Family.GAMMA,)
    mom, want, _, _ = _jax_reference(families, kname, 5)
    spec = SpectrumSpec(families)
    kf = _kernel(K, kname)
    got = nc.make_numerical_fn(spec, kf, **NODES, device="cpu", dtype=torch.float64)(
        torch.as_tensor(mom)).numpy()
    scale = np.abs(want).max(axis=0)
    sums = np.sqrt(scale[0] * scale[2])
    # f64 rounding of the sums, 1e-13 of their size, is the mass row's floor
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-13 * sums)
    got32 = nc.make_numerical_fn(spec, kf, **NODES, device="cpu", dtype=torch.float32)(
        torch.as_tensor(mom, dtype=torch.float32)).numpy()
    d = np.abs(got32 - got).max(axis=0)
    assert scale[1] < 1e-2 * sums  # the mass row has cancelled
    assert d[0] < 1e-4 * scale[0] and d[2] < 1e-4 * scale[2]
    assert d[1] > 1e-3 * scale[1]  # no scale for f32 rounding
    assert d[1] < 1e-4 * sums


@pytest.mark.parametrize("k", [0, 1, 2])
def test_weighting_fn_matches_jax(k):
    _, params = _moments(THREE_MODE, 1, seed=11)
    x = np.geomspace(1e-4, 30.0, 25)
    jspec = JSpec(tuple(JFamily(int(f)) for f in THREE_MODE))
    want = np.asarray(jcn.weighting_fn(jspec, jnp.asarray(params[0]), jnp.asarray(x), k))
    got = cn.weighting_fn(SpectrumSpec(THREE_MODE), torch.as_tensor(params[0]), x, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match="out of range"):
        cn.weighting_fn(SpectrumSpec(THREE_MODE), torch.as_tensor(params[0]), x, 3)


@pytest.mark.parametrize("probe", ["q_outer", "r_outer", "s1", "s2"])
def test_integrand_probes_match_jax(probe):
    _, params = _moments(TWO_GAMMA, 1, seed=13)
    jspec, spec = JSpec((JFamily.GAMMA, JFamily.GAMMA)), SpectrumSpec(TWO_GAMMA)
    jp, tp = jnp.asarray(params[0]), torch.as_tensor(params[0])
    jk, tk = _kernel(JK, "long"), _kernel(K, "long")
    x = 1.7
    if probe == "q_outer":
        want = jcn.q_integrand_outer(jspec, jp, x, 0, 1, jk, 1)
        got = cn.q_integrand_outer(spec, tp, x, 0, 1, tk, 1)
    elif probe == "r_outer":
        want = jcn.r_integrand_outer(jspec, jp, x, 0, 1, jk, 2)
        got = cn.r_integrand_outer(spec, tp, x, 0, 1, tk, 2)
    elif probe == "s1":
        want = jcn.s_integrand1(jspec, jp, x, 0, jk, 1)
        got = cn.s_integrand1(spec, tp, x, 0, tk, 1)
    else:
        want = jcn.s_integrand2(jspec, jp, x, 1, jk, 0)
        got = cn.s_integrand2(spec, tp, x, 1, tk, 0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-11)


@pytest.mark.parametrize("kname", sorted(KERNEL_ARGS))
def test_kernel_function_on_tensors_and_descriptor(kname):
    """Each kernel function evaluates on torch tensors as on numpy arrays,
    and packs to the tag and parameters of its normalized self."""
    norms = (1e6, 1e-9)
    kf = {"linear": K.LinearKernelFunction(5.0),
          "constant": K.ConstantKernelFunction(2e-10),
          "long": K.LongKernelFunction(5.236e-10, 9.44e9, 5.78),
          "hydro": K.HydrodynamicKernelFunction(1e-9)}[kname].normalized(norms)
    rng = np.random.default_rng(1)
    x, y = rng.uniform(0.0, 2.0, (5, 1)), rng.uniform(0.0, 2.0, (1, 7))
    got = kf(torch.as_tensor(x), torch.as_tensor(y))
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), kf(x, y), rtol=1e-13)  # pow, |a1 - a2|
    tag, par = nc.kernel_descriptor(kf)
    want = {"constant": (0, (2e-10 * 1e6, 0.0, 0.0)),
            "linear": (1, (5.0 * 1e6 * 1e-9, 0.0, 0.0)),
            "hydro": (2, (1e-9 * 1e6 * 1e-9 ** (4.0 / 3.0), 0.0, 0.0)),
            "long": (3, (5.236e-10 / 1e-9, 9.44e9 * 1e6 * 1e-18, 5.78 * 1e6 * 1e-9))}[kname]
    assert tag == want[0]
    np.testing.assert_allclose(par, want[1], rtol=1e-15)


class _TwoKinkLong(K.LongKernelFunction):
    """A Long-like kernel with two kinks, which the panels do not cover."""

    @property
    def x_kinks(self):
        return (1.0, 2.0)


def test_foreign_callable_and_second_kink_raise():
    """A callable outside the four tagged classes is traced into the
    kernel's generated arm (KT_GEN), as JAX's kernel calls any callable;
    only one the tracer cannot follow raises, on a CUDA wrapper, naming
    the operation (tests/test_torch_b5_callable.py holds the traced ones
    against JAX). A second kink raises, as in JAX."""
    spec = SpectrumSpec(TWO_GAMMA)
    tensor = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)

    class Scaled(K.LinearKernelFunction):  # same fields, another K(x, y)
        def __call__(self, x, y):
            return 2.0 * super().__call__(x, y)

    for foreign in (tensor, lambda x, y: x + y, Scaled(1.0)):
        fn = nc.make_numerical_fn(spec, foreign, device="cpu")
        assert fn.plan.ktag == nc.KT_GEN and "cloudy_kernel_gen" in fn.unit.cfg
    with pytest.raises(NotImplementedError, match="torch.special.ndtri"):
        nc.make_numerical_fn(spec, lambda x, y: torch.special.ndtri(x + y), device="cuda")
    with pytest.raises(NotImplementedError, match="<=1 kink"):
        nc.make_numerical_fn(spec, _TwoKinkLong(1.0, 1e-3, 5e-3), device="cpu")
    plan = nc.build_plan(spec, K.LongKernelFunction(1.0, 1e-3, 5e-3))
    assert plan.outer_cuts == (1.0, 2.0)
    # more outer nodes than a block has threads: strided, not refused
    wide = nc.build_plan(spec, _kernel(K, "linear"), n_outer=512)
    assert wide.g_total == 512 and nc.pack_config(wide, torch.float32).size % 16 == 0


def test_cuda_device_without_a_card_raises():
    """No silent CPU run: asking for the card where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), _kernel(K, "linear"), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.numerical_fn(device="cuda")


def test_wrapper_rejects_wrong_inputs():
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), _kernel(K, "linear"), **NODES,
                              device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="float64"):
        fn.soa(torch.zeros(6, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="n_tot"):
        fn.soa(torch.zeros(5, 8))
    with pytest.raises(ValueError, match="contiguous"):
        fn.soa(torch.zeros(8, 6).T)


def test_bench_numerical_configuration():
    """The numerical bench: the Long kernel normalized by (1e6, 1e-9), the
    (96, 48) budgets split by the kink into 3 x 32 and 3 x 16 nodes, the
    first 262,144 boxes of the 2^20-box seeded state."""
    fn = bench.numerical_fn(device="cpu")
    plan = fn.plan
    assert (plan.n_po, plan.g_outer, plan.n_pi, plan.g_inner) == (3, 32, 3, 16)
    assert plan.g_total == 96 and plan.ktag == 3 and plan.n_tot == 6
    np.testing.assert_allclose(plan.kpar, (0.5236, 9.44e-3, 5.78e-3), rtol=1e-15)
    assert bench.NUMERICAL_COLUMNS == 262144
    mom = bench.numerical_moments(512)
    np.testing.assert_array_equal(mom, bench.bench_moments(1 << 20)[:512])
    # a chain step on a few boxes: finite, total mass tendency ~ 0
    x = torch.as_tensor(mom[:16].T.copy(), dtype=torch.float32)
    out = bench.relax_chain(fn.soa, x, 2)
    assert out.shape == (6, 16) and bool(torch.isfinite(out).all())
    dm = fn.soa(x)
    assert float((dm[1] + dm[4]).abs().max()) < 1e-4 * float(dm[1].abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_packed_config_layout(dtype):
    """Header, per-mode ints and reals sit where
    csrc/numerical_coalescence.cu (`NumConfig::bind`) reads them."""
    plan = bench.numerical_fn(device="cpu").plan
    buf = nc.pack_config(plan, dtype)
    assert buf.size % 16 == 0 and buf.size <= 12288  # within 12 KB
    ints = buf.view(np.int32)
    assert list(ints[:8]) == [2, 6, 3, 3, 32, 3, 16, 3]
    h, m = nc.HEADER_INTS, nc.MAX_MODES
    assert list(ints[h:h + 3 * m]) == [1, 1, 0, 0, 3, 0, 3, 3, 0]
    off = int(ints[8])
    assert off == 4 * (h + 3 * m + 1)  # padded to 8 bytes
    real_t = np.float32 if dtype == torch.float32 else np.float64
    reals = buf[off:].view(real_t)
    np.testing.assert_array_equal(reals[:4], np.asarray(
        [0.5236, 9.44e-3, 5.78e-3, 0.5236]).astype(real_t))
    np.testing.assert_array_equal(reals[4:6], np.log([0.5236, 1.0472]).astype(real_t))
    xu, wu = np.polynomial.legendre.leggauss(32)
    su, ws = np.polynomial.legendre.leggauss(16)
    np.testing.assert_array_equal(reals[6:38], xu.astype(real_t))
    np.testing.assert_array_equal(reals[38:70], wu.astype(real_t))
    np.testing.assert_array_equal(reals[70:86], (0.5 * (su + 1.0)).astype(real_t))
    np.testing.assert_array_equal(reals[86:102], (0.5 * ws).astype(real_t))
    n_tables = 0
    if dtype == torch.float64:  # the inner nodes' log tables: f64 only
        ls01, l1m01 = nc.inner_log_tables(0.5 * (su + 1.0))
        np.testing.assert_array_equal(reals[102:118], ls01)
        np.testing.assert_array_equal(reals[118:134], l1m01)
        n_tables = 32
    assert not reals[102 + n_tables:].any()  # padding
    smooth = nc.pack_config(nc.build_plan(SpectrumSpec(TWO_GAMMA), _kernel(K, "linear")),
                            dtype).view(np.int32)
    assert list(smooth[3:8]) == [1, 96, 1, 48, 1]


@pytest.mark.parametrize("kname", ["linear", "long"])
def test_inner_log_tables_are_the_logs_the_twin_takes(kname):
    """`quad_kernel`'s f64 tables: log s and log(1 − s) of the inner nodes
    (1 − s formed in f64, as the twin forms X·(1 − s) on the panel [0, 1]),
    each within one rounding of the log the twin takes of them; one inner
    panel (linear) and three (Long)."""
    plan = nc.build_plan(SpectrumSpec(TWO_GAMMA), _kernel(K, kname), 64, 32)
    s01 = nc._rules(plan)[2]
    ls01, l1m01 = nc.inner_log_tables(s01)
    s = torch.as_tensor(s01, dtype=torch.float64)  # the twin's s = 0 + (1 - 0) · s01
    one_minus = 1.0 - s
    np.testing.assert_allclose(np.exp(ls01), s.numpy(), rtol=1e-14)
    np.testing.assert_allclose(np.exp(l1m01), one_minus.numpy(), rtol=1e-14)
    eps = torch.finfo(torch.float64).eps
    np.testing.assert_allclose(ls01, torch.log(s).numpy(), rtol=eps, atol=4 * eps)
    np.testing.assert_allclose(l1m01, torch.log(one_minus).numpy(), rtol=eps, atol=4 * eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_numerical_wrapper_bodies(dtype):
    """The wrapper launches `quad_kernel`; `_direct` the body it replaced."""
    plan = bench.numerical_fn(device="cpu").plan
    tag = "f32" if dtype == torch.float32 else "f64"
    assert nc.NumericalFn(plan, "cpu", dtype)._symbol == f"cloudy_numerical_{tag}_n2"
    assert (nc.NumericalFn(plan, "cpu", dtype, _direct=True)._symbol
            == f"cloudy_numerical_direct_{tag}_n2")
    fn = nc.NumericalFn(plan, "cpu", dtype, _direct=True)
    x = torch.as_tensor(bench.numerical_moments(16).T.copy(), dtype=dtype)
    assert torch.equal(fn.soa(x), nc.numerical_soa_plain(x, plan)) and fn.launches == 0


def test_opcount_counts_arithmetic_only():
    """`count_ops` counts one operation per floating element an arithmetic
    op produces (a sum: per element it reads), and nothing for copies."""
    x = torch.ones(4, 10)

    def fn(t):
        y = (t * 2.0 + 1.0).exp()          # 3 x 40
        z = torch.where(y > 1.0, y, t)     # 40 (the comparison is boolean)
        return z.reshape(10, 4).T.contiguous().sum(dim=0)  # 40 read

    assert opcount.count_ops(fn, x) == 5 * 40
    ms, by = opcount.bound_ms(3.35e9, 67e6)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = opcount.bound_ms(3.35e6, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    # the quadrature twin: operations per box do not depend on the batch
    # (but for the few constants it builds per call)
    fn = bench.numerical_fn(device="cpu")
    mom = torch.as_tensor(bench.numerical_moments(8).T.copy(), dtype=torch.float32)
    per_box = opcount.count_ops(fn.plain, mom) / 8
    half = opcount.count_ops(fn.plain, mom[:, :4].contiguous()) / 4
    assert abs(per_box - half) < 1e-3 * per_box
    assert 3e5 < per_box < 5e5
    shares = opcount.numerical_bench_shares(n_boxes=4)
    assert abs(shares["operations_per_box"] - per_box) < 1e-3 * per_box
    assert shares["qs_loop_share"] > shares["r_loop_share"] > shares["rest_share"] > 0

