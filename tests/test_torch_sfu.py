"""The SFU forms of the generated f32 fast tier on the card (csrc/common.cuh
`sfu` and `Dom<float, true>`, chosen by a configuration's `kSfu`).

These tests need a CUDA device and the CUDA toolkit; without them they skip
(marker ``cuda``). They import no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sfu.py

(a) each device helper against f64 on the operand range the body feeds it,
    its largest error pinned: `lg2` on t in [FLT_MIN, 1e6 + 6 sqrt(a)] (the
    GL nodes), `ex2` on base-2 exponents across f32's range (subnormal
    results included), `rcp` on normal denominators, `div` (div.full) on
    denominators across f32's range with the subnormals, `sqrt` on operands
    of FLT_MIN and more; and the base-2 forms the body is written in (the
    Stirling lgamma, the gamma ratio, a GL node) against f64 beside their
    IEEE f32 counterparts;
(b) the SFU units of B1 (the three pod variants), B1s, B4 and B3 against
    their plain twins in f32 (row-scaled, < 1e-4, as
    tests/test_torch_cuda_kernels.py), each unit's label naming the form;
(c) the `fixed2gamma` whole step's unit: no SASS CALL (no IEEE slow path),
    its MUFU count and registers printed.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import _build, codegen
from cloudy_tpu_torch.ops import fused_coalescence as fc

pytestmark = pytest.mark.cuda

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)
VARIANTS = ("fixed2gamma", "moving", "lognorm")
LOG2E = 1.4426950408889634
FLT_MIN = float(np.finfo(np.float32).tiny)
N = 1 << 20

#: the helpers, one elementwise kernel: op, then up to three inputs
SOURCE = r"""// Generated by tests/test_torch_sfu.py; do not edit.
#include "coal_body.cuh"

namespace {
using D = cloudy::Dom<float, true>;

__global__ void sfu_check(int op, const float* a, const float* b, const float* c, float* out,
                          long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i], z = c[i];
  float r = 0.0f;
  switch (op) {
    case 0: r = cloudy::sfu::lg2(x); break;
    case 1: r = cloudy::sfu::ex2(x); break;
    case 2: r = cloudy::sfu::rcp(x); break;
    case 3: r = cloudy::sfu::div(x, y); break;
    case 4: r = cloudy::sfu::sqrt(x); break;
    // lgamma(x) log2(e), and the IEEE natural form
    case 5: r = cloudy::lgamma_stirling<true>(x); break;
    case 6: r = cloudy::lgamma_stirling<false>(x); break;
    // Gamma(x + y) / Gamma(x), y log2(e) in z
    case 7: r = cloudy::gamma_ratio<true>(x, y, z); break;
    case 8: r = cloudy::gamma_ratio<false>(x, y, y); break;
    // a GL node t^(a - 1) e^-t / Gamma(a): x = a, y = t, z = lgamma(a) in
    // the domain (base 2 with the SFU, natural in IEEE)
    case 9: r = D::ex((x - 1.0f) * D::lg(y) - D::from_ln(y) - z); break;
    case 10: r = cloudy::dexp((x - 1.0f) * cloudy::dlog(y) - y - z); break;
  }
  out[i] = r;
}
}  // namespace

extern "C" int cloudy_sfu_check(int op, const void* a, const void* b, const void* c, void* out,
                                long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  sfu_check<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      op, (const float*)a, (const float*)b, (const float*)c, (float*)out, n);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def helpers():
    """`helpers(op, a, b=None, c=None)`: the check kernel on float32 arrays,
    the result as float64 numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    u = codegen.Unit(kind="sfu_check", dtype=torch.float32, cfg="", source=SOURCE,
                     digest=codegen._digest(SOURCE), threads=0, shfl=False, n_tot=0, nz=0)
    rec, = _build.build_generated([u])
    lib = ctypes.CDLL(str(rec["path"]))
    f = lib.cloudy_sfu_check
    p = ctypes.c_void_p
    f.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_longlong, p]
    f.restype = ctypes.c_int

    def call(op, a, b=None, c=None):
        a = torch.as_tensor(np.asarray(a, np.float32), device="cuda")
        b = a if b is None else torch.as_tensor(np.asarray(b, np.float32), device="cuda")
        c = a if c is None else torch.as_tensor(np.asarray(c, np.float32), device="cuda")
        out = torch.empty_like(a)
        err = f(op, a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), a.numel(),
                torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out.cpu().double().numpy()

    return call


def _f32(x):
    return np.asarray(x, np.float32).astype(np.float64)


def _ulps(got, exact):
    """|got - exact| in units of the f32 spacing at exact (the subnormals'
    2^-149 below FLT_MIN)."""
    spacing = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    return np.abs(got - exact) / spacing


def _log_uniform(rng, lo, hi, n, signed=False):
    x = np.exp2(rng.uniform(np.log2(lo), np.log2(hi), n))
    if signed:
        x = x * rng.choice([-1.0, 1.0], n)
    return _f32(x)


def test_lg2_on_the_gl_nodes(helpers):
    """lg2.approx.f32 over t in [FLT_MIN, 1e6 + 6 sqrt(24)] (a GL node is
    clamped at FLT_MIN; its far end is x + 6 sqrt(a) with x at most 1e6),
    and on the subnormals (kept: no .ftz): at most 2^-22 absolute in
    [0.5, 2] (2^-22.17 read on an H100), 2.5 ulp of the exact log elsewhere
    (2.17 read; CUDA's 2 ulp is against the rounded log), 2 ulp on the
    subnormals."""
    rng = np.random.default_rng(1)
    t = np.concatenate([_log_uniform(rng, FLT_MIN, 1e6 + 6 * math.sqrt(24.0), N),
                        _f32(rng.uniform(0.5, 2.0, N)),
                        [FLT_MIN, 0.5, 1.0, 2.0, 1e6]])
    got, exact = helpers(0, t), np.log2(t)
    mid = (t >= 0.5) & (t <= 2.0)
    abs_mid = float(np.abs(got - exact)[mid].max())
    ulp_out = float(_ulps(got, exact)[~mid].max())
    print(f"lg2: {abs_mid:.3e} absolute in [0.5, 2] ({math.log2(abs_mid):.2f} in log2), "
          f"{ulp_out:.3f} ulp elsewhere")
    assert abs_mid <= 2.0 ** -22 and ulp_out <= 2.5
    assert got[-3] == 0.0  # lg2(1)
    sub = _f32(np.exp2(rng.uniform(-149, -126, 4096)))
    got = helpers(0, sub)
    # subnormals kept, not -inf: within 2 ulp (1.006 read on an H100)
    assert float(_ulps(got, np.log2(sub)).max()) <= 2.0


def test_ex2_across_the_exponent_range(helpers):
    """ex2.approx.f32 over base-2 exponents from -149 to 128 (the subnormal
    results kept): at most 2.5 ulp of the exact power (2.055 read on an H100
    on normal results, 2.140 on subnormal ones; CUDA's 2 ulp is against the
    rounded power); 2^-151 and below give zero, 128 and above overflow."""
    rng = np.random.default_rng(2)
    x = np.concatenate([_f32(rng.uniform(-149.0, 127.99, N)),
                        _f32(rng.uniform(-30.0, 30.0, N)), [0.0, 1.0, -1.0, -126.0]])
    got, exact = helpers(1, x), np.exp2(x)
    normal = exact >= FLT_MIN
    ulp_n = float(_ulps(got, exact)[normal].max())
    ulp_s = float(_ulps(got, exact)[~normal].max())
    print(f"ex2: {ulp_n:.3f} ulp on normal results, {ulp_s:.3f} on subnormal ones")
    assert ulp_n <= 2.5 and ulp_s <= 2.5
    assert np.all(helpers(1, [128.0, 200.0]) == np.inf)
    assert np.all(helpers(1, [-151.0, -200.0]) == 0.0)


def test_rcp_on_normal_denominators(helpers):
    """rcp.approx.f32 on normal denominators of either sign (the body takes
    it only where the denominator is known normal): at most 1 ulp."""
    rng = np.random.default_rng(3)
    x = np.concatenate([_log_uniform(rng, FLT_MIN, 2.0 ** 126, N, signed=True),
                        _log_uniform(rng, 1.0, 64.0, N), [1.0, 3.0, 4.0, 2.0 ** -126]])
    got = helpers(2, x)
    ulp = float(_ulps(got, 1.0 / x).max())
    print(f"rcp: {ulp:.3f} ulp")
    assert ulp <= 1.0


def test_div_full_with_subnormal_denominators(helpers):
    """div.full.f32 on denominators across f32's range, the subnormals
    included, and numerators as the closure's mean (eps to 1e7) and across
    the range: within 2.5 ulp of the exact quotient where it is normal
    (2.016 read on an H100; CUDA's 2 ulp is against the rounded quotient),
    the subnormal quotients within 2 of the least subnormal (0.927 read),
    overflow to inf of the quotient's sign."""
    rng = np.random.default_rng(4)
    b = np.concatenate([_log_uniform(rng, 2.0 ** -149, FLT_MIN, N // 4, signed=True),
                        _log_uniform(rng, 2.0 ** -149, 2.0 ** 128 * 0.99, N, signed=True)])
    a = np.concatenate([_log_uniform(rng, 1.1920929e-07, 1e7, N // 4 + N // 2),
                        _log_uniform(rng, 2.0 ** -126, 2.0 ** 127, N - N // 2, signed=True)])
    got, exact = helpers(3, a, b), a / b
    fin = np.abs(exact) <= float(np.finfo(np.float32).max)
    normal = fin & (np.abs(exact) >= FLT_MIN)
    sub = fin & ~normal
    ulp_n = float(_ulps(got[normal], exact[normal]).max())
    ulp_s = float(_ulps(got[sub], exact[sub]).max()) if sub.any() else 0.0
    n_sub_den = int((np.abs(b) < FLT_MIN).sum())
    print(f"div.full: {ulp_n:.3f} ulp on normal quotients, {ulp_s:.3f} on subnormal ones "
          f"({int(sub.sum())}), {n_sub_den} subnormal denominators")
    assert ulp_n <= 2.5 and ulp_s <= 2.0
    over = ~fin
    assert np.all(np.isinf(got[over])) and np.all(np.sign(got[over]) == np.sign(exact[over]))


def test_sqrt_on_clamped_operands(helpers):
    """sqrt.approx.f32 on operands of FLT_MIN and more (a GL integral's
    sqrt(max(a - 1, FLT_MIN)), the percentile inverse's sqrt(1 / (9 a))):
    within 1 ulp."""
    rng = np.random.default_rng(5)
    x = np.concatenate([_log_uniform(rng, FLT_MIN, 2.0 ** 127, N),
                        _f32(rng.uniform(1e-7, 30.0, N)), [FLT_MIN, 1.0, 4.0]])
    got = helpers(4, x)
    ulp = float(_ulps(got, np.sqrt(x)).max())
    print(f"sqrt: {ulp:.3f} ulp")
    assert ulp <= 1.0


def test_base2_forms_of_the_body(helpers):
    """The Stirling lgamma (at a0 + 1, a0 = 2k in [2 eps, 20]) and the gamma
    ratio (k in [eps, 10], e = 1/6) in base 2, and a GL node t^(a-1) e^-t /
    Gamma(a) (a in [1.2, 24], t within 12 sqrt(a) of a - 1) against f64, each
    within a small multiple of its IEEE f32 counterpart's error."""
    rng = np.random.default_rng(6)
    x = _f32(rng.uniform(1.0, 21.0, N))
    want = np.array([math.lgamma(v) for v in x[:65536]])
    sfu = np.abs(helpers(5, x)[:65536] - want * LOG2E) / np.maximum(1.0, np.abs(want * LOG2E))
    ieee = np.abs(helpers(6, x)[:65536] - want) / np.maximum(1.0, np.abs(want))
    print(f"lgamma_stirling: base 2 {sfu.max():.3e}, IEEE {ieee.max():.3e} (scaled absolute)")
    assert sfu.max() <= 4.0 * ieee.max() + 2e-7

    k = _f32(rng.uniform(1.1920929e-07, 10.0, 65536))
    e = np.full_like(k, _f32(1.0 / 6.0))
    e2 = np.full_like(k, _f32(1.0 / 6.0 * LOG2E))
    want = np.exp([math.lgamma(a + b) - math.lgamma(a) for a, b in zip(k, e)])
    sfu = np.abs(helpers(7, k, e, e2) / want - 1.0)
    ieee = np.abs(helpers(8, k, e) / want - 1.0)
    print(f"gamma_ratio: base 2 {sfu.max():.3e}, IEEE {ieee.max():.3e} (relative)")
    assert sfu.max() <= 4.0 * ieee.max() + 2e-7

    a = _f32(rng.uniform(1.2, 24.0, 65536))
    t = _f32(np.maximum(a - 1.0 + 12.0 * np.sqrt(a) * rng.uniform(-1.0, 1.0, 65536), FLT_MIN))
    lga = np.array([math.lgamma(v) for v in a])
    want = np.exp((a - 1.0) * np.log(t) - t - lga)
    keep = want > 1e-30
    sfu = np.abs(helpers(9, a, t, _f32(lga * LOG2E))[keep] / want[keep] - 1.0)
    ieee = np.abs(helpers(10, a, t, _f32(lga))[keep] / want[keep] - 1.0)
    print(f"GL node: base 2 {sfu.max():.3e}, IEEE {ieee.max():.3e} (relative, "
          f"{int(keep.sum())} nodes above 1e-30)")
    assert sfu.max() <= 2.0 * ieee.max() + 1e-6


# --------------------------------------------------------------------------
# (b) the SFU units against their twins
# --------------------------------------------------------------------------


def _column_state(n_cols, nz, seed):
    """tests/test_torch_cuda_kernels.py's columns: two top-hat modes, each
    column's amplitudes drawn from [0.5, 1.5], one negative moment and one
    negative level."""
    z = (np.arange(nz) + 0.5) * 3000.0 / nz
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12]),
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 2)).repeat(3, axis=2)
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, nz // 2, 0] *= -1.0
    st[-1, nz // 2 + 1, :] = -1e-3
    return rs.to_soa(torch.as_tensor(st))


def _row_scaled(got, want):
    d = (got.double() - want.double()).abs().amax(dim=1)
    return float((d / want.double().abs().amax(dim=1).clamp_min(1e-300)).max())


def _fns(variant, dev):
    _, data = harness.pod_data(variant)
    kw = dict(device=dev, dtype=torch.float32)
    return {
        "step": fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0, **kw),
        "scaled": fc.make_rainshaft_step_fn(data, VEL, NORMS, nz=32, dz=93.75, dt=1.0,
                                            kernel_scale=True, **kw),
        "rhs": fc.make_rainshaft_rhs_fn(data, VEL, NORMS, **kw),
        "coal": fc.make_coal_fn(data, **kw),
    }


@pytest.fixture(scope="module", autouse=True)
def _units():
    """Build the units this module launches in one batch."""
    if torch.cuda.is_available():
        _build.build_generated([u for v in VARIANTS for f in _fns(v, "cuda").values()
                                for u in f.build_units()])


@pytest.mark.parametrize("variant", VARIANTS)
def test_sfu_units_match_twins(cuda, variant):
    """B1 (nz 32, 9 columns), B1s (a scale per column from 0.4 to 2.5), B4
    and B3 of the variant, each an SFU unit (`kSfu`, its label
    ``<kind>_sfu_f32_<digest>``), against its twin in f32: < 1e-4
    row-scaled."""
    fns = _fns(variant, cuda)
    for kind, fn in fns.items():
        assert fn.route == "generated" and fn.unit.sfu, kind
        assert "_sfu_f32_" in fn.unit.label and "kSfu = true" in fn.unit.cfg, kind
    x = _column_state(9, 32, seed=33).to(cuda, torch.float32)
    s = torch.linspace(0.4, 2.5, 9, device=cuda).repeat_interleave(32)
    norm = torch.tensor(fns["step"].plan.mom_norms, dtype=torch.float32, device=cuda)[:, None]
    m = (x.clamp_min(0) / norm).contiguous()  # normalized moments for B3
    err = {"step": _row_scaled(fns["step"](x), fns["step"].plain(x)),
           "scaled": _row_scaled(fns["scaled"](x, s), fns["scaled"].plain(x, s)),
           "rhs": _row_scaled(fns["rhs"].soa(x), fns["rhs"].plain(x)),
           "coal": _row_scaled(fns["coal"].soa(m), fns["coal"].plain(m))}
    print(variant, {k: f"{v:.3e}" for k, v in err.items()})
    assert all(v < 1e-4 for v in err.values()), err


def test_fixed2gamma_step_has_no_slow_path(cuda):
    """The benchmark's unit, the `fixed2gamma` whole step in f32: no SASS
    CALL (every divide, log, exp and square root inline), no stack; its
    registers, MUFU count and blocks per SM printed."""
    fn = _fns("fixed2gamma", cuda)["step"]
    rec, = _build.build_generated([fn.unit])
    counts = _build.sass_counts(rec["path"])
    name, = [k for k in counts if "gen_step" in k]
    ptx = _build.ptxas_report(rec["log"])
    out = ctypes.c_int(0)
    _build.load_generated(fn.unit).cloudy_gen_blocks_per_sm(ctypes.byref(out))
    print(fn.unit.label, ptx, {k: counts[name][k] for k in ("CALL", "MUFU", "total")},
          f"blocks per SM {out.value}")
    assert counts[name]["CALL"] == 0 and ptx["stack"] == 0
