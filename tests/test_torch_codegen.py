"""The per-configuration code generator of the port (`ops.codegen`) on the
CPU, against the JAX package and the plain twins (no GPU, no nvcc):

(a) the generated contraction's terms, parsed back from the emitted
    source, equal the Pallas body's: `_wb_nonzeros`, then `_wf_nonzeros`
    without the terms its `f2_lookup` skips (pallas_coalescence.py:598-620),
    in that order, each coefficient rounded once to the type; for the three
    pod variants and the two B-cover configurations, (E, E) and (E, L, G);
(b) every emitted literal parses back, bit for bit, to the host double
    rounded once to f32 or f64 (`fused_coalescence.config_reals`, what
    `pack_config` packs);
(c) the generated body compiled as host C++ with g++ (a shim header
    defines the CUDA qualifiers away; the math wrappers are <cmath>'s),
    called through ctypes on seeded, physically consistent lanes
    (parameters drawn, then mapped to moments) and held row-scaled against
    the plain twins: f64 < 1e-12, f32 < 1e-5 (the same operations in the
    same order, compiled without FMA contraction; glibc's and torch's
    exp/log differ in the last bits); and one variant in f64 against JAX's
    `make_pallas_coal_fn` in interpret mode at 256 lanes, < 1e-9
    (tests/test_pallas.py:656: XLA's and g++'s exp/log and fusion differ);

and the same for the coalescence RHS on normalized moments (B3, the
``"coal"`` kind): its source, digest and route, its generated shell
(`gen_coal_body`, one thread per box) compiled as host C++ and called lane
by lane against the twin (f64 < 1e-12, f32 < 1e-5, the three pod
variants) and in f64 against `make_pallas_coal_fn` in interpret mode
(< 1e-9); the reference tier's layout choice (a warp per box at small
batches) as a function of B and the card; the route each wrapper takes,
from its plan alone; and the build cache of generated units (`ops._build`):
the ptxas report and spill rule, a unit's name over the retry rule, a built
library found by its name. Each host library is compiled once per module.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cloudy_tpu import harness as jharness
from cloudy_tpu import kernels as JK
from cloudy_tpu.coalescence import build_coalescence_data as jbuild
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.spec import SpectrumSpec as JSpec

from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.ops import _build, codegen
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

torch.set_num_threads(1)

NORMS = (1e6, 1e-9)
VEL = ((50.0, 1.0 / 6.0),)
NZ, DZ, DT = 32, 3000.0 / 32, 1.0
DTYPES = {"f32": torch.float32, "f64": torch.float64}
E, G, L = Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL
#: the pod variants (cloudy_tpu/harness.py POD_VARIANTS) and the B-cover
#: configurations, all at the fast tier
CONFIGS = {
    **{v: jharness.POD_VARIANTS[v] for v in ("fixed2gamma", "moving", "lognorm")},
    "exp-only": ((E, E), (5e-10, np.inf), False, {}),
    "three-mode": ((E, L, G), (2e-10, 5e-10, np.inf), False, {}),
}
VARIANTS = ["fixed2gamma", "moving", "lognorm"]
HOST_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

#: the CUDA names the generated body uses, for a host compile
SHIM = """#pragma once
#include <cmath>
#include <math.h>
#include <cstddef>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline void __syncthreads() {}
template <class T> T __shfl_down_sync(unsigned, T v, int, int) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
"""

HARNESS = """#include "gen_kernels.cuh"
#include "cfg.cuh"
using cloudy::gen::Cfg;
using T = Cfg::real;
extern "C" void host_coal(const T* mom, T* out, long long B) {
  const Cfg c{};
  for (long long lane = 0; lane < B; ++lane) {
    T m[Cfg::kNtot], acc[Cfg::kNtot], params[Cfg::kModes][3];
    for (int o = 0; o < Cfg::n_tot; ++o) m[o] = mom[o * B + lane];
    cloudy::coal_body<Cfg::kArms, false>(c, m, acc, params);
    for (int o = 0; o < Cfg::n_tot; ++o) out[o * B + lane] = acc[o];
  }
}
extern "C" void host_rhs(const T* mom, T* out, long long B) {
  const Cfg c{};
  for (long long lane = 0; lane < B; ++lane)
    cloudy::rhs_lane<Cfg::kArms, false>(c, mom, out, B, lane);
}
// the generated coalescence kernel's shell, one "thread" at a time
extern "C" void host_gen_coal(const T* mom, T* out, long long B) {
  for (long long lane = 0; lane < B; ++lane) {
    blockIdx.x = (unsigned)(lane / Cfg::kThreads);
    threadIdx.x = (unsigned)(lane % Cfg::kThreads);
    cloudy::gen_coal_body<Cfg>(mom, out, B);
  }
}
"""


def _both(name):
    """(JAX data, port data) of a configuration, fast tier."""
    fams, thresholds, moving, kw = CONFIGS[name]
    kw = {**kw, "fast_tier": True}
    jker = JK.CoalescenceTensor.from_function(JK.LinearKernelFunction(5.0), 1, 1e-6)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    jdata = jbuild(JSpec(fams), jker, thresholds, norms=NORMS, moving=moving, **kw)
    data = build_coalescence_data(SpectrumSpec(tuple(Family(int(f)) for f in fams)),
                                  ker, thresholds, norms=NORMS, moving=moving, **kw)
    return jdata, data


def _plan(data, kind="step"):
    if kind == "step":
        return fc.build_plan(data, VEL, NORMS, NZ, DZ, DT)
    if kind == "coal":
        return fc.build_plan(data)  # as `make_coal_fn` builds it
    return fc.build_plan(data, VEL, NORMS)


def _unhex(s):
    return float.fromhex(s.strip("()").rstrip("f"))


def _real_t(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


# --------------------------------------------------------------------------
# (a) the contraction's terms
# --------------------------------------------------------------------------


def _parsed_terms(src):
    """The contraction's statements, in order: ("wb", o, i, j, c) and
    ("wf", o, k, a, b, c), and whether each is the first write of acc[o]."""
    body = src[src.index("void contract("):]
    out = []
    for m in re.finditer(r"acc\[(\d+)\] = (acc\[(\d+)\] \+ )?(\(?-?0x[0-9a-fA-Fp.+-]+f?\)?) \* "
                         r"(?:mf\[(\d+)\] \* mf\[(\d+)\]|f2_(\d+)_(\d+)_(\d+));", body):
        o, adds, o2, c = int(m.group(1)), m.group(2) is not None, m.group(3), m.group(4)
        assert not adds or int(o2) == o
        if m.group(5) is not None:
            out.append((("wb", o, int(m.group(5)), int(m.group(6)), _unhex(c)), adds))
        else:
            out.append((("wf", o, int(m.group(7)), int(m.group(8)), int(m.group(9)),
                         _unhex(c)), adds))
    return out


def _pallas_terms(jdata, real_t):
    """The Pallas body's contraction (pallas_coalescence.py:598-620): the wb
    nonzeros, then the wf nonzeros whose `f2_lookup` is not None — an entry
    (p, q) of mode k exists only for p, q < n_2d_ints[k], thresholded or
    not (:451-455, :600-606) — the F2 entry read at (min, max)."""
    wb = [("wb", o, i, j, float(real_t(c))) for (o, i, j, c) in pc._wb_nonzeros(jdata)]
    n2d = jdata.n_2d_ints
    wf = [("wf", o, k, min(p, q), max(p, q), float(real_t(c)))
          for (o, k, p, q, c) in pc._wf_nonzeros(jdata) if p < n2d[k] and q < n2d[k]]
    return wb + wf


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_generated_terms_equal_the_pallas_body(name, dtype):
    jdata, data = _both(name)
    plan = _plan(data)
    got = _parsed_terms(codegen.config_source(plan, dtype))
    want = _pallas_terms(jdata, _real_t(dtype))
    assert [t for t, _ in got] == want
    seen = set()
    for t, adds in got:  # the first term of each output assigns, later ones add
        assert adds == (t[1] in seen)
        seen.add(t[1])
    assert len(plan.wb_nz) + len(plan.wf_nz) == len(want)


# --------------------------------------------------------------------------
# (b) literals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_literals_parse_back_bit_for_bit(dtype):
    real_t = _real_t(dtype)
    rng = np.random.default_rng(9)
    vals = np.concatenate([
        rng.standard_normal(2000) * 10.0 ** rng.integers(-300, 300, 2000),
        [0.0, -0.0, 1.0, 2.0 / 3.0, 1e-45, 1.4e-45, 1e-40, 3.4e38, -3.4e38, 5e-324,
         1.7976931348623157e308, 0.1, 1.0 / 3.0],
    ])
    if dtype == torch.float32:
        vals = vals[np.abs(vals) < 3.4e38]
    for v in vals:
        s = codegen.literal(float(v), dtype)
        back = _unhex(s)
        assert np.asarray(real_t(back)).tobytes() == np.asarray(real_t(v)).tobytes(), (v, s)
        assert float(real_t(back)) == back, (v, s)  # exact in the type
        assert s.rstrip(")").endswith("f") == (dtype == torch.float32), s  # the type's suffix


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_emitted_tables_are_the_packed_reals(name, dtype):
    """Every real table and scalar of the generated configuration holds
    `config_reals` rounded once to the type, as `pack_config` packs it."""
    _, data = _both(name)
    plan = _plan(data)
    src = codegen.config_source(plan, dtype)
    r = fc.config_reals(plan)
    real_t = _real_t(dtype)
    for key in ("thr", "norm", "inv_norm", "vel_c", "vel_e", "vel_g", "vel_me", "vel_hq2",
                "gl_y1", "gl_w", "win_v", "win_w"):
        m = re.search(rf"struct {key}_tab \{{.*?v\[\] = \{{(.*?)\}};", src, re.S)
        lits = [x.strip() for x in m.group(1).split(",")]
        want = np.asarray(r[key], np.float64).astype(real_t)
        if not len(want):
            continue
        got = np.asarray([_unhex(x) for x in lits], np.float64).astype(real_t)
        assert got.tobytes() == want.tobytes(), key
    for key in ("dt", "inv_dz", "two_thirds"):
        m = re.search(rf"static constexpr real {key} = (\S+);", src)
        assert np.asarray(real_t(_unhex(m.group(1)))).tobytes() == \
            np.asarray(real_t(r[key])).tobytes(), key


# --------------------------------------------------------------------------
# (c) the generated body as host C++
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`host_lib(name, dtype, kind)`: the generated `kind` configuration of a
    variant compiled as host C++ (g++, no FMA contraction) with `host_coal`,
    `host_rhs` and `host_gen_coal`; each compiled once per module."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the generated body on the host")
    libs = {}

    def get(name, dtype, kind):
        key = (name, dtype, kind)
        if key not in libs:
            _, data = _both(name)
            d = tmp_path_factory.mktemp(f"{name}_{kind}")
            (d / "shim").mkdir()
            (d / "shim" / "cuda_runtime.h").write_text(SHIM)
            (d / "cfg.cuh").write_text(codegen.config_source(_plan(data, kind), dtype, kind))
            (d / "host.cpp").write_text(HARNESS)
            so = d / "libhost.so"
            subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                            "-shared", "-Wno-unknown-pragmas", "-I", str(d / "shim"), "-I",
                            str(_build.CSRC), "-I", str(d), "-o", str(so),
                            str(d / "host.cpp")], check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(so))
            for f in (lib.host_coal, lib.host_rhs, lib.host_gen_coal):
                f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                f.restype = None
            libs[key] = lib
        return libs[key]

    return get


def _lanes(spec, B, seed):
    """Normalized moments [n_tot, B] of seeded physical parameters
    (tests/test_pallas.py:311-319): lognormal (n, μ, σ) ∈ [10, 200] ×
    [−2, 0.5] × [0.3, 1.2], gamma and exponential (n, θ, k) ∈ [10, 200] ×
    [0.05, 5] × [0.5, 5]; lane 3 empty."""
    rng = np.random.default_rng(seed)
    par = []
    for fam in spec.families:
        p1, p2 = ((-2.0, 0.5), (0.3, 1.2)) if fam == Family.LOGNORMAL else ((0.05, 5.0), (0.5, 5.0))
        par.append(np.stack([rng.uniform(10, 200, B), rng.uniform(*p1, B),
                             rng.uniform(*p2, B)], -1))
    mom = pd.get_moments(spec, torch.as_tensor(np.stack(par, 1))).numpy().T.copy()
    mom[:, 3] = 0.0
    return mom


def _call(f, x, n_out):
    out = torch.empty((n_out, x.shape[1]), dtype=x.dtype)
    f(x.data_ptr(), out.data_ptr(), x.shape[1])
    return out


def _row_scaled(got, want):
    d = (got.double() - want.double()).abs().amax(dim=1)
    return float((d / want.double().abs().amax(dim=1).clamp_min(1e-300)).max())


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_host_compiled_body_matches_twins(host_lib, variant, dtype):
    _, data = _both(variant)
    plan = _plan(data, "rhs")
    lib = host_lib(variant, dtype, "rhs")
    mom = torch.as_tensor(_lanes(data.spec, 512, seed=4), dtype=dtype)
    n_tot = plan.n_tot
    got = _call(lib.host_coal, mom, n_tot)
    want = fc.coal_soa_plain(mom, plan)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, want) < HOST_TOL[dtype]
    phys = (mom * torch.tensor(plan.mom_norms, dtype=dtype)[:, None]).contiguous()
    phys[0, 5] = -phys[0, 5]  # a negative moment: clipped
    got = _call(lib.host_rhs, phys, 2 * n_tot)
    want = fc.rainshaft_rhs_soa_plain(phys, plan)
    norm = torch.tensor(plan.mom_norms * 2, dtype=dtype)[:, None]
    assert _row_scaled(got / norm, want / norm) < HOST_TOL[dtype]
    assert bool((got[:n_tot, 3] == 0).all())  # the empty lane's tendency


def test_host_compiled_body_matches_pallas_interpret(host_lib):
    jdata, data = _both("moving")
    plan = _plan(data, "rhs")
    lib = host_lib("moving", torch.float64, "rhs")
    mom = _lanes(data.spec, 256, seed=6)
    got = _call(lib.host_coal, torch.as_tensor(mom), plan.n_tot).numpy()
    want = np.asarray(pc.make_pallas_coal_fn(jdata, block_cols=128, interpret=True)
                      .soa(jnp.asarray(mom)))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) / np.maximum(scale, 1e-300)).max() < 1e-9


# --------------------------------------------------------------------------
# the coalescence RHS (B3): the "coal" kind
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_coal_kind_source_digest_and_route(dtype):
    """The coal unit: kind 2, one thread per box in blocks of `THREADS`,
    the `gen_coal_body` shell; its digest differs from the fused RHS's of
    the same data; `make_coal_fn` routes a fast-tier plan to it."""
    _, data = _both("fixed2gamma")
    fn = fc.make_coal_fn(data, device="cpu", dtype=dtype)
    assert fn.route == "generated" and fn.plan == _plan(data, "coal")
    u = fn.unit
    assert (u.kind, u.threads, u.shfl, u.nz, u.n_tot) == ("coal", codegen.THREADS, False, 1, 6)
    assert "static constexpr int kKind = 2;" in u.cfg
    assert "gen_coal_body<Cfg>(mom, out, B);" in u.source
    assert "CLOUDY_GEN_ENTRY(cloudy::gen::Cfg, cloudy::gen::gen_coal)" in u.source
    assert u.digest != codegen.unit(_plan(data, "rhs"), dtype, "rhs").digest
    assert u.label == f"coal_{'f32' if dtype == torch.float32 else 'f64'}_{u.digest}"
    assert codegen.unit(fn.plan, dtype, "coal").digest == u.digest  # deterministic


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_generated_coal_shell_matches_twin(host_lib, variant, dtype):
    """The generated coalescence kernel's shell, run lane by lane as host
    C++, against the twin; the empty lane's tendency is zero."""
    _, data = _both(variant)
    plan = _plan(data, "coal")
    lib = host_lib(variant, dtype, "coal")
    mom = torch.as_tensor(_lanes(data.spec, 300, seed=8), dtype=dtype)
    got = _call(lib.host_gen_coal, mom, plan.n_tot)
    want = fc.coal_soa_plain(mom, plan)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, want) < HOST_TOL[dtype]
    assert bool((got[:, 3] == 0).all())


def test_generated_coal_shell_matches_pallas_interpret(host_lib):
    jdata, data = _both("fixed2gamma")
    lib = host_lib("fixed2gamma", torch.float64, "coal")
    mom = _lanes(data.spec, 256, seed=12)
    got = _call(lib.host_gen_coal, torch.as_tensor(mom), 6).numpy()
    want = np.asarray(pc.make_pallas_coal_fn(jdata, block_cols=128, interpret=True)
                      .soa(jnp.asarray(mom)))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) / np.maximum(scale, 1e-300)).max() < 1e-9


#: (B, multiprocessors, resident threads per multiprocessor of the
#: thread-per-box instance, layout): an H100 SXM (132 SMs) at the f64
#: instance's 256 and the f32 instance's 512, a smaller card, both sides of
#: the bound
LAYOUTS = [(128, 132, 256, "warp"), (8192, 132, 256, "warp"), (33792, 132, 256, "warp"),
           (33793, 132, 256, "thread"), (65536, 132, 256, "thread"),
           (65536, 132, 512, "warp"), (67585, 132, 512, "thread"),
           (1 << 20, 132, 512, "thread"), (1536, 48, 32, "warp"), (1537, 48, 32, "thread"),
           (1, 1, 1, "warp")]


def _ref_plan(**kw):
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(SpectrumSpec((G, G)), ker, (5e-10, np.inf), norms=NORMS,
                                  **kw)
    return fc.build_plan(data)


@pytest.mark.parametrize("B,n_sm,threads,want", LAYOUTS)
def test_reference_coal_layout_from_batch_and_card(B, n_sm, threads, want):
    """A warp per box up to one full wave of the thread-per-box instance,
    for a reference-tier plan with a quadrature grid; a thread per box for
    the same batch without a grid (exact F2 by series/CF) or at the fast
    tier."""
    assert fc.coal_layout(_ref_plan(), B, n_sm, threads) == want
    assert fc.coal_layout(_ref_plan(f2_exact=True), B, n_sm, threads) == "thread"
    assert fc.coal_layout(_plan(_both("fixed2gamma")[1], "coal"), B, n_sm, threads) == "thread"


def test_coal_layout_of_the_wrappers():
    """The fast tier and the CPU always run a thread per box; `_layout`
    forces a layout and is checked."""
    _, fast = _both("fixed2gamma")
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    ref = build_coalescence_data(SpectrumSpec((G, G)), ker, (5e-10, np.inf), norms=NORMS)
    for data in (fast, ref):
        fn = fc.make_coal_fn(data, device="cpu")
        assert fn.layout(128) == fn.layout(1 << 20) == "thread"
    fn = fc.CoalFn(fc.build_plan(ref), "cpu", torch.float64, _layout="warp")
    assert fn.route == "table" and fn.layout(128) == "thread"  # on the host: the twin
    with pytest.raises(ValueError):
        fc.CoalFn(fc.build_plan(ref), "cpu", torch.float64, _layout="block")


# --------------------------------------------------------------------------
# routes
# --------------------------------------------------------------------------


def test_routes_follow_the_plan():
    _, fast = _both("fixed2gamma")
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    ref = build_coalescence_data(SpectrumSpec((G, G)), ker, (5e-10, np.inf), norms=NORMS)
    kw = dict(nz=NZ, dz=DZ, dt=DT, device="cpu")
    step = fc.make_rainshaft_step_fn(fast, VEL, NORMS, **kw)
    rhs = fc.make_rainshaft_rhs_fn(fast, VEL, NORMS, device="cpu")
    assert (step.route, rhs.route) == ("generated", "generated")
    assert step.unit.kind == "step" and rhs.unit.kind == "rhs"
    assert step.unit.shfl and step.unit.digest != rhs.unit.digest
    # the reference tier of the whole step and the fused RHS is generated too
    assert fc.make_rainshaft_step_fn(ref, VEL, NORMS, **kw).route == "generated"
    assert fc.make_rainshaft_rhs_fn(ref, VEL, NORMS, device="cpu").route == "generated"
    scaled = fc.make_rainshaft_step_fn(fast, VEL, NORMS, kernel_scale=True, **kw)
    assert scaled.route == "generated" and scaled.unit.scaled and scaled.unit.kind == "step"
    assert scaled.unit.digest != step.unit.digest
    assert fc.ScaledRainshaftStepFn(scaled.plan, "cpu", torch.float32, _table=True).route == "table"
    assert fc.make_rainshaft_step_fn(ref, VEL, NORMS, kernel_scale=True, **kw).route == "generated"
    coal = fc.make_coal_fn(fast, device="cpu")
    assert coal.route == "generated" and coal.unit.kind == "coal"
    assert fc.make_coal_fn(ref, device="cpu").route == "table"
    assert fc.make_coal_fn(ref, device="cpu").unit is None
    assert fc.CoalFn(coal.plan, "cpu", torch.float32, _table=True).route == "table"
    assert fc.RainshaftStepFn(step.plan, "cpu", torch.float32, _table=True).route == "table"
    assert fc.make_rainshaft_step_fn(ref, VEL, NORMS, **kw).unit.kind == "step"
    with pytest.raises(ValueError):
        codegen.unit(fc.build_plan(ref), torch.float32, "coal")
    x = torch.ones(6, NZ)  # on the host the twin runs and nothing launches
    step(x), rhs.soa(x), coal.soa(x)
    assert step.launches == rhs.launches == coal.launches == 0


@pytest.mark.parametrize("nz,shfl,threads", [(32, True, codegen.THREADS),
                                             (16, True, codegen.THREADS),
                                             (128, False, max(128, codegen.THREADS // 128 * 128)),
                                             (48, False, codegen.THREADS // 48 * 48)])
def test_step_stencil_by_column_height(nz, shfl, threads):
    """A column of a power-of-two height ≤ 32 is a warp segment (shuffle);
    any other height blocks whole columns through shared memory."""
    _, data = _both("fixed2gamma")
    u = codegen.unit(fc.build_plan(data, VEL, NORMS, nz, 3000.0 / nz, DT), torch.float32)
    assert (u.shfl, u.threads, u.nz) == (shfl, threads, nz)
    assert f"kShfl = {'true' if shfl else 'false'}" in u.cfg


# --------------------------------------------------------------------------
# the build cache of generated units
# --------------------------------------------------------------------------

PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN6cloudy3gen8gen_stepEPKfPfx' for 'sm_90a'
ptxas info    : Function properties for _ZN6cloudy3gen8gen_stepEPKfPfx
    {stack} bytes stack frame, {stores} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 0 barriers, 380 bytes cmem[0]
"""


@pytest.mark.parametrize("stack,stores,spills", [(0, 0, False), (24, 0, True), (0, 8, True)])
def test_ptxas_report_and_spill_rule(stack, stores, spills):
    log = PTXAS_LOG.format(stack=stack, stores=stores)
    assert _build.ptxas_report(log) == {"registers": 58, "stack": stack,
                                        "spill_stores": stores, "spill_loads": 0}
    assert _build._spills(log) is spills


def test_unit_digest_covers_the_retry_rule(monkeypatch):
    """A unit's name changes with the flag its spilling build is redone
    with, so a library built under another rule is never reused."""
    _, data = _both("fixed2gamma")
    plan = fc.build_plan(data, VEL, NORMS, NZ, DZ, DT)
    before = codegen.unit(plan, torch.float32).digest
    assert codegen.unit(plan, torch.float32).digest == before
    monkeypatch.setattr(_build, "GEN_RETRY_FLAG", "-DCLOUDY_GEN_MIN_BLOCKS=2")
    assert codegen.unit(plan, torch.float32).digest != before


@pytest.mark.parametrize("name,retried", [("lib.so", False), ("lib.minblocks1.so", True)])
def test_built_library_names_its_flags(tmp_path, monkeypatch, name, retried):
    """A built unit is found by its library's name, which says whether it was
    rebuilt with the retry flag; nothing is compiled for it again."""
    monkeypatch.setattr(_build, "GEN_DIR", tmp_path)
    _, data = _both("fixed2gamma")
    u = codegen.unit(fc.build_plan(data, VEL, NORMS, NZ, DZ, DT), torch.float32, "rhs")
    d = tmp_path / u.digest
    d.mkdir()
    (d / name).write_bytes(b"")
    (d / "build.log").write_text(PTXAS_LOG.format(stack=0, stores=0))
    rec, = _build.build_generated([u, u])
    assert (rec["path"], rec["retried"], rec["built"]) == (d / name, retried, False)
    assert _build.ptxas_report(rec["log"])["registers"] == 58


def test_generated_sources_are_written_whole(tmp_path):
    p = tmp_path / "cfg.cuh"
    _build._write(p, "old")
    _build._write(p, "new")
    assert p.read_text() == "new" and [q.name for q in tmp_path.iterdir()] == ["cfg.cuh"]
