"""Configurations past the prebuilt kernels' capacities, and the scaled
whole step at the reference tier, on the CPU against the JAX package.

The four-gamma-mode spectrum of examples/box_gamma_mixture_4modes.py
(thresholds 5e-10, 5e-9, 5e-8, ∞ kg; n_tot 12, M 4), which the prebuilt
table-driven kernels (3 modes, 9 moments) do not hold:

(a) through the plain twins of B3 (the coalescence RHS), B4 (the fused RHS)
    and B1 (the whole step) at the fast tier against the Pallas kernels in
    interpret mode (`make_pallas_coal_fn`, `make_pallas_rainshaft_rhs_fn`,
    `make_pallas_rainshaft_step_fn`, 16 columns × 8 levels), through B5's
    twin against `make_pallas_numerical_fn` in interpret mode, and through
    the reference-tier twins of B3, B4 and B1 against JAX's XLA path
    (`coalescence.make_coal_rhs`, `make_rainshaft_rhs` + `ssprk33_step`: an
    interpret-mode reference whole step traces for ~28 s per call); f64,
    row-scaled 1e-9 (each row over its largest magnitude: sums in another
    order; tests/test_pallas.py:656), B5 as tests/test_torch_numerical.py
    holds two modes;
(b) the generated units sized from the configuration, compiled as host C++
    (a shim defines the CUDA qualifiers away and emulates a warp's
    `__shfl_down_sync` with 32 threads at a barrier, so the whole step's
    shuffle stencil runs as on the card): the coalescence and whole-step
    shells against the twins, f64 ≤ 1e-12 and f32 ≤ 1e-5 row-scaled (the
    same operations in the same order without FMA contraction; glibc's and
    torch's exp/log differ in the last bits), and the scaled step's unit
    at a different s per column against the scaled twin;
(c) the scaled whole step (B1s) at the reference tier: its twin against
    JAX's `fn_scaled` in interpret mode (a reference plan, f64, one call,
    < 1e-9), and s = 1.7 against the unscaled reference twin built from the
    1.7-scaled kernel tensor (< 1e-9, tests/test_torch_calibrate.py's check
    at the fast tier);
(d) the routes and units each wrapper takes, and the scaled unit's text:
    the unscaled one's with one line more.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cloudy_tpu import kernels as JK
from cloudy_tpu import stepper as jstepper
from cloudy_tpu.coalescence import make_coal_rhs as jmake_coal_rhs
from cloudy_tpu.models import rainshaft as jrs
from cloudy_tpu.ops import pallas_coalescence as pc
from cloudy_tpu.ops import pallas_numerical as pn
from cloudy_tpu.spec import Family as JF, SpectrumSpec as JSpec

import _four_modes_reference as ref
from _four_modes_reference import DZ, NORMS, NZ, VEL
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import _build, codegen
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.spec import Family, SpectrumSpec

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

TOL = 1e-9
HOST_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
G4 = (Family.GAMMA,) * 4
N_COLS = 16


def _state(n_cols=N_COLS, seed=0):
    return torch.as_tensor(ref.state(n_cols, seed))


def _row_scaled(got, want, norm=None):
    """max over rows of |got − want| / max|want| of the row ([n, B]); rows
    first divided by `norm` ([n] moment norms) where given."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if norm is not None:
        got, want = got / np.asarray(norm)[:, None], want / np.asarray(norm)[:, None]
    d = np.abs(got - want).max(axis=1)
    return float((d / np.maximum(np.abs(want).max(axis=1), 1e-300)).max())


# --------------------------------------------------------------------------
# (a) the twins against JAX
# --------------------------------------------------------------------------


def test_four_mode_plans_route_and_pack():
    """Both tiers build; the whole step, its scaled form and the fused RHS
    are generated for the plan at either tier, the reference tier's
    coalescence RHS and the table-driven yardsticks run units at capacities
    (4, 12, 5); the packed configuration holds four per-mode slots and the
    layout of those capacities."""
    _, fast = ref.data()
    _, refd = ref.data(fast=False)
    step = fc.make_rainshaft_step_fn(fast, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu")
    assert step.route == "generated" and step.caps is None
    assert step.unit.n_tot == 12 and "kModes = 4, kNtot = 12, kM = 5;" in step.unit.cfg
    rstep = fc.make_rainshaft_step_fn(refd, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu")
    assert rstep.route == "generated" and rstep.caps is None and rstep.unit.n_tot == 12
    assert "kModes = 4, kNtot = 12, kM = 5;" in rstep.unit.cfg and "kRef = true" in rstep.unit.cfg
    rtable = fc.RainshaftStepFn(rstep.plan, "cpu", torch.float32, _table=True)
    assert rtable.route == "table" and rtable.caps == (4, 12, 5) and rtable.unit is None
    plan = rstep.plan
    assert (plan.n_modes, plan.n_tot, plan.M) == (4, 12, 4)
    assert [len(g[0]) for g in plan.grids[:3]] == [76, 86, 101] and plan.grids[3] is None
    ints = fc.pack_config(plan, torch.float64).view(np.int32)
    h = fc.header_ints((4, 12, 5))
    assert h == 24 and list(ints[16:h]) == [fc.F2_GRID] * 3 + [fc.F2_NONE, 76, 86, 101, 0]
    assert list(ints[h:h + 16]) == [1] * 4 + [0, 3, 6, 9] + [3] * 4 + [1, 1, 1, 0]
    with pytest.raises(ValueError, match="exceeds the capacities"):
        fc.pack_config(plan, torch.float64, fc.CAPS)
    kinds = {"coal": fc.make_coal_fn(refd, device="cpu"),
             "rhs": fc.make_rainshaft_rhs_fn(refd, VEL, NORMS, device="cpu"),
             "step": rstep,
             "scaled": fc.make_rainshaft_step_fn(refd, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0,
                                                 device="cpu", kernel_scale=True)}
    assert {k: [u.kind for u in fn.build_units()] for k, fn in kinds.items()} == {
        "coal": ["ref_coal", "ref_warp"], "rhs": ["rhs"], "step": ["step"], "scaled": ["step"]}
    assert kinds["scaled"].build_units()[0].scaled
    tables = {k: type(fn)(fn.plan, "cpu", torch.float32, _table=True)
              for k, fn in kinds.items() if k != "coal"}
    assert {k: [u.kind for u in fn.build_units()] for k, fn in tables.items()} == {
        "rhs": ["ref_rhs"], "step": ["ref_step"], "scaled": ["ref_step_scaled"]}
    su = tables["scaled"].build_units()[0]
    assert su.flags == ("-fmad=false",) and "CLOUDY_CAP_NTOT 12" in su.source
    assert "CLOUDY_REF_ENTRY(float, STEP_SCALED)" in su.source


def test_four_mode_coal_twin_matches_pallas():
    """B3's twin (fast tier) against `make_pallas_coal_fn` in interpret
    mode, 256 boxes, f64."""
    jd, td = ref.data()
    mom = ref.moments(256, seed=1)
    want = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=128, interpret=True)
                      .soa(jnp.asarray(mom)))
    fn = fc.make_coal_fn(td, device="cpu", dtype=torch.float64)
    got = fn.soa(torch.as_tensor(mom)).numpy()
    assert np.isfinite(got).all() and (got[:, 3] == 0).all()
    assert _row_scaled(got, want) < TOL


def test_four_mode_rhs_twin_matches_pallas():
    """B4's twin (fast tier) against `make_pallas_rainshaft_rhs_fn` in
    interpret mode, 16 columns × 8 levels, f64; rows normalized by their
    moment norms."""
    jd, td = ref.data()
    state = _state()
    want = np.asarray(pc.make_pallas_rainshaft_rhs_fn(jd, VEL, NORMS, block_cols=128,
                                                      interpret=True)
                      .soa(jnp.asarray(state.numpy())))
    fn = fc.make_rainshaft_rhs_fn(td, VEL, NORMS, device="cpu", dtype=torch.float64)
    got = fn.soa(state).numpy()
    assert _row_scaled(got, want, fn.plan.mom_norms * 2) < TOL


def test_four_mode_step_twin_matches_pallas():
    """B1's twin (fast tier), one whole step, against
    `make_pallas_rainshaft_step_fn` in interpret mode, 16 columns × 8
    levels, f64."""
    jd, td = ref.data()
    state = _state()
    want = np.asarray(pc.make_pallas_rainshaft_step_fn(
        jd, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, block_cols=128, interpret=True)(
            jnp.asarray(state.numpy())))
    fn = fc.make_rainshaft_step_fn(td, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu",
                                   dtype=torch.float64)
    got = fn(state).numpy()
    assert np.isfinite(got).all()
    assert _row_scaled(got, want, fn.plan.mom_norms) < TOL


def test_four_mode_numerical_twin_matches_pallas():
    """B5's twin at four gamma modes (the linear kernel, (16, 8) nodes)
    against `make_pallas_numerical_fn` in interpret mode, 128 boxes, f64;
    the prebuilt library holds three modes, so a card runs the unit built
    for four (`NumericalFn.unit`)."""
    nodes = ref.NUM_NODES
    kf = K.LinearKernelFunction(5.0).normalized(NORMS)
    jkf = JK.LinearKernelFunction(5.0).normalized(NORMS)
    mom = ref.moments(128, seed=2)
    want = np.asarray(pn.make_pallas_numerical_fn(JSpec((JF.GAMMA,) * 4), jkf, **nodes,
                                                  block_cols=128, interpret=True)(
        jnp.asarray(mom.T.copy()))).T
    fn = nc.make_numerical_fn(SpectrumSpec(G4), kf, **nodes, device="cpu",
                              dtype=torch.float64)
    assert fn.unit is not None and fn.unit.kind == "numerical"
    assert "CLOUDY_NUMERICAL_UNIT_ENTRY(double, 4)" in fn.unit.source
    got = fn.soa(torch.as_tensor(mom)).numpy()
    assert np.isfinite(got).all()
    assert _row_scaled(got, want) < TOL
    # the packed per-mode tables take four slots each; 512 outer nodes build
    ints = nc.pack_config(fn.plan, torch.float64).view(np.int32)
    assert nc.layout(4) == (4, 3, nc.HEADER_INTS)
    assert list(ints[nc.HEADER_INTS:nc.HEADER_INTS + 12]) == [1] * 4 + [0, 3, 6, 9] + [3] * 4
    wide = nc.make_numerical_fn(SpectrumSpec(G4), kf, n_outer=512, n_inner=8, device="cpu")
    assert wide.plan.g_total == 512
    with pytest.raises(ValueError, match="replaced body"):
        nc.NumericalFn(wide.plan, "cpu", torch.float32, _direct=True)


def test_four_mode_reference_twins_match_xla():
    """The reference tier (Simpson grids of 76, 86 and 101 points,
    series/CF) through B3's and B4's twins against `make_coal_rhs` (JAX's
    XLA path) on physical moments, and one whole step of B1's twin against
    JAX's `make_rainshaft_rhs` + `ssprk33_step` (XLA), 4 columns × 8
    levels, f64."""
    jd, td = ref.data(fast=False)
    plan = fc.build_plan(td, VEL, NORMS, NZ, DZ, 1.0)
    norm = np.asarray(plan.mom_norms)
    mom = ref.moments(64, seed=3)
    want = np.asarray(jax.jit(jmake_coal_rhs(jd, NORMS))(jnp.asarray((mom * norm[:, None]).T)))
    coal = fc.make_coal_fn(td, device="cpu", dtype=torch.float64)
    got = coal.soa(torch.as_tensor(mom)).numpy() * norm[:, None]
    assert coal.caps == (4, 12, 5)
    assert _row_scaled(got, want.T) < TOL
    rhs = fc.make_rainshaft_rhs_fn(td, VEL, NORMS, device="cpu", dtype=torch.float64)
    phys = torch.as_tensor(mom * norm[:, None])
    got = rhs.soa(phys).numpy()[:12]
    empty = (mom < np.finfo(np.float64).eps).all(axis=0)
    assert _row_scaled(got[:, ~empty], want.T[:, ~empty]) < TOL
    assert (got[:, empty] == 0).all()
    state = _state(4)
    config = jrs.RainshaftConfig(spec=jd.spec, nz=NZ, zmax=3000.0, norms=NORMS)
    jrhs = jax.jit(jrs.make_rainshaft_rhs(config, jd))
    st = rs.from_soa(state, NZ).numpy()
    want = np.asarray(jstepper.ssprk33_step(jrhs, jnp.asarray(st), 0.0, 1.0))
    step = fc.make_rainshaft_step_fn(td, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu",
                                     dtype=torch.float64)
    got = rs.from_soa(step(state), NZ).numpy()
    assert _row_scaled(got.reshape(-1, 12).T, want.reshape(-1, 12).T, norm) < TOL


# --------------------------------------------------------------------------
# (b) the generated four-mode units as host C++
# --------------------------------------------------------------------------

#: the CUDA names the generated bodies use, for a host compile; a warp's
#: shuffle is 32 threads exchanging through a buffer between two barrier
#: waits (`__shfl_down_sync` semantics: the source lane + delta, or the
#: caller's own value where that leaves its segment of `width` lanes)
SHIM = """#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <math.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static thread_local uint3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static uint3 blockDim = {1, 1, 1};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline void __syncthreads() {}
static std::barrier<>* shim_warp = nullptr;
alignas(16) static unsigned char shim_buf[32 * 8];
template <class T> T __shfl_down_sync(unsigned, T v, int delta, int width) {
  const int lane = threadIdx.x & 31;
  T* buf = reinterpret_cast<T*>(shim_buf);
  buf[lane] = v;
  shim_warp->arrive_and_wait();
  const int src = lane + delta;
  const T got = (src < 32 && src / width == lane / width) ? buf[src] : v;
  shim_warp->arrive_and_wait();
  return got;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
"""

HARNESS = """#include <thread>
#include <vector>
#include "gen_kernels.cuh"
#include "cfg.cuh"
using cloudy::gen::Cfg;
using T = Cfg::real;
// the shared-memory stencil's rows (a whole step at an nz no warp segment
// holds; never read by the kernels compiled here)
namespace cloudy { alignas(16) unsigned char gen_smem[16]; }
// the generated coalescence kernel's shell, one "thread" at a time
extern "C" void host_gen_coal(const T* mom, T* out, long long B) {
  for (long long lane = 0; lane < B; ++lane) {
    blockIdx.x = (unsigned)(lane / Cfg::kThreads);
    threadIdx.x = (unsigned)(lane % Cfg::kThreads);
    cloudy::gen_coal_body<Cfg>(mom, out, B);
  }
}
// the generated whole step's shell, one warp of 32 threads at a time
extern "C" void host_gen_step(const T* mom, T* out, long long B, const T* scale) {
  for (long long w = 0; w < (B + 31) / 32; ++w) {
    std::barrier<> bar(32);
    shim_warp = &bar;
    std::vector<std::thread> th;
    for (int l = 0; l < 32; ++l)
      th.emplace_back([&, l] {
        const long long lane = w * 32 + l;
        blockIdx.x = (unsigned)(lane / Cfg::kThreads);
        threadIdx.x = (unsigned)(lane % Cfg::kThreads);
        cloudy::gen_step_body<Cfg>(mom, out, B, scale);
      });
    for (auto& t : th) t.join();
  }
  shim_warp = nullptr;
}
"""


@pytest.fixture(scope="module")
def host_unit(tmp_path_factory):
    """`host_unit(unit)`: a generated unit's configuration compiled as host
    C++ (g++, C++20 for the barrier, no FMA contraction) with the shells of
    `HARNESS`; each compiled once per module."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the generated body on the host")
    libs = {}

    def get(u):
        if u.digest not in libs:
            d = tmp_path_factory.mktemp(u.label)
            (d / "shim").mkdir()
            (d / "shim" / "cuda_runtime.h").write_text(SHIM)
            (d / "cfg.cuh").write_text(u.cfg)
            (d / "host.cpp").write_text(HARNESS)
            so = d / "libhost.so"
            subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                            "-pthread", "-Wno-unknown-pragmas", "-I", str(d / "shim"), "-I",
                            str(_build.CSRC), "-I", str(d), "-o", str(so), str(d / "host.cpp")],
                           check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(so))
            lib.host_gen_coal.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
            lib.host_gen_step.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                                    ctypes.c_void_p]
            libs[u.digest] = lib
        return libs[u.digest]

    return get


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_four_mode_coal_unit_as_host_cpp(host_unit, dtype):
    """The generated four-mode coalescence RHS, lane by lane, against the
    twin; the empty box's tendency is zero."""
    _, td = ref.data()
    fn = fc.make_coal_fn(td, device="cpu", dtype=dtype)
    lib = host_unit(fn.unit)
    mom = torch.as_tensor(ref.moments(300, seed=4), dtype=dtype)
    got = torch.empty_like(mom)
    lib.host_gen_coal(mom.data_ptr(), got.data_ptr(), mom.shape[1])
    assert bool(torch.isfinite(got).all()) and bool((got[:, 3] == 0).all())
    assert _row_scaled(got, fn.plain(mom)) < HOST_TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_four_mode_step_units_as_host_cpp(host_unit, dtype):
    """The generated four-mode whole step, its shuffle stencil on emulated
    warps, against the twin; and the scaled step's unit at s from 0.4 to
    2.5 by column against the scaled twin."""
    _, td = ref.data()
    step = fc.make_rainshaft_step_fn(td, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu",
                                     dtype=dtype)
    scaled = fc.make_rainshaft_step_fn(td, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu",
                                       dtype=dtype, kernel_scale=True)
    assert step.unit.shfl and scaled.unit.scaled and step.unit.digest != scaled.unit.digest
    x = _state().to(dtype)
    norm = step.plan.mom_norms
    got = torch.empty_like(x)
    host_unit(step.unit).host_gen_step(x.data_ptr(), got.data_ptr(), x.shape[1], None)
    assert bool(torch.isfinite(got).all())
    assert _row_scaled(got, step.plain(x), norm) < HOST_TOL[dtype]
    s = torch.linspace(0.4, 2.5, N_COLS, dtype=dtype).repeat_interleave(NZ).contiguous()
    host_unit(scaled.unit).host_gen_step(x.data_ptr(), got.data_ptr(), x.shape[1],
                                         s.data_ptr())
    want = scaled.plain(x, s)
    assert _row_scaled(got, want, norm) < HOST_TOL[dtype]
    assert _row_scaled(step.plain(x), want, norm) > 1e-3  # the scale acts


# --------------------------------------------------------------------------
# (c) the scaled whole step at the reference tier
# --------------------------------------------------------------------------

def test_scaled_reference_step_matches_pallas():
    """The scaled whole step's twin at the reference tier (Simpson grid,
    series/CF at 32 iterations, as tests/test_torch_reference_tier.py's
    step) against JAX's `fn_scaled` in interpret mode, 4 columns × 8
    levels, a different scale per column, f64."""
    jd, td = ref.data(2, fast=False)
    state = torch.as_tensor(ref.state(4, seed=5, n_modes=2, defects=False))
    s_row = np.repeat(np.linspace(0.4, 2.5, 4), NZ)
    kw = dict(gammainc_iters=ref.SCALED_REF_ITERS)
    want = np.asarray(pc.make_pallas_rainshaft_step_fn(
        jd, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, block_cols=32, interpret=True,
        kernel_scale=True, **kw)(jnp.asarray(state.numpy()), jnp.asarray(s_row)[None]))
    fn = fc.make_rainshaft_step_fn(td, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, device="cpu",
                                   dtype=torch.float64, kernel_scale=True, **kw)
    assert isinstance(fn, fc.ScaledRainshaftStepFn)
    assert fn.plan.instance == 2 and fn.route == "generated" and fn.unit.scaled
    got = fn(state, torch.as_tensor(s_row)).numpy()
    assert _row_scaled(got, want, fn.plan.mom_norms) < TOL
    assert fn.launches == 0


def test_scaled_reference_step_equals_scaled_tensor():
    """s = 1.7 on every lane of the reference-tier scaled twin against the
    unscaled reference twin built from the 1.7-scaled kernel tensor, f64
    (the Q/R/S assembly is linear in the tensor)."""
    _, td = ref.data(2, fast=False)
    _, td_s = ref.data(2, fast=False, tensor_scale=1.7)
    x = torch.as_tensor(ref.state(2, seed=6, n_modes=2, defects=False))
    x = x * torch.linspace(0.6, 1.4, x.shape[1], dtype=torch.float64)
    kw = dict(nz=NZ, dz=DZ, dt=1.0, device="cpu", dtype=torch.float64,
              gammainc_iters=ref.SCALED_REF_ITERS)
    scaled = fc.make_rainshaft_step_fn(td, VEL, NORMS, kernel_scale=True, **kw)
    want = fc.make_rainshaft_step_fn(td_s, VEL, NORMS, **kw)(x).numpy()
    assert scaled.plan.instance == 2
    for s in (1.7, torch.full((x.shape[1],), 1.7, dtype=torch.float64)):
        assert _row_scaled(scaled(x, s).numpy(), want) < TOL


# --------------------------------------------------------------------------
# (d) the scaled unit's text
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_scaled_unit_text_is_the_unscaled_one_plus_kscale(dtype):
    """The pod `fixed2gamma` step: the unscaled unit's text has no `kScale`
    (csrc/gen_kernels.cuh `Scaled` is false for it), and the scaled unit's
    configuration is the unscaled one with that one line more; its kernel
    takes the scale row and ends with the scaled entry."""
    from cloudy_tpu_torch import harness

    _, data = harness.pod_data("fixed2gamma")
    plan = fc.build_plan(data, VEL, NORMS, 32, 3000.0 / 32, 1.0)
    u = codegen.unit(plan, dtype, "step")
    su = codegen.unit(plan, dtype, "step", scaled=True)
    assert "kScale" not in u.cfg and "scale" not in u.source
    extra = [ln for ln in su.cfg.splitlines() if ln not in u.cfg.splitlines()]
    assert extra == ["  static constexpr bool kScale = true;"]
    assert su.cfg.replace("\n" + extra[0], "") == u.cfg
    assert "CLOUDY_GEN_SCALED_ENTRY(cloudy::gen::Cfg, cloudy::gen::gen_step)" in su.source
    assert "gen_step_body<Cfg>(mom, out, B, scale);" in su.source
    assert su.label.startswith("step_scaled_") and u.label.startswith("step_")
    with pytest.raises(ValueError, match="kernel scale"):
        codegen.unit(plan, dtype, "rhs", scaled=True)


# --------------------------------------------------------------------------
# the stored JAX outputs the card's kernels are held against
# --------------------------------------------------------------------------


def test_stored_jax_outputs_match_the_twins():
    """tests/golden_torch/four_modes.npz (`_four_modes_reference`, which
    tests/test_torch_cuda_kernels.py holds the card against) is JAX's: its
    B3 array equals a fresh interpret-mode call bit for bit, and every array
    agrees with the port's twins on its stored inputs (f64, < 1e-9)."""
    st = ref.load()
    jd, td = ref.data()
    fresh = np.asarray(pc.make_pallas_coal_fn(jd, block_cols=64, interpret=True)
                       .soa(jnp.asarray(st["coal_mom"])))
    np.testing.assert_array_equal(fresh, st["coal_fast"])
    f64 = dict(device="cpu", dtype=torch.float64)
    x, mom = torch.as_tensor(st["state"]), torch.as_tensor(st["coal_mom"])
    coal = fc.make_coal_fn(td, **f64)
    assert _row_scaled(coal.soa(mom), st["coal_fast"]) < TOL
    rhs = fc.make_rainshaft_rhs_fn(td, VEL, NORMS, **f64)
    assert _row_scaled(rhs.soa(x), st["rhs_fast"], rhs.plan.mom_norms * 2) < TOL
    step = fc.make_rainshaft_step_fn(td, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, **f64)
    assert _row_scaled(step(x), st["step_fast"], step.plan.mom_norms) < TOL
    _, tr = ref.data(fast=False)
    rcoal = fc.make_coal_fn(tr, **f64)
    norm = np.asarray(step.plan.mom_norms)[:, None]
    assert _row_scaled(rcoal.soa(mom).numpy() * norm, st["coal_ref_phys"]) < TOL
    rstep = fc.make_rainshaft_step_fn(tr, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, **f64)
    assert _row_scaled(rstep(x), st["step_ref"], rstep.plan.mom_norms) < TOL
    num = nc.make_numerical_fn(SpectrumSpec(G4), K.LinearKernelFunction(5.0).normalized(NORMS),
                               **ref.NUM_NODES, **f64)
    assert _row_scaled(num.soa(torch.as_tensor(st["num_mom"])), st["num"]) < TOL
    _, t2 = ref.data(2, fast=False)
    scaled = fc.make_rainshaft_step_fn(t2, VEL, NORMS, nz=NZ, dz=DZ, dt=1.0, kernel_scale=True,
                                       gammainc_iters=ref.SCALED_REF_ITERS, **f64)
    got = scaled(torch.as_tensor(st["scaled_state"]), torch.as_tensor(st["scale"]))
    assert _row_scaled(got, st["scaled_ref"], scaled.plan.mom_norms) < TOL
