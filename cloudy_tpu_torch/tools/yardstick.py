"""The generated whole step (B1), fused per-level RHS (B4) and coalescence
RHS (B3) against their table-driven fast instances on the card: the
wrappers of both routes from the same plan, their build reports
(``ptxas``, SASS counts, resident blocks per SM), the check against the
plain twin and the timing in turns. `tools.codegen_tune` and
chip_smoke.py's phases 23 and 24 use it.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from cloudy_tpu_torch import harness
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import _build
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.tools import whole_step_ablation as wsa

VARIANTS = ("fixed2gamma", "moving", "lognorm")
NORMS = (1e6, 1e-9)
NZ = 32
TOL = {torch.float32: 1e-4, torch.float64: 1e-9}


def pod_config(variant: str, nz: int = NZ):
    """(spec, data, RainshaftConfig) of a pod variant at nz levels, as
    `harness._scenario_pod_ensemble` builds them, or of a family-matrix case
    (`tools.whole_step_ablation.CASE_NAMES`; its kernel keywords are not
    passed, so a reference-tier case runs here at the keywords' defaults:
    `tools.reference_tune` runs those cases as the matrix does)."""
    if variant in wsa.CASE_NAMES:
        data, _ = wsa.case_data(variant)
        spec = data.spec
    else:
        spec, data = harness.pod_data(variant)
    cfg = rs.RainshaftConfig(spec=spec, nz=nz, zmax=3000.0, norms=NORMS, t_end=120.0,
                             dt=1.0)
    return spec, data, cfg


def make_fns(variant: str, kind: str, device="cuda", dtype=torch.float32, nz: int = NZ):
    """(generated, table-driven) wrappers of a pod variant's `kind` kernel."""
    _, data, cfg = pod_config(variant, nz)
    if kind == "coal":
        gen = fc.make_coal_fn(data, device=device, dtype=dtype)
        table = fc.CoalFn(gen.plan, device, dtype, _table=True)
    elif kind == "step":
        gen = fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=nz, dz=cfg.dz,
                                        dt=cfg.dt, device=device, dtype=dtype)
        table = fc.RainshaftStepFn(gen.plan, device, dtype, _table=True)
    else:
        gen = fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, device=device, dtype=dtype)
        table = fc.RainshaftRhsFn(gen.plan, device, dtype, _table=True)
    return gen, table


def table_report(kind: str, dtype, arms: int, plan, scaled: bool = False, ref: bool = False,
                 units=()) -> dict:
    """ptxas, SASS counts and blocks per SM of a table-driven instance: the
    fast one, or with `ref` the reference tier's, from the unit built at
    first use among `units` where the wrapper has one (its
    `build_units()`), else from the library. The scaled whole step
    (`scaled`) and a reference instance report no blocks per SM (None)."""
    tag = "f" if dtype == torch.float32 else "d"
    if units:
        rec, = _build.build_generated(units)
        so, log = rec["path"], rec.get("log", "")
    else:
        _build.load_library()
        so = _build.library_path()
        log = so.with_suffix(".log").read_text()
    if kind == "step":
        pat = rf"step_kernelI{tag}Lb{arms}ELb{int(scaled)}ELb{int(ref)}E"
    else:
        pat = rf"{kind}_kernelI{tag}Lb{arms}ELb{int(ref)}E"
    sass = {k: v for k, v in _build.sass_counts(so).items() if re.search(pat, k)}
    keep, pt = False, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = bool(re.search(pat, ln))
        if keep:
            pt += ln + "\n"
    report = {"ptxas": _build.ptxas_report(pt), "sass": next(iter(sass.values()), {}),
              "blocks_per_sm": None}
    if scaled or ref:
        return report
    lib = _build.load_library()
    cfg_bytes = fc.pack_config(plan, dtype).size
    got = ctypes.c_int(0)
    t = "f32" if dtype == torch.float32 else "f64"
    if kind == "step":
        err = getattr(lib, f"cloudy_step_blocks_per_sm_{t}")(cfg_bytes, plan.nz, arms,
                                                            ctypes.byref(got))
    else:
        err = getattr(lib, f"cloudy_{kind}_blocks_per_sm_{t}")(cfg_bytes, arms,
                                                              ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return {**report, "blocks_per_sm": got.value}


def gen_report(unit, record) -> dict:
    """ptxas, build seconds, SASS counts and blocks per SM of a generated
    unit."""
    lib = _build.load_generated(unit)
    got = ctypes.c_int(0)
    err = lib.cloudy_gen_blocks_per_sm(ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    sass = _build.sass_counts(record["path"])
    return {"ptxas": _build.ptxas_report(record.get("log", "")), "nvcc_s": record["seconds"],
            "retried": record["retried"],
            "sass": next(iter(sass.values()), {}), "blocks_per_sm": got.value,
            "threads": unit.threads, "shfl": unit.shfl}


def _row_scaled(got, want):
    d = (got.double() - want.double()).abs().amax(dim=1)
    return float((d / want.double().abs().amax(dim=1).clamp_min(1e-300)).max())


def coal_moments(variant: str, n: int, device, dtype, seed: int = 0) -> torch.Tensor:
    """Normalized moments [6, n] for a pod variant's coalescence RHS (B3):
    bench.py's for two gamma modes (joint amplitude and mass scalings per
    mode), for ``lognorm`` parameters drawn first (lognormal μ ∈ [−2, 0.5],
    σ ∈ [0.3, 1.2]; gamma θ ∈ [0.05, 5], k ∈ [0.5, 5];
    tests/test_pallas.py:311-319)."""
    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch import distributions as pd

    spec, _, _ = pod_config(variant)
    if variant != "lognorm":
        return torch.as_tensor(bench.bench_moments(n, seed=seed).T.copy(), dtype=dtype,
                               device=device)
    rng = np.random.default_rng(seed)
    par = np.stack([
        np.stack([rng.uniform(10, 200, n), rng.uniform(-2.0, 0.5, n),
                  rng.uniform(0.3, 1.2, n)], -1),
        np.stack([rng.uniform(10, 200, n), rng.uniform(0.05, 5.0, n),
                  rng.uniform(0.5, 5.0, n)], -1)], axis=1)
    return pd.get_moments(spec, torch.as_tensor(par)).T.contiguous().to(device, dtype)


def twin_errors(fns, kind, x, scale=None) -> list:
    """[(row-scaled error, finite)] of one launch of each wrapper of one
    plan in `fns` against the twin on `x` (the whole step and the fused RHS
    in normalized units; a scaled whole step with the [B] row `scale`)."""
    plan = fns[0].plan
    if kind == "coal":
        want, outs, norm = fns[0].plain(x), [fn.soa(x) for fn in fns], 1.0
    else:
        norm = torch.tensor(plan.mom_norms, dtype=x.dtype, device=x.device)[:, None]
        if kind == "step":
            args = (x,) if scale is None else (x, scale)
            want, outs = fns[0].plain(*args), [fn(*args) for fn in fns]
        else:
            want, outs, norm = fns[0].plain(x), [fn.soa(x) for fn in fns], torch.cat([norm, norm])
    torch.cuda.synchronize()
    return [(_row_scaled(got / norm, want / norm), bool(torch.isfinite(got).all()))
            for got in outs]


def check_vs_twin(fn, kind, variant, device, dtype, n_cols: int = 4096, nz: int = NZ):
    """Row-scaled error (normalized units) of one launch against the twin on
    a seeded two-mode state with a negative moment and an empty level (the
    coalescence RHS: on `coal_moments` of n_cols · nz boxes)."""
    if kind == "coal":
        return twin_errors([fn], kind, coal_moments(variant, n_cols * nz, device, dtype, seed=2))[0]
    spec, _, cfg = pod_config(variant, nz)
    amps = ([1e8, 1e-2, 2e-12], [1e7, 1e-3, 2e-13], [1e6, 1e-4, 2e-14])
    ic = np.concatenate([rs.initial_condition(cfg.z, a)[:, :n]
                         for a, n in zip(amps, spec.nprogmoms)], axis=-1)
    amp = np.random.default_rng(2).uniform(0.5, 1.5, (n_cols, 1, 1))
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, nz // 2, 0] *= -1.0
    st[1, nz // 2 + 1, :] = -1e-3
    x = rs.to_soa(torch.as_tensor(st)).to(device, dtype).contiguous()
    return twin_errors([fn], kind, x)[0]


def pod_state(variant: str, n_columns: int, device, dtype):
    """The pod's initial state [6, n_columns · 32] (mode 1 seeded, mode 2
    empty), as `harness._scenario_pod_ensemble`."""
    spec, _, cfg = pod_config(variant)
    ic1 = rs.initial_condition(cfg.z, [1e8, 1e-2, 2e-12])[:, :spec.nprogmoms[0]]
    ic = np.concatenate([ic1, np.zeros((ic1.shape[0], spec.n_tot - ic1.shape[1]))], axis=-1)
    return torch.as_tensor(ic.T.copy(), dtype=dtype, device=device).repeat(1, n_columns)


def turns(calls, x, steps: int, chain: bool = True):
    """ms per call of each of `calls` (``call(y)`` → y'), in turns 0, 1, …,
    1, 0, the median of each: chains of `steps` calls from x (`chain`), or
    `steps` calls on x. Returns (medians, {i: [ms per turn]})."""
    def one(call):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        y = x
        start.record()
        for _ in range(steps):
            y = call(y) if chain else call(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps

    order = list(range(len(calls)))
    times = {i: [] for i in order}
    for i in order + order[::-1]:
        times[i].append(one(calls[i]))
    return [float(np.median(times[i])) for i in order], times


def time_turns(fns, kind, x, steps: int, scale=None):
    """ms per step (chains of `steps` whole steps from x; scaled steps with
    the [B] row `scale`) or per launch, of each of two wrappers, in turns
    a, b, b, a; the median of each."""
    def call(fn, y):
        if kind != "step":
            return fn.soa(y)
        return fn(y) if scale is None else fn(y, scale[:y.shape[1]])

    for fn in fns:  # warm-up: builds, loads (a whole step: one column)
        call(fn, x[:, :fn.plan.nz if kind == "step" else NZ].contiguous())
    torch.cuda.synchronize()
    return turns([lambda y, fn=fn: call(fn, y) for fn in fns], x, steps, chain=kind == "step")
