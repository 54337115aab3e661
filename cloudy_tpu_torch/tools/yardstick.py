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
    (`tools.whole_step_ablation.CASE_NAMES`; its kernel keywords are for the
    reference tier and a generated kernel reads none)."""
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


def table_report(kind: str, dtype, arms: int, plan) -> dict:
    """ptxas, SASS counts and blocks per SM of a table-driven fast
    instance."""
    lib = _build.load_library()
    so = _build.library_path()
    tag = "f" if dtype == torch.float32 else "d"
    if kind == "step":
        pat = rf"step_kernelI{tag}Lb{arms}ELb0ELb0E"
    else:
        pat = rf"{kind}_kernelI{tag}Lb{arms}ELb0E"
    sass = {k: v for k, v in _build.sass_counts(so).items() if re.search(pat, k)}
    log = so.with_suffix(".log").read_text()
    lines, keep, pt = log.splitlines(), False, ""
    for ln in lines:
        if "Compiling entry function" in ln:
            keep = bool(re.search(pat, ln))
        if keep:
            pt += ln + "\n"
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
    return {"ptxas": _build.ptxas_report(pt), "sass": next(iter(sass.values()), {}),
            "blocks_per_sm": got.value}


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


def check_vs_twin(fn, kind, variant, device, dtype, n_cols: int = 4096, nz: int = NZ):
    """Row-scaled error (normalized units) of one launch against the twin on
    a seeded two-mode state with a negative moment and an empty level (the
    coalescence RHS: on `coal_moments` of n_cols · nz boxes)."""
    if kind == "coal":
        x = coal_moments(variant, n_cols * nz, device, dtype, seed=2)
        got, want = fn.soa(x), fn.plain(x)
        torch.cuda.synchronize()
        return _row_scaled(got, want), bool(torch.isfinite(got).all())
    spec, _, cfg = pod_config(variant, nz)
    amps = ([1e8, 1e-2, 2e-12], [1e7, 1e-3, 2e-13], [1e6, 1e-4, 2e-14])
    ic = np.concatenate([rs.initial_condition(cfg.z, a)[:, :n]
                         for a, n in zip(amps, spec.nprogmoms)], axis=-1)
    amp = np.random.default_rng(2).uniform(0.5, 1.5, (n_cols, 1, 1))
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, nz // 2, 0] *= -1.0
    st[1, nz // 2 + 1, :] = -1e-3
    x = rs.to_soa(torch.as_tensor(st)).to(device, dtype).contiguous()
    norm = torch.tensor(fn.plan.mom_norms, dtype=dtype, device=device)[:, None]
    if kind == "step":
        got, want = fn(x), fn.plain(x)
    else:
        got, want, norm = fn.soa(x), fn.plain(x), torch.cat([norm, norm])
    torch.cuda.synchronize()
    return _row_scaled(got / norm, want / norm), bool(torch.isfinite(got).all())


def pod_state(variant: str, n_columns: int, device, dtype):
    """The pod's initial state [6, n_columns · 32] (mode 1 seeded, mode 2
    empty), as `harness._scenario_pod_ensemble`."""
    spec, _, cfg = pod_config(variant)
    ic1 = rs.initial_condition(cfg.z, [1e8, 1e-2, 2e-12])[:, :spec.nprogmoms[0]]
    ic = np.concatenate([ic1, np.zeros((ic1.shape[0], spec.n_tot - ic1.shape[1]))], axis=-1)
    return torch.as_tensor(ic.T.copy(), dtype=dtype, device=device).repeat(1, n_columns)


def time_turns(fns, kind, x, steps: int):
    """ms per step (chains of `steps` whole steps from x) or per launch, of
    each of two wrappers, in turns a, b, b, a; the median of each."""
    def one(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        y = x
        start.record()
        for _ in range(steps):
            y = fn(y) if kind == "step" else fn.soa(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps

    for fn in fns:  # warm-up: builds, loads
        fn(x[:, :NZ].contiguous()) if kind == "step" else fn.soa(x[:, :NZ].contiguous())
    torch.cuda.synchronize()
    times = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        times[i].append(one(fns[i]))
    return [float(np.median(times[i])) for i in (0, 1)], times
