"""The reference tier of the whole step (B1), its scaled form (B1s) and the
fused per-level RHS (B4), generated per configuration (`ops.codegen`),
against the table-driven instances they replace (the wrappers' private
`_table`) on the card, and the choices of the generated design:

- `readings`: each reading's generated and table-driven wrappers from one
  plan at the shape of the path that runs it: B1 at `rainshaft_small`'s
  configuration ([6, 131072], f32 and f64) on that run's own states
  (`small_trajectory`), at the long horizon's ([6, 4096] f64, nz 32 and
  128) on its start, B4 ([6, 131072], f32 and f64) on `rainshaft_small`'s
  states, B1s ([6, 4096] f64), the four-gamma-mode B1 and B4 ([12, 131072]
  f32) and the family matrix's Φ-grid and `mono-gamma-closed` cases (2^20
  × 32 f32) on seeded states. For each: `ptxas` (registers, stack, spills)
  and SASS counts (LDL, STL, CALL) of both instances, both against the twin
  (row-scaled, normalized units; f32 < 1e-4, f64 < 1e-9), and ms per step
  or launch in turns (table, generated, generated, table; the median of
  each);
- `block_units` / `time_blocks`: the generated reference step at 64, 128
  and 256 threads per block, at [6, 4096] and [6, 131072];
- `exit_units` / `time_exit`: the generated reference step with and
  without the series incomplete gamma's early exit (`kSeriesExit`), f32
  and f64, at [6, 131072], with each unit's SASS CALLs (the IEEE divide's
  slow path). These variants are the tool's own (`variant`: the emitted
  configuration with another block size or the fixed loop); the wrappers
  launch `codegen.REF_THREADS` and the exit;
- `series_check`: the early exit against the fixed loop lane by lane
  (csrc/series_check.cuh, a unit of its own: `series_unit`) on seeded lanes
  of both branches, bit for bit, and both loops' times.

chip_smoke.py's phase 31 runs the readings and the series check; alone:

    python -m cloudy_tpu_torch.tools.reference_tune
    python -m cloudy_tpu_torch.tools.reference_tune --readings "B1 ref f32 [6, 131072]" --no-ablations

One JSON record per reading, block size, exit variant and series check on
stdout, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import _build, codegen
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch.tools import longhorizon
from cloudy_tpu_torch.tools import whole_step_ablation as wsa
from cloudy_tpu_torch.tools import yardstick as ys
from cloudy_tpu_torch.tools.yardstick import NORMS, NZ, TOL
from cloudy_tpu_torch.utils.metrics import card_name

#: the four-gamma-mode configuration (examples/box_gamma_mixture_4modes.py):
#: thresholds, and per mode the column's number and mean mass
FOUR_THR = (5e-10, 5e-9, 5e-8, np.inf)
FOUR_AMPS = tuple((1e8 * 10.0 ** -j, 1e-10 * 10.0 ** j) for j in range(4))
#: block sizes of the generated reference step, and the lanes they are timed at
BLOCKS = (64, 128, 256)
BLOCK_LANES = (4096, 131072)
#: lanes of the series check: at least 10^6, both branches
SERIES_LANES = 1 << 20
#: `rainshaft_small` (tests/_golden_cases.py): its steps and the interval
#: at which it saves its state
SMALL_STEPS, SMALL_EVERY = 120, 20


def _golovin():
    return K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)


def ref_data(families=("GAMMA", "GAMMA"), thresholds=None, moving=False, **kw):
    """The default (reference) tier: the masked Simpson F2 grid with the
    series/CF incomplete gamma at 128 iterations, Golovin 5.0 at order 1.
    `families` by name or `Family`; `thresholds` default (5e-10, ∞), or
    the percentiles (0.9, 1.0) under MovingThreshold (`moving`); `kw` to
    `build_coalescence_data` (chip_smoke.py's reference-tier arms)."""
    fams = tuple(f if isinstance(f, Family) else Family[f] for f in families)
    if thresholds is None:
        thresholds = (0.9, 1.0) if moving else (5e-10, np.inf)
    return build_coalescence_data(SpectrumSpec(fams), _golovin(), thresholds, norms=NORMS,
                                  moving=moving, **kw)


def rs_config(spec, nz: int = NZ) -> rs.RainshaftConfig:
    return rs.RainshaftConfig(spec=spec, nz=nz, zmax=3000.0, norms=NORMS, dt=1.0)


def seeded_state(spec, n_cols: int, nz: int = NZ, seed: int = 2) -> torch.Tensor:
    """[n_tot, n_cols · nz] f64: every mode of the column seeded (mode j
    from number 1e8 / 10^j and mean mass 1e-10 · 10^j, k = 1), a per-column
    amplitude in [0.5, 1.5]."""
    cfg = rs_config(spec, nz)
    ic = np.concatenate([rs.initial_condition(cfg.z, [n, n * m, 2.0 * n * m * m])[:, :k]
                         for (n, m), k in zip(FOUR_AMPS, spec.nprogmoms)], axis=-1)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 1))
    return rs.to_soa(torch.as_tensor(np.tile(ic[None], (n_cols, 1, 1)) * amp)).contiguous()


def small_trajectory(step, n_cols: int) -> torch.Tensor:
    """[6, n_cols · nz] in `step`'s type on its device: `rainshaft_small`'s
    run (mode 1 seeded, mode 2 empty; tests/_golden_cases.py) through the
    whole step `step` of its configuration on one column, column c holding
    the state after 20 · (c mod 7) steps: the states its 120 steps pass
    through, side by side, so that one launch does the run's mix of work."""
    cfg = rs_config(ref_data().spec, step.plan.nz)
    ic1 = rs.initial_condition(cfg.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    y = rs.to_soa(torch.as_tensor(ic[None])).to(step.device, step.dtype).contiguous()
    states = [y]
    for s in range(1, SMALL_STEPS + 1):
        y = step(y)
        if s % SMALL_EVERY == 0:
            states.append(y)
    cols = torch.stack(states)[torch.arange(n_cols) % len(states)]  # [n_cols, 6, nz]
    return cols.permute(1, 0, 2).reshape(y.shape[0], -1).contiguous()


@dataclasses.dataclass
class Reading:
    """One reading: generated and table-driven wrappers of one plan, the
    state they run on (`state_of` says which) and how they are timed
    (`steps` per turn)."""

    label: str
    kind: str  # "step" or "rhs"
    gen: object
    table: object
    state: Callable[[], torch.Tensor]
    state_of: str
    steps: int
    scale: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _step_pair(data, nz, dev, dtype, scaled=False, **kw):
    cfg = rs_config(data.spec, nz)
    gen = fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=nz, dz=cfg.dz, dt=1.0,
                                    device=dev, dtype=dtype, kernel_scale=scaled, **kw)
    return gen, type(gen)(gen.plan, dev, dtype, _table=True)


def _rhs_pair(data, dev, dtype):
    cfg = rs_config(data.spec)
    gen = fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, device=dev, dtype=dtype)
    return gen, fc.RainshaftRhsFn(gen.plan, dev, dtype, _table=True)


def readings(dev, names=None) -> List[Reading]:
    """The readings (all, or those labelled in `names`)."""
    f32, f64 = torch.float32, torch.float64
    small = ref_data()
    four = ref_data((Family.GAMMA,) * 4, FOUR_THR)
    out = []

    def add(label, kind, pair, state, state_of, steps, scale=None):
        if names is None or label in names:
            gen, table = pair()
            out.append(Reading(label, kind, gen, table, state, state_of, steps, scale))

    def trajectory(dt):
        return small_trajectory(_step_pair(small, NZ, dev, dt)[0], 4096)

    traj = "rainshaft_small's states (`small_trajectory`)"
    seeded = "seeded_state, every mode seeded"
    for tag, dt in (("f32", f32), ("f64", f64)):
        add(f"B1 ref {tag} [6, 131072]", "step", lambda dt=dt: _step_pair(small, NZ, dev, dt),
            lambda dt=dt: trajectory(dt), traj, 10)
    for nz in longhorizon.DEPTHS.values():
        add(f"B1 ref long f64 [6, 4096] nz {nz}", "step",
            lambda nz=nz: _step_pair(small, nz, dev, f64),
            lambda nz=nz: rs.to_soa(torch.as_tensor(longhorizon.start_state(nz))).to(dev, f64),
            "the long horizon's start (longhorizon.start_state)", 20)
    for tag, dt in (("f32", f32), ("f64", f64)):
        add(f"B4 ref {tag} [6, 131072]", "rhs", lambda dt=dt: _rhs_pair(small, dev, dt),
            lambda dt=dt: trajectory(dt), traj, 20)
    add("B1s ref f64 [6, 4096]", "step", lambda: _step_pair(small, NZ, dev, f64, scaled=True),
        lambda: seeded_state(small.spec, 128).to(dev, f64), seeded, 20,
        scale=lambda x: torch.linspace(0.4, 2.5, x.shape[1], dtype=x.dtype, device=x.device))
    add("four gamma B1 ref f32 [12, 131072]", "step",
        lambda: _step_pair(four, NZ, dev, f32),
        lambda: seeded_state(four.spec, 4096).to(dev, f32), seeded, 4)
    add("four gamma B4 ref f32 [12, 131072]", "rhs", lambda: _rhs_pair(four, dev, f32),
        lambda: seeded_state(four.spec, 4096).to(dev, f32), seeded, 6)
    for case in ("lognorm-gamma-grid", "mono-gamma-closed"):
        def pair(case=case):
            data, kw = wsa.case_data(case)
            return _step_pair(data, NZ, dev, f32, **kw)

        def state(case=case):
            return wsa.initial_state(rs_config(wsa.case_data(case)[0].spec), 1 << 20, dev, f32)

        add(f"matrix {case} f32 2^20 x 32", "step", pair, state,
            "the matrix's mode-1 pulse (whole_step_ablation.initial_state)", 3)
    return out


def variant(u: codegen.Unit, threads: int = None, series_exit: bool = True) -> codegen.Unit:
    """A one-off variant of the generated reference whole step `u` (a warp
    shuffle stencil) for the measurements: its emitted configuration and
    launch bounds at blocks of `threads`, or (`series_exit` False) the
    series incomplete gamma's fixed loop."""
    cfg, source = u.cfg, u.source
    if threads is not None:
        if threads % 32 or not u.shfl:
            raise ValueError(f"threads per block {threads} is not a multiple of a warp, or "
                             f"{u.label} takes whole columns")
        cfg = cfg.replace(f"kThreads = {u.threads};", f"kThreads = {threads};")
        source = source.replace(f"CLOUDY_GEN_BOUNDS({u.threads})", f"CLOUDY_GEN_BOUNDS({threads})")
    if not series_exit:
        cfg = cfg.replace("kSeriesExit = true;", "kSeriesExit = false;")
    return dataclasses.replace(u, cfg=cfg, source=source, threads=threads or u.threads,
                               digest=codegen._digest(cfg, source, " ".join(u.flags)))


def block_units(dev) -> Dict[tuple, codegen.Unit]:
    """{(type, threads): unit} of the generated reference step of
    `rainshaft_small`'s configuration at each of `BLOCKS`."""
    small = ref_data()
    out = {}
    for dt in (torch.float32, torch.float64):
        gen, _ = _step_pair(small, NZ, dev, dt)
        for t in BLOCKS:
            out[(dt, t)] = variant(gen.unit, threads=t)
    return out


def exit_units(dev) -> Dict[tuple, codegen.Unit]:
    """{(type, exit): unit} of the same step with and without the series
    early exit."""
    small = ref_data()
    out = {}
    for dt in (torch.float32, torch.float64):
        gen, _ = _step_pair(small, NZ, dev, dt)
        for ex in (True, False):
            out[(dt, ex)] = variant(gen.unit, series_exit=ex)
    return out


def series_unit() -> codegen.Unit:
    """csrc/series_check.cuh as a unit of its own, built at first use (both
    types in one unit; the label's type is nominal)."""
    source = "\n".join(["// Generated by cloudy_tpu_torch/tools/reference_tune.py; do not edit.",
                        '#include "series_check.cuh"', ""])
    return codegen.Unit(kind="series_check", dtype=torch.float64, cfg="", source=source,
                        digest=codegen._digest(source), threads=0, shfl=False, n_tot=0, nz=0)


def build_units(dev, names=None, ablations=True) -> list:
    """Every unit the readings, the series check and the ablations launch
    (for one parallel build: `_build.build_generated`)."""
    units = [series_unit()]
    for r in readings(dev, names):
        units += r.gen.build_units() + r.table.build_units()
    if ablations:
        units += list(block_units(dev).values()) + list(exit_units(dev).values())
    return units


def table_report(fn) -> dict:
    """ptxas and SASS counts of a wrapper's table-driven reference
    instance (`yardstick.table_report`)."""
    return ys.table_report(fn._kind, fn.dtype, 1, fn.plan, fn._scaled, ref=True,
                           units=fn.build_units())


def gen_report(u) -> dict:
    rec, = _build.build_generated([u])
    return ys.gen_report(u, rec)


def run_reading(r: Reading, card: str) -> dict:
    """One reading's record: both instances' reports, their errors against
    the twin and their ms in turns."""
    x = r.state()
    scale = None if r.scale is None else r.scale(x)
    rec = {"reading": r.label, "kind": r.kind, "dtype": str(r.gen.dtype).split(".")[-1],
           "shape": list(x.shape), "state": r.state_of, "route": r.gen.route, "unit": r.gen.unit.label,
           "flags": list(r.gen.unit.flags), "threads": r.gen.unit.threads,
           "generated": gen_report(r.gen.unit), "table": table_report(r.table), "card": card}
    # against the twin on the first 4,096 lanes' worth of columns (2,048 past six moments)
    lanes = min(x.shape[1], 4096 if r.gen.plan.n_tot <= 6 else 2048)
    xc = x[:, :lanes - lanes % r.gen.plan.nz].contiguous()
    errs = ys.twin_errors([r.gen, r.table], r.kind, xc, None if r.scale is None else r.scale(xc))
    for name, (err, finite) in zip(("generated", "table"), errs):
        rec[f"{name}_vs_twin"], rec[f"{name}_finite"] = err, finite
    (t_table, t_gen), turns = ys.time_turns([r.table, r.gen], r.kind, x, r.steps, scale)
    rec.update(table_ms=t_table, generated_ms=t_gen, speedup=t_table / t_gen,
               turns_ms={"table": turns[0], "generated": turns[1]})
    return rec


def _time_units(units, x, steps):
    """ms per step of each generated unit of one plan in turns (u0, u1, …,
    u1, u0; `yardstick.turns`), the median of each."""
    libs = [_build.load_generated(u) for u in units]

    def run(lib, y):
        out = torch.empty_like(y)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.cloudy_gen_launch(y.data_ptr(), out.data_ptr(), y.shape[1], None, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    for lib in libs:
        run(lib, x)
    torch.cuda.synchronize()
    return ys.turns([lambda y, lib=lib: run(lib, y) for lib in libs], x, steps)


def time_blocks(dev, card: str) -> List[dict]:
    """The generated reference step at each block size and lane count, in
    turns (f32 and f64), with each unit's blocks per SM."""
    units = block_units(dev)
    small = ref_data()
    out = []
    for dt in (torch.float32, torch.float64):
        us = [units[(dt, t)] for t in BLOCKS]
        for lanes in BLOCK_LANES:
            x = seeded_state(small.spec, lanes // NZ).to(dev, dt)
            steps = 20 if lanes <= 4096 else 10
            ms, turns = _time_units(us, x, steps)
            reps = [gen_report(u) for u in us]
            out.append({"check": "block size", "dtype": str(dt).split(".")[-1],
                        "lanes": lanes, "threads": list(BLOCKS), "ms": ms,
                        "blocks_per_sm": [r["blocks_per_sm"] for r in reps],
                        "registers": [r["ptxas"].get("registers") for r in reps],
                        "turns_ms": [turns[i] for i in range(len(us))], "card": card})
    return out


def time_exit(dev, card: str) -> List[dict]:
    """The generated reference step with and without the series early exit
    at [6, 131072], in turns, its result bit for bit the same, and each
    unit's SASS CALLs."""
    units = exit_units(dev)
    small = ref_data()
    out = []
    for dt in (torch.float32, torch.float64):
        us = [units[(dt, True)], units[(dt, False)]]
        x = seeded_state(small.spec, 4096).to(dev, dt)
        ms, turns = _time_units(us, x, 10)
        outs = []
        for u in us:
            lib = _build.load_generated(u)
            y = torch.empty_like(x)
            lib.cloudy_gen_launch(x.data_ptr(), y.data_ptr(), x.shape[1], None,
                                  torch.cuda.current_stream(dev).cuda_stream)
            outs.append(y)
        torch.cuda.synchronize()
        reps = [gen_report(u) for u in us]
        out.append({"check": "series exit", "dtype": str(dt).split(".")[-1],
                    "lanes": x.shape[1], "ms_exit": ms[0], "ms_fixed": ms[1],
                    "same_bits": bool(torch.equal(outs[0], outs[1])),
                    "sass_exit": reps[0]["sass"], "sass_fixed": reps[1]["sass"],
                    "registers": [r["ptxas"].get("registers") for r in reps],
                    "turns_ms": [turns[0], turns[1]], "card": card})
    return out


def series_lanes(n: int, seed: int = 5):
    """(a, x) f64 of `n` seeded lanes: a ∈ [0.5, 16] (the orders the F2
    grid, the erf and the Newton inverse take), x log-uniform in [1e-4, 64]
    (both sides of a + 1), and a few at the clamp (x > 1e6) and at x = 0."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 16.0, n)
    x = np.exp(rng.uniform(np.log(1e-4), np.log(64.0), n))
    x[:16] = [0.0, 2e6, 1e7, 1e-30, 1e-300, 3.0, 5.0, 1.5, 0.5, 1e-8, 40.0, 80.0, 200.0,
              1e3, 1e5, 1e6]
    return a, x


def series_check(dev, card: str, n: int = SERIES_LANES, n_iters: int = 128) -> List[dict]:
    """The early exit against the fixed loop on `n` lanes in f32 and f64:
    bit for bit (compared as integers), the lanes of each branch, and each
    loop's ms in turns (fixed, exit, exit, fixed)."""
    rec, = _build.build_generated([series_unit()])
    lib = ctypes.CDLL(str(rec["path"]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    a_np, x_np = series_lanes(n)
    out = []
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        a = torch.as_tensor(a_np, dtype=dt, device=dev)
        x = torch.as_tensor(x_np, dtype=dt, device=dev)
        fixed, ex = torch.empty_like(a), torch.empty_like(a)
        f = getattr(lib, f"cloudy_series_check_{tag}")
        f.argtypes = [p, p, p, p, ll, i, i, p]  # a, x, fixed, exit, n, n_iters, which, stream
        f.restype = i
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(which):
            err = f(a.data_ptr(), x.data_ptr(), fixed.data_ptr(), ex.data_ptr(), n, n_iters,
                    which, stream)
            if err != 0:
                raise RuntimeError(f"series check launch failed: cudaError {err}")

        call(2)
        torch.cuda.synchronize()
        itype = torch.int32 if dt == torch.float32 else torch.int64
        same = bool(torch.equal(fixed.view(itype), ex.view(itype)))
        n_diff = int((fixed.view(itype) != ex.view(itype)).sum())
        series = (torch.clamp(x, max=1e6) < a + 1.0) & (x > 0)
        times = {0: [], 1: []}
        for which in (0, 1, 1, 0):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                call(which)
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end) / 5)
        out.append({"check": "series exit lanes", "dtype": tag, "lanes": n,
                    "series_lanes": int(series.sum()), "cf_lanes": int((~series).sum()),
                    "bit_for_bit": same, "lanes_differing": n_diff, "n_iters": n_iters,
                    "fixed_ms": float(np.median(times[0])),
                    "exit_ms": float(np.median(times[1])), "card": card})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readings", default=None,
                    help="comma-separated labels of `READINGS` (default all)")
    ap.add_argument("--no-ablations", action="store_true",
                    help="skip the block sizes, the exit ablation and the series check")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("reference_tune: no CUDA device; the kernels run on the card only")
    dev = torch.device("cuda", 0)
    card = card_name(dev)
    names = None if args.readings is None else set(args.readings.split(","))
    t0 = time.perf_counter()
    lib = threading.Thread(target=_build.build)  # the library beside the generated units
    lib.start()
    recs = _build.build_generated(build_units(dev, names, not args.no_ablations))
    lib.join()
    _build.load_library()
    t_lib = time.perf_counter() - t0
    for rec in recs:
        print(json.dumps({"unit": rec["label"], "nvcc_s": rec["seconds"],
                          "retried": rec["retried"], **_build.ptxas_report(rec.get("log", ""))}))
    print(json.dumps({"build_s": t_lib}))
    failed = False
    for r in readings(dev, names):
        rec = run_reading(r, card)
        tol = TOL[r.gen.dtype]
        failed |= not (rec["generated_vs_twin"] < tol and rec["generated_finite"])
        print(json.dumps(rec))
    if not args.no_ablations:
        for rec in time_blocks(dev, card) + time_exit(dev, card) + series_check(dev, card):
            failed |= rec.get("same_bits", True) is False or rec.get("bit_for_bit") is False
            print(json.dumps(rec))
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
