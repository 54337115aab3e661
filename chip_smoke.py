#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`cloudy_tpu_torch`) on one GPU.

Drives the port's main path once on the card and fails loudly:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles the CUDA kernels from cloudy_tpu_torch/csrc;
3. coalescence-RHS kernel vs its plain twin (bench.py's inputs, 65,536
   boxes, f32 and f64);
4. whole-step kernel vs its plain twin (4,096 columns x 32 levels, one step,
   f32 and f64);
5. golden anchor: the f64 whole-step kernel over 120 steps against
   tests/golden/rainshaft_small.npz;
6. the main path: the pod ensemble (fixed2gamma) at 2^20 columns x 32 levels
   x 120 steps in f32 through the whole-step kernel, with its first 4,096
   columns held against the twin run on the card;
7. the RHS rate: bench.py's Euler chain at 2^20 boxes through the
   coalescence kernel; then both kernels against their twins once more at
   the main path's shapes (f32), and the twins' times there;
8. the coalescence kernel's MovingThreshold and lognormal arms against the
   twin (bench-style inputs, 65,536 boxes, f32 and f64), then each arm's
   Euler chain at 2^20 boxes and a comparison at that shape;
9. the whole-step kernel's arms against the twin (the `moving` and
   `lognorm` pod data, 4,096 columns x 32 levels, one step, f32 and f64);
10. the fused per-level RHS kernel against its twin (4,096 columns, f32 and
   f64, all three variants; then the pod state [6, 2^25], f32), and the
   fused-RHS route (that kernel + torch stencil + `stepper.ssprk33_step`)
   for 20 steps at 2^20 x 32 `fixed2gamma`, held against 20 whole steps;
11. the `moving` and `lognorm` pod scenarios at 2^20 columns x 32 levels x
   40 f32 steps through the whole-step kernel, the first 4,096 columns
   held against the twin run on the card;
12. the f64 anchor of each variant: the f64 whole-step kernel against the
   f64 twin on the card, 128 columns, 40 steps;
13. the direct-quadrature kernel against its twin: 128 boxes (one empty, one
   with an empty second mode), (64, 32) nodes, f32 and f64, two gamma modes
   with each of the four kernel functions and exponential + gamma +
   lognormal with the Long kernel; the f32 kernel against the f64 kernel;
14. the numerical bench: the Euler chain of 262,144 boxes, two gamma modes,
   the Long kernel, f32, default budgets (96, 48), through the quadrature
   kernel; the kernel against its twin (run in chunks of boxes) at the full
   [6, 262144], and both times there;
15. the three box scenarios through the harness on the card in f64 against
   tests/golden/box_*.npz, and one quadrature-kernel launch at the box
   model's (256, 96) budgets on the numerical box's initial state against
   the einsum path `get_coal_ints_numerical` on the card;
16. calibration: the whole-step kernel with its per-lane kernel scale (B1s)
   against its twin (4,096 columns x 32 levels, a different scale per
   column, f32 and f64, all three variants: both kernel instances), and at
   s = 1.7 against the unscaled kernel built from the 1.7-scaled kernel
   tensor (f64); then the main path, `tools.calibration_bench.pod_main`: EKI
   at 64 and 256 members x 32 columns x 32 levels x 60 f32 steps through
   B1s, its 8-iteration run at 256 members checked for 540 launches, finite
   observables and s within 2 % of 1.7; B1s against its twin at that run's
   shape [6, 262144], and the unscaled B1 time of phase 6 beside it.

Each main path's launch counts are zeroed just before it runs and read just
after: phases 6-7 (the fixed2gamma whole step and coalescence kernels), each
arm's chain in phase 8, the fused-RHS route in phase 10, each variant's run
in phase 11, the numerical chain in phase 14, and in phase 16 `pod_main`'s
8-iteration EKI run at 256 members (`pod_main` zeroes the scaled step's
count just before that run and reports it just after). The last two lines are a JSON
object of per-kernel numbers (errors from the main-path-shape comparison, the
steps' in normalized moment units; ``bound_ms`` the larger of the bytes moved
over 3.35 TB/s and the twin's operation count over the card's peak rate for
the type, `cloudy_tpu_torch.tools.opcount`; ``library_ms`` null: no single
PyTorch call computes any of these functions) and
``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, when no CUDA device is present or the port's package is missing.

    python3 chip_smoke.py
"""

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_POD_COLUMNS = 1 << 20
N_CMP_COLUMNS = 4096
NZ = 32
N_RHS_STEPS = 100
N_ARM_STEPS = 20  # Euler chain steps of each coalescence arm (phase 8)
N_FUSED_STEPS = 20  # fused-RHS route vs whole step (phase 10)
N_VARIANT_STEPS = 40  # pod steps of the moving and lognorm runs (phases 11-12)
N_ANCHOR_COLUMNS = 128
N_NUM_STEPS = 20  # Euler chain steps of the numerical bench (phase 14)
N_NUM_BOXES = 128  # quadrature kernel vs twin (phase 13)
NUM_NODES = (64, 32)
NUM_CHUNK = 32768  # boxes per twin call at the full bench width
BOX_SCENARIOS = ("box_single_gamma_golovin", "box_exp_gamma_mixture",
                 "box_long_numerical")
VARIANTS = {"moving": "pod_ensemble_moving", "lognorm": "pod_ensemble_lognorm"}
TOL = {"float32": 1e-4, "float64": 1e-9}  # kernel vs twin, row-scaled
# the quadrature kernel sums its nodes in another order than the twin and its
# assembly subtracts sums of like size
NUM_TOL = {"float32": 1e-3, "float64": 1e-9}
BOX_TOL = 1e-6  # box scenarios vs the stored f64 trajectories (rtol)
GOLDEN_TOL = 1e-3  # fast tier vs the stored f64 Simpson-tier trajectory
B1_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:876"
B3_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:662"
B4_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:771"
B5_REPLACES = "cloudy_tpu/ops/pallas_numerical.py:166"
B1S_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:1022"
CAL_MEMBERS = (64, 256)  # EKI ensemble sizes of phase 16
CAL_STEPS = 60  # forward steps per member (tools/calibration_bench.py:102)
SOURCE = "cloudy_tpu_torch/csrc/fused_coalescence.cu"
NUM_SOURCE = "cloudy_tpu_torch/csrc/numerical_coalescence.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def ptxas_summary(log):
    """One line per kernel instance from the build's ``-Xptxas -v`` report:
    registers, stack frame and spills."""
    out, entry, props, stack = [], None, None, ("?", "?", "?")
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\w+)", ln):
            props = m.group(1)
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads", ln)) and props == entry:
            stack = m.groups()
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            name = entry
            if k := re.search(r"cloudy\d+(\w+?)I([fd])Lb([01])ELb([01])E", entry):
                name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}, "
                        f"{'true' if k.group(3) == '1' else 'false'}, "
                        f"{'scaled' if k.group(4) == '1' else 'unscaled'}>")
            elif k := re.search(r"cloudy\d+(\w+?)I([fd])Lb([01])E", entry):
                name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}, "
                        f"{'true' if k.group(3) == '1' else 'false'}>")
            elif k := re.search(r"cloudy\d+(\w+?)I([fd])Li(\d)ELi(\d)E", entry):
                name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}, "
                        f"{k.group(3)} modes, kernel function {k.group(4)}>")
            out.append(f"{name}: {m.group(1)} registers, {stack[0]} B stack, "
                       f"{stack[1]} B spill stores, {stack[2]} B spill loads")
            entry = None
    return out


def row_scaled(got, want, cancelling=()):
    """max over rows of |got - want| / max|want| of the row, and max abs. A
    row in `cancelling` is zero in exact arithmetic (a lone mode's mass
    tendency: what is left of two sums of like size), so its own values are
    no scale: it takes the geometric mean of its neighbours', the size of
    those sums."""
    d = (got.double() - want.double()).abs()
    scale = want.double().abs().amax(dim=1).clamp_min(1e-300)
    for r in cancelling:
        scale[r] = (scale[r - 1] * scale[r + 1]).sqrt()
    return float((d.amax(dim=1) / scale).max()), float(d.max())


def main():
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
            "the port's smoke test runs on a GPU only"
        )
    if not (ROOT / "cloudy_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: the cloudy_tpu_torch package is not beside {ROOT}")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from cloudy_tpu_torch import bench, harness, stepper
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch import coalescence_numerical as cn
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec, get_moments_normalizing_factors
    from cloudy_tpu_torch.tools import opcount
    from cloudy_tpu_torch.utils import metrics

    dev = torch.device("cuda", 0)
    dtypes = {"float32": torch.float32, "float64": torch.float64}

    # ---- 1. environment ---------------------------------------------------
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = f"[card: {smi.splitlines()[0]}]"
    print(f"phase 1 environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi)
    print(f"phase 1 seconds {time.perf_counter() - t:.3f}")

    # ---- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t
    log = _build.library_path().with_suffix(".log").read_text()
    print(f"phase 2 build: {_build.library_path().name} in {build_s:.3f} s {card}")
    for ln in ptxas_summary(log):
        print(f"  ptxas: {ln}")
    print(f"phase 2 seconds {time.perf_counter() - t:.3f}")

    spec, bdata = bench.bench_data()
    results = {}

    def bound(label, twin, x_small, lanes, rows_in, rows_out):
        """The least time the card could take for one f32 launch on `lanes`
        lanes: bytes (each input and output row once) over the memory rate
        against the twin's operations, counted on `x_small` and scaled to
        `lanes`, over the peak f32 rate."""
        ops_per_lane = opcount.count_ops(twin, x_small) / x_small.shape[1]
        n_bytes = (rows_in + rows_out) * lanes * 4
        ms, by = opcount.bound_ms(n_bytes, ops_per_lane * lanes)
        print(f"bound {label}: {ops_per_lane:.2f} twin operations per lane x {lanes} "
              f"lanes at {opcount.H100_F32_OPS_PER_S:.3g} op/s, {n_bytes} bytes "
              f"at {opcount.H100_BYTES_PER_S:.3g} B/s: {ms:.4f} ms, bound by {by}")
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    # ---- 3. coalescence-RHS kernel vs twin --------------------------------
    t = time.perf_counter()
    mom_np = bench.bench_moments(65536, seed=1).T.copy()
    for name, dt in dtypes.items():
        fn = fc.make_coal_fn(bdata, device=dev, dtype=dt)
        x = torch.as_tensor(mom_np, dtype=dt, device=dev)
        got = fn.soa(x)
        want = fn.plain(x)
        torch.cuda.synchronize()
        err, abs_err = row_scaled(got, want)
        print(f"phase 3 coal kernel vs twin {name}: row-scaled {err:.3e} "
              f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e}, finite "
              f"{bool(torch.isfinite(got).all())} {card}")
        check(bool(torch.isfinite(got).all()), f"coal kernel {name} not finite")
        check(err < TOL[name], f"coal kernel {name} vs twin {err:.3e}")
        results[("coal", name)] = (err, abs_err)
    print(f"phase 3 seconds {time.perf_counter() - t:.3f}")

    # ---- 4. whole-step kernel vs twin -------------------------------------
    t = time.perf_counter()
    sc_cfg = rs.RainshaftConfig(spec=spec, nz=NZ, zmax=3000.0, norms=(1e6, 1e-9))
    rng = np.random.default_rng(2)
    ic = np.concatenate(
        [rs.initial_condition(sc_cfg.z, [1e8, 1e-2, 2e-12]),
         rs.initial_condition(sc_cfg.z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = rng.uniform(0.5, 1.5, (N_CMP_COLUMNS, 1, 2)).repeat(3, axis=2)
    st = np.tile(ic[None], (N_CMP_COLUMNS, 1, 1)) * amp
    st[0, NZ // 2, 0] *= -1.0  # a negative moment: clipped in-kernel
    st[1, NZ // 2 + 1, :] = -1e-3  # a whole negative level: empty cell
    state_np = rs.to_soa(torch.as_tensor(st)).numpy()
    fdata = build_coalescence_data(
        spec, K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6),
        (5e-10, np.inf), norms=(1e6, 1e-9), fast_tier=True)
    for name, dt in dtypes.items():
        step = fc.make_rainshaft_step_fn(
            fdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz, dt=1.0,
            device=dev, dtype=dt)
        x = torch.as_tensor(state_np, dtype=dt, device=dev)
        before = step.launches
        got = step(x)
        check(step.launches == before + 1, "step wrapper did not count one launch")
        want = step.plain(x)
        torch.cuda.synchronize()
        # abs error in normalized moment units (physical moments span ~1e20)
        norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
        err, abs_err = row_scaled(got / norm, want / norm)
        print(f"phase 4 step kernel vs twin {name}: row-scaled {err:.3e} "
              f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e} (normalized), launches "
              f"{before}->{step.launches} {card}")
        check(bool(torch.isfinite(got).all()), f"step kernel {name} not finite")
        check(err < TOL[name], f"step kernel {name} vs twin {err:.3e}")
        results[("step", name)] = (err, abs_err)
    print(f"phase 4 seconds {time.perf_counter() - t:.3f}")

    # ---- 5. golden anchor -------------------------------------------------
    t = time.perf_counter()
    with np.load(ROOT / "tests" / "golden" / "rainshaft_small.npz") as z:
        ys_g = z["ys"]  # [7, 32, 6]: every 20th of 120 f64 Simpson-tier steps
    step64 = fc.make_rainshaft_step_fn(
        fdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz, dt=1.0,
        device=dev, dtype=torch.float64)
    y = rs.to_soa(torch.as_tensor(np.tile(ys_g[0][None], (128, 1, 1)))).to(dev)
    scale = np.abs(ys_g).max(axis=(0, 1))  # per-moment scale
    gerr = 0.0
    for s in range(1, 121):
        y = step64(y)
        if s % 20 == 0:
            got = rs.from_soa(y, NZ).cpu().numpy()
            gerr = max(gerr, float((np.abs(got - ys_g[s // 20][None]) / scale).max()))
    print(f"phase 5 golden anchor (f64 kernel, 128 columns, 120 steps): "
          f"per-moment-scaled {gerr:.3e} (tol {GOLDEN_TOL:.0e}) {card}")
    check(gerr < GOLDEN_TOL, f"golden anchor {gerr:.3e}")
    print(f"phase 5 seconds {time.perf_counter() - t:.3f}")

    # ---- 6. the main path: pod ensemble through the whole-step kernel ------
    t = time.perf_counter()
    sc = harness.SCENARIOS["pod_ensemble"](
        n_columns=N_POD_COLUMNS, device=dev, dtype=torch.float32)
    coal32 = fc.make_coal_fn(bdata, device=dev, dtype=torch.float32)
    rhs_mom = torch.as_tensor(bench.bench_moments(bench.BENCH_COLUMNS).T.copy(),
                              dtype=torch.float32, device=dev)
    sc["step"].launches = 0  # counts from here to the end of phase 7
    coal32.launches = 0
    y, pod_s, clock = sc["run"]()
    rep = metrics.conservation_report(sc["spec"], rs.from_soa(y, NZ))
    finite = bool(torch.isfinite(y).all())
    cu_rate = N_POD_COLUMNS * sc["n_steps"] / pod_s
    print(f"phase 6 pod_ensemble fixed2gamma {N_POD_COLUMNS} x {NZ} x "
          f"{sc['n_steps']} f32: {pod_s:.4f} s ({clock}), {cu_rate:.4e} "
          f"column-updates/s, finite {finite}, negative_fraction "
          f"{rep['negative_fraction']}, nonfinite_fraction "
          f"{rep['nonfinite_fraction']}, total_mass {rep['total_mass']:.6e} {card}")
    check(finite and rep["nonfinite_fraction"] == 0.0, "pod state not finite")
    check(rep["negative_fraction"] == 0.0, "pod state has negative moments")
    b1_ms = pod_s / sc["n_steps"] * 1e3  # unscaled B1 fixed2gamma, phase 16 prints it again
    n_cmp = N_CMP_COLUMNS * NZ
    yt = sc["state0"][:, :n_cmp].contiguous()
    twin_start = torch.cuda.Event(enable_timing=True)
    twin_end = torch.cuda.Event(enable_timing=True)
    twin_start.record()
    for _ in range(sc["n_steps"]):
        yt = sc["step"].plain(yt)
    twin_end.record()
    twin_end.synchronize()
    twin_s = twin_start.elapsed_time(twin_end) / 1e3
    perr, _ = row_scaled(y[:, :n_cmp], yt)
    print(f"phase 6 first {N_CMP_COLUMNS} columns vs twin on the card: "
          f"row-scaled {perr:.3e} (tol {TOL['float32']:.0e}); twin "
          f"{N_CMP_COLUMNS * sc['n_steps'] / twin_s:.4e} column-updates/s at "
          f"{N_CMP_COLUMNS} columns ({twin_s:.4f} s) {card}")
    check(perr < TOL["float32"], f"pod kernel vs twin {perr:.3e}")
    print(f"phase 6 seconds {time.perf_counter() - t:.3f}")

    # ---- 7. RHS rate: bench.py's Euler chain through the coal kernel ------
    t = time.perf_counter()
    s_chain = bench.time_chain(coal32.soa, rhs_mom, N_RHS_STEPS)
    mu_rate = bench.BENCH_COLUMNS * spec.n_tot / s_chain
    launches = {"step": sc["step"].launches, "coal": coal32.launches}
    print(f"phase 7 coal RHS chain {bench.BENCH_COLUMNS} boxes f32: "
          f"{s_chain * 1e3:.4f} ms/step, {mu_rate:.4e} moment-updates/s {card}")
    print(f"launch counts of the main path: {launches}")
    check(launches["step"] == sc["n_steps"],
          f"whole-step kernel launched {launches['step']} times, not {sc['n_steps']}")
    check(launches["coal"] == N_RHS_STEPS + 3,
          f"coal kernel launched {launches['coal']} times, not {N_RHS_STEPS + 3}")

    # kernel vs twin at the main-path shapes, and the twins' times there
    # (after the counts were read: these launches are comparisons)
    s_twin_chain = bench.time_chain(coal32.plain, rhs_mom, 3, warmup=1)
    print(f"phase 7 twin RHS chain: {s_twin_chain * 1e3:.4f} ms/step, "
          f"{bench.BENCH_COLUMNS * spec.n_tot / s_twin_chain:.4e} moment-updates/s {card}")
    results[("coal", "main")] = row_scaled(coal32.soa(rhs_mom), coal32.plain(rhs_mom))
    norm = torch.tensor(sc["step"].plan.mom_norms, dtype=torch.float32, device=dev)[:, None]
    results[("step", "main")] = row_scaled(sc["step"](sc["state0"]) / norm,
                                           sc["step"].plain(sc["state0"]) / norm)
    for kind, shape in (("coal", f"[6, {bench.BENCH_COLUMNS}]"),
                        ("step", f"[6, {N_POD_COLUMNS * NZ}]")):
        err, abs_err = results[(kind, "main")]
        print(f"phase 7 {kind} kernel vs twin at the main-path shape {shape} f32: "
              f"row-scaled {err:.3e} (tol {TOL['float32']:.0e}), max abs {abs_err:.3e}"
              f"{' (normalized)' if kind == 'step' else ''} {card}")
        check(err < TOL["float32"], f"{kind} kernel vs twin at the main-path shape {err:.3e}")
    coal_ms = _time_ms(lambda: coal32.soa(rhs_mom), 50)
    coal_plain_ms = _time_ms(lambda: coal32.plain(rhs_mom), 3)
    step_plain_ms = _time_ms(lambda: sc["step"].plain(sc["state0"]), 2)
    step_bound = bound("rainshaft_step", sc["step"].plain,
                       sc["state0"][:, :8 * NZ].contiguous(), N_POD_COLUMNS * NZ, 6, 6)
    coal_bound = bound("coal_rhs", coal32.plain, rhs_mom[:, :256].contiguous(),
                       bench.BENCH_COLUMNS, 6, 6)
    del sc, y, yt
    print(f"phase 7 per call at main-path shapes: coal kernel {coal_ms:.4f} ms, "
          f"coal twin {coal_plain_ms:.4f} ms; step kernel "
          f"{pod_s / 120 * 1e3:.4f} ms, step twin {step_plain_ms:.4f} ms {card}")
    print(f"phase 7 seconds {time.perf_counter() - t:.3f}")

    kernels = [
        {"name": "rainshaft_step", "route": "cuda", "source": SOURCE,
         "replaces": B1_REPLACES, "launches": launches["step"],
         "max_abs_err": results[("step", "main")][1],
         "max_row_scaled_err": results[("step", "main")][0],
         "ms": pod_s / 120 * 1e3, "plain_ms": step_plain_ms, **step_bound},
        {"name": "coal_rhs", "route": "cuda", "source": SOURCE,
         "replaces": B3_REPLACES, "launches": launches["coal"],
         "max_abs_err": results[("coal", "main")][1],
         "max_row_scaled_err": results[("coal", "main")][0],
         "ms": coal_ms, "plain_ms": coal_plain_ms, **coal_bound},
    ]

    def variant_moments(variant, n, seed):
        """Normalized bench-style moments [n_tot, n]: bench.py's joint
        amplitude and mass scalings for two gamma modes; for lognormal +
        gamma, parameters drawn first (tests/test_pallas.py:311-319)."""
        if variant == "moving":
            return bench.bench_moments(n, seed=seed).T.copy()
        vspec, _ = harness.pod_data(variant)
        rng = np.random.default_rng(seed)
        par = np.stack([
            np.stack([rng.uniform(10, 200, n), rng.uniform(-2.0, 0.5, n),
                      rng.uniform(0.3, 1.2, n)], -1),
            np.stack([rng.uniform(10, 200, n), rng.uniform(0.05, 5.0, n),
                      rng.uniform(0.5, 5.0, n)], -1)], axis=1)
        return pd.get_moments(vspec, torch.as_tensor(par)).numpy().T.copy()

    # ---- 8. coalescence-kernel arms vs twin, and each arm's chain ----------
    t = time.perf_counter()
    for variant in VARIANTS:
        _, vdata = harness.pod_data(variant)
        mom_np = variant_moments(variant, 65536, seed=1)
        for name, dt in dtypes.items():
            fn = fc.make_coal_fn(vdata, device=dev, dtype=dt)
            x = torch.as_tensor(mom_np, dtype=dt, device=dev)
            got = fn.soa(x)
            want = fn.plain(x)
            torch.cuda.synchronize()
            err, abs_err = row_scaled(got, want)
            print(f"phase 8 coal kernel [{variant}] vs twin {name}: row-scaled {err:.3e} "
                  f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e}, finite "
                  f"{bool(torch.isfinite(got).all())} {card}")
            check(bool(torch.isfinite(got).all()), f"coal kernel [{variant}] {name} not finite")
            check(err < TOL[name], f"coal kernel [{variant}] {name} vs twin {err:.3e}")
        fn = fc.make_coal_fn(vdata, device=dev, dtype=torch.float32)
        x = torch.as_tensor(variant_moments(variant, bench.BENCH_COLUMNS, seed=0),
                            dtype=torch.float32, device=dev)
        fn.launches = 0
        s_chain = bench.time_chain(fn.soa, x, N_ARM_STEPS)
        n_launch = fn.launches
        check(n_launch == N_ARM_STEPS + 3,
              f"coal kernel [{variant}] launched {n_launch} times, not {N_ARM_STEPS + 3}")
        err, abs_err = row_scaled(fn.soa(x), fn.plain(x))
        check(err < TOL["float32"], f"coal kernel [{variant}] vs twin at [6, 2^20] {err:.3e}")
        ms, plain_ms = _time_ms(lambda: fn.soa(x), 20), _time_ms(lambda: fn.plain(x), 2)
        print(f"phase 8 coal RHS chain [{variant}] {bench.BENCH_COLUMNS} boxes f32: "
              f"{s_chain * 1e3:.4f} ms/step, {bench.BENCH_COLUMNS * 6 / s_chain:.4e} "
              f"moment-updates/s, launches {n_launch}; at [6, {bench.BENCH_COLUMNS}] "
              f"row-scaled {err:.3e}, max abs {abs_err:.3e}; kernel {ms:.4f} ms, "
              f"twin {plain_ms:.4f} ms {card}")
        kernels.append({"name": f"coal_rhs[{variant}]", "route": "cuda", "source": SOURCE,
                        "replaces": B3_REPLACES, "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        **bound(f"coal_rhs[{variant}]", fn.plain, x[:, :256].contiguous(),
                                bench.BENCH_COLUMNS, 6, 6)})
        del fn, x
    print(f"phase 8 seconds {time.perf_counter() - t:.3f}")

    # ---- 9. whole-step kernel arms vs twin --------------------------------
    t = time.perf_counter()
    for variant in VARIANTS:
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            step = fc.make_rainshaft_step_fn(
                vdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz, dt=1.0,
                device=dev, dtype=dt)
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            got = step(x)
            want = step.plain(x)
            torch.cuda.synchronize()
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            err, abs_err = row_scaled(got / norm, want / norm)
            print(f"phase 9 step kernel [{variant}] vs twin {name}: row-scaled {err:.3e} "
                  f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e} (normalized) {card}")
            check(bool(torch.isfinite(got).all()), f"step kernel [{variant}] {name} not finite")
            check(err < TOL[name], f"step kernel [{variant}] {name} vs twin {err:.3e}")
    print(f"phase 9 seconds {time.perf_counter() - t:.3f}")

    # ---- 10. fused per-level RHS kernel, and the fused-RHS route ----------
    t = time.perf_counter()
    for variant in ("fixed2gamma", *VARIANTS):
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            rfn = fc.make_rainshaft_rhs_fn(vdata, sc_cfg.vel, sc_cfg.norms, device=dev,
                                           dtype=dt)
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            got = rfn.soa(x)
            want = rfn.plain(x)
            torch.cuda.synchronize()
            norm = torch.tensor(rfn.plan.mom_norms * 2, dtype=dt, device=dev)[:, None]
            err, abs_err = row_scaled(got / norm, want / norm)
            print(f"phase 10 rhs kernel [{variant}] vs twin {name}: row-scaled {err:.3e} "
                  f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e} (normalized) {card}")
            check(bool(torch.isfinite(got).all()), f"rhs kernel [{variant}] {name} not finite")
            check(err < TOL[name], f"rhs kernel [{variant}] {name} vs twin {err:.3e}")
    sc = harness.SCENARIOS["pod_ensemble"](
        n_columns=N_POD_COLUMNS, device=dev, dtype=torch.float32)
    cfg = sc["config"]
    rfn = fc.make_rainshaft_rhs_fn(sc["data"], cfg.vel, cfg.norms, device=dev)
    rhs = rs.make_rainshaft_rhs_fused(cfg, rfn)
    rfn.soa(sc["state0"][:, :NZ].contiguous())  # warm-up outside the count
    torch.cuda.synchronize()
    rfn.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    y = sc["state0"]
    for _ in range(N_FUSED_STEPS):
        y = stepper.ssprk33_step(rhs, y, 0.0, cfg.dt)
    end.record()
    end.synchronize()
    fused_s = start.elapsed_time(end) / 1e3
    rhs_launches = rfn.launches
    check(rhs_launches == 3 * N_FUSED_STEPS,
          f"rhs kernel launched {rhs_launches} times, not {3 * N_FUSED_STEPS}")
    yb = sc["state0"]
    for _ in range(N_FUSED_STEPS):
        yb = sc["step"](yb)
    ferr, _ = row_scaled(y, yb)
    print(f"phase 10 fused-RHS route fixed2gamma {N_POD_COLUMNS} x {NZ} x {N_FUSED_STEPS} "
          f"f32: {fused_s / N_FUSED_STEPS * 1e3:.4f} ms/step, "
          f"{N_POD_COLUMNS * N_FUSED_STEPS / fused_s:.4e} column-updates/s, rhs launches "
          f"{rhs_launches}; vs {N_FUSED_STEPS} whole steps: row-scaled {ferr:.3e} "
          f"(tol {TOL['float32']:.0e}) {card}")
    check(bool(torch.isfinite(y).all()), "fused-RHS route not finite")
    check(ferr < TOL["float32"], f"fused-RHS route vs whole step {ferr:.3e}")
    del y, yb
    norm = torch.tensor(rfn.plan.mom_norms * 2, dtype=torch.float32, device=dev)[:, None]
    rerr, rabs = row_scaled(rfn.soa(sc["state0"]) / norm, rfn.plain(sc["state0"]) / norm)
    print(f"phase 10 rhs kernel vs twin at the main-path shape [6, {N_POD_COLUMNS * NZ}] "
          f"f32: row-scaled {rerr:.3e} (tol {TOL['float32']:.0e}), max abs {rabs:.3e} "
          f"(normalized) {card}")
    check(rerr < TOL["float32"], f"rhs kernel vs twin at the main-path shape {rerr:.3e}")
    rhs_ms = _time_ms(lambda: rfn.soa(sc["state0"]), 5)
    rhs_plain_ms = _time_ms(lambda: rfn.plain(sc["state0"]), 2)
    print(f"phase 10 per call at [6, {N_POD_COLUMNS * NZ}]: rhs kernel {rhs_ms:.4f} ms, "
          f"rhs twin {rhs_plain_ms:.4f} ms {card}")
    kernels.append({"name": "rainshaft_rhs", "route": "cuda", "source": SOURCE,
                    "replaces": B4_REPLACES, "launches": rhs_launches,
                    "max_abs_err": rabs, "max_row_scaled_err": rerr,
                    "ms": rhs_ms, "plain_ms": rhs_plain_ms,
                    **bound("rainshaft_rhs", rfn.plain, sc["state0"][:, :8 * NZ].contiguous(),
                            N_POD_COLUMNS * NZ, 6, 12)})
    del sc, rfn, rhs
    torch.cuda.empty_cache()
    print(f"phase 10 seconds {time.perf_counter() - t:.3f}")

    # ---- 11. the moving and lognorm pod scenarios at full width -----------
    t = time.perf_counter()
    for variant, scenario in VARIANTS.items():
        sc = harness.SCENARIOS[scenario](
            n_columns=N_POD_COLUMNS, device=dev, dtype=torch.float32)
        sc["n_steps"] = N_VARIANT_STEPS  # of the scenario's 120: the time budget
        sc["step"].launches = 0
        y, pod_s, clock = sc["run"](N_VARIANT_STEPS)
        n_launch = sc["step"].launches
        check(n_launch == sc["n_steps"],
              f"[{variant}] whole-step kernel launched {n_launch} times, not {sc['n_steps']}")
        rep = metrics.conservation_report(sc["spec"], rs.from_soa(y, NZ))
        finite = bool(torch.isfinite(y).all())
        print(f"phase 11 {scenario} {N_POD_COLUMNS} x {NZ} x {sc['n_steps']} f32: "
              f"{pod_s:.4f} s ({clock}), {pod_s / sc['n_steps'] * 1e3:.4f} ms/step, "
              f"{N_POD_COLUMNS * sc['n_steps'] / pod_s:.4e} column-updates/s, launches "
              f"{n_launch}, finite {finite}, negative_fraction {rep['negative_fraction']}, "
              f"nonfinite_fraction {rep['nonfinite_fraction']}, total_mass "
              f"{rep['total_mass']:.6e} {card}")
        check(finite and rep["nonfinite_fraction"] == 0.0, f"[{variant}] pod state not finite")
        check(rep["negative_fraction"] == 0.0, f"[{variant}] pod state has negative moments")
        yt = sc["state0"][:, :N_CMP_COLUMNS * NZ].contiguous()
        for _ in range(sc["n_steps"]):
            yt = sc["step"].plain(yt)
        perr, _ = row_scaled(y[:, :N_CMP_COLUMNS * NZ], yt)
        print(f"phase 11 [{variant}] first {N_CMP_COLUMNS} columns vs twin on the card: "
              f"row-scaled {perr:.3e} (tol {TOL['float32']:.0e}) {card}")
        check(perr < TOL["float32"], f"[{variant}] pod kernel vs twin {perr:.3e}")
        del y, yt
        norm = torch.tensor(sc["step"].plan.mom_norms, dtype=torch.float32,
                            device=dev)[:, None]
        err, abs_err = row_scaled(sc["step"](sc["state0"]) / norm,
                                  sc["step"].plain(sc["state0"]) / norm)
        check(err < TOL["float32"],
              f"[{variant}] step kernel vs twin at the main-path shape {err:.3e}")
        plain_ms = _time_ms(lambda: sc["step"].plain(sc["state0"]), 1)
        print(f"phase 11 [{variant}] step kernel vs twin at [6, {N_POD_COLUMNS * NZ}] f32: "
              f"row-scaled {err:.3e}, max abs {abs_err:.3e} (normalized); kernel "
              f"{pod_s / sc['n_steps'] * 1e3:.4f} ms/step, twin {plain_ms:.4f} ms/step {card}")
        kernels.append({"name": f"rainshaft_step[{variant}]", "route": "cuda",
                        "source": SOURCE, "replaces": B1_REPLACES, "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err,
                        "ms": pod_s / sc["n_steps"] * 1e3, "plain_ms": plain_ms,
                        **bound(f"rainshaft_step[{variant}]", sc["step"].plain,
                                sc["state0"][:, :8 * NZ].contiguous(),
                                N_POD_COLUMNS * NZ, 6, 6)})
        del sc
        torch.cuda.empty_cache()
    print(f"phase 11 seconds {time.perf_counter() - t:.3f}")

    # ---- 12. f64 anchor per variant: kernel vs twin over 120 steps --------
    t = time.perf_counter()
    for variant, scenario in VARIANTS.items():
        sc = harness.SCENARIOS[scenario](
            n_columns=N_ANCHOR_COLUMNS, device=dev, dtype=torch.float64)
        y, _, _ = sc["run"](N_VARIANT_STEPS)
        yt = sc["state0"]
        for _ in range(N_VARIANT_STEPS):
            yt = sc["step"].plain(yt)
        aerr, _ = row_scaled(y, yt)
        print(f"phase 12 [{variant}] f64 anchor ({N_ANCHOR_COLUMNS} columns, "
              f"{N_VARIANT_STEPS} steps): kernel vs twin row-scaled {aerr:.3e} "
              f"(tol {TOL['float64']:.0e}) {card}")
        check(bool(torch.isfinite(y).all()), f"[{variant}] f64 anchor not finite")
        check(aerr < TOL["float64"], f"[{variant}] f64 anchor {aerr:.3e}")
    print(f"phase 12 seconds {time.perf_counter() - t:.3f}")

    # ---- 13. the direct-quadrature kernel vs its twin ----------------------
    t = time.perf_counter()
    num_kernels = {
        "linear": K.LinearKernelFunction(5e-3),
        "constant": K.ConstantKernelFunction(1e-3),
        "long": K.LongKernelFunction(2.0, 1e-3, 5e-3),
        "hydro": K.HydrodynamicKernelFunction(1e-2),
    }
    two_gamma = (Family.GAMMA, Family.GAMMA)
    three_mode = (Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL)

    def numerical_moments(families, n, seed):
        """Normalized moments [n_tot, n], parameters drawn first
        (tests/test_pallas_numerical.py:16-29); box 5 empty, box 7 with an
        empty second mode."""
        rng = np.random.default_rng(seed)
        cols = []
        for fam in families:
            p1, p2 = (((-1.0, 1.0), (0.3, 1.0)) if fam == Family.LOGNORMAL
                      else ((0.05, 5.0), (0.5, 5.0)))
            cols.append(np.stack([rng.uniform(10, 200, n), rng.uniform(*p1, n),
                                  rng.uniform(*p2, n)], -1))
        vspec = SpectrumSpec(families)
        mom = pd.get_moments(vspec, torch.as_tensor(np.stack(cols, 1))).numpy().T.copy()
        mom[:, 5] = 0.0
        if vspec.n_modes > 1:
            mom[vspec.offsets[1]:, 7] = 0.0
        return vspec, mom

    one_gamma = (Family.GAMMA,)
    for families, kname in [(two_gamma, k) for k in sorted(num_kernels)] + [
            (three_mode, "long"), (one_gamma, "long"), (one_gamma, "linear")]:
        vspec, mom_np = numerical_moments(families, N_NUM_BOXES, seed=5)
        cancelling = (1,) if len(families) == 1 else ()  # a lone mode keeps its mass
        scale_note = " (mass row over the size of the sums it is left of)" if cancelling else ""
        got_by_type = {}
        for name, dt in dtypes.items():
            fn = nc.make_numerical_fn(vspec, num_kernels[kname], *NUM_NODES, device=dev,
                                      dtype=dt)
            x = torch.as_tensor(mom_np, dtype=dt, device=dev)
            got = fn.soa(x)
            check(fn.launches == 1, "numerical wrapper did not count one launch")
            want = fn.plain(x)
            torch.cuda.synchronize()
            err, abs_err = row_scaled(got, want, cancelling)
            finite = bool(torch.isfinite(got).all())
            empty_zero = bool((got[:, 5] == 0).all())
            repeat = bool(torch.equal(got, fn.soa(x)))
            print(f"phase 13 numerical kernel [{len(families)} modes, {kname}] vs twin "
                  f"{name}: row-scaled{scale_note} {err:.3e} (tol {NUM_TOL[name]:.0e}), max abs "
                  f"{abs_err:.3e}, finite {finite}, empty box exactly zero {empty_zero}, "
                  f"second launch bit-identical {repeat} {card}")
            check(finite, f"numerical kernel [{kname}] {name} not finite")
            check(empty_zero, f"numerical kernel [{kname}] {name}: empty box not zero")
            check(repeat, f"numerical kernel [{kname}] {name}: two launches differ")
            check(err < NUM_TOL[name], f"numerical kernel [{kname}] {name} vs twin {err:.3e}")
            got_by_type[name] = got
        err, _ = row_scaled(got_by_type["float32"], got_by_type["float64"], cancelling)
        print(f"phase 13 numerical kernel [{len(families)} modes, {kname}] f32 kernel vs "
              f"f64 kernel: row-scaled {err:.3e} (tol {NUM_TOL['float32']:.0e}) {card}")
        check(err < NUM_TOL["float32"], f"numerical f32 vs f64 kernel [{kname}] {err:.3e}")
    print(f"phase 13 seconds {time.perf_counter() - t:.3f}")

    # ---- 14. the numerical bench: 262,144 boxes through the kernel ---------
    t = time.perf_counter()
    nfn = bench.numerical_fn(dev)
    n_box = bench.NUMERICAL_COLUMNS
    x = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=torch.float32, device=dev)
    nfn.soa(x[:, :64].contiguous())  # loads the module, outside the count
    torch.cuda.synchronize()
    nfn.launches = 0
    s_chain = bench.time_chain(nfn.soa, x, N_NUM_STEPS)  # 3 untimed steps first
    num_launches = nfn.launches
    y = bench.relax_chain(nfn.soa, x, N_NUM_STEPS)  # the chain's end state
    finite = bool(torch.isfinite(y).all())
    print(f"phase 14 numerical RHS chain {n_box} boxes f32, Long kernel, nodes "
          f"{nfn.plan.n_po} x {nfn.plan.g_outer} outer and {nfn.plan.n_pi} x "
          f"{nfn.plan.g_inner} inner: {s_chain * 1e3:.4f} ms per RHS step, "
          f"{n_box * 6 / s_chain:.4e} moment-updates/s, launches {num_launches}, "
          f"finite {finite} {card}")
    check(num_launches == N_NUM_STEPS + 3,
          f"numerical kernel launched {num_launches} times, not {N_NUM_STEPS + 3}")
    check(finite, "numerical chain state not finite")
    got = nfn.soa(x)
    want = nfn.plain(x, chunk=NUM_CHUNK)
    nerr, nabs = row_scaled(got, want)
    dm1 = float((got[1] + got[4]).abs().max() / got[1].abs().max())
    print(f"phase 14 numerical kernel vs twin (chunks of {NUM_CHUNK} boxes) at the "
          f"main-path shape [6, {n_box}] f32: row-scaled {nerr:.3e} (tol "
          f"{NUM_TOL['float32']:.0e}), max abs {nabs:.3e}, finite "
          f"{bool(torch.isfinite(got).all())}; total-mass tendency over the largest "
          f"mass tendency {dm1:.3e} {card}")
    check(bool(torch.isfinite(got).all()), "numerical kernel at the main-path shape not finite")
    check(nerr < NUM_TOL["float32"], f"numerical kernel vs twin at the main-path shape {nerr:.3e}")
    num_ms = _time_ms(lambda: nfn.soa(x), 10)
    num_plain_ms = _time_ms(lambda: nfn.plain(x, chunk=NUM_CHUNK), 1)
    print(f"phase 14 per call at [6, {n_box}]: numerical kernel {num_ms:.4f} ms, "
          f"twin {num_plain_ms:.4f} ms {card}")
    kernels.append({"name": "numerical_rhs", "route": "cuda", "source": NUM_SOURCE,
                    "replaces": B5_REPLACES, "launches": num_launches,
                    "max_abs_err": nabs, "max_row_scaled_err": nerr,
                    "ms": num_ms, "plain_ms": num_plain_ms,
                    **bound("numerical_rhs", nfn.plain, x[:, :64].contiguous(), n_box, 6, 6)})
    del x, y, got, want
    torch.cuda.empty_cache()
    print(f"phase 14 seconds {time.perf_counter() - t:.3f}")

    # ---- 15. the box scenarios on the card, and the kernel at box nodes ----
    t = time.perf_counter()
    for scenario in BOX_SCENARIOS:
        with np.load(ROOT / "tests" / "golden" / f"{scenario}.npz") as z:
            ys_g = z["ys"]
        ys, rep = harness.run_scenario(scenario, device=dev)
        berr = float(np.abs(ys.cpu().numpy() / ys_g - 1.0).max())
        print(f"phase 15 {scenario} f64 on {rep['device']}: {rep['n_steps']} steps in "
              f"{rep['seconds']:.3f} s (host clock), finite {rep['finite']}, total_mass "
              f"{rep['total_mass']:.6e}; vs the stored trajectory: max relative "
              f"{berr:.3e} (tol {BOX_TOL:.0e}) {card}")
        check(rep["finite"] and tuple(ys.shape) == ys_g.shape, f"{scenario} not finite")
        check(berr < BOX_TOL, f"{scenario} vs golden {berr:.3e}")
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(bench.NORMS)
    norm = np.asarray(get_moments_normalizing_factors(spec.nprogmoms, bench.NORMS))
    mom0 = torch.tensor(np.array([1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13]) / norm,
                        device=dev)[:, None].contiguous()
    bfn = nc.make_numerical_fn(spec, kf, 256, 96, device=dev, dtype=torch.float64)
    got = bfn.soa(mom0)[:, 0]
    want = cn.get_coal_ints_numerical(spec, pd.params_from_moments(spec, mom0.T), kf)[0]
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-13 * want.abs().max())).max())
    print(f"phase 15 numerical kernel at (256, 96) nodes ({bfn.plan.g_total} threads) on "
          f"the numerical box's initial state vs the einsum path on the card, f64: max "
          f"relative {rel:.3e} (tol 1e-08) {card}")
    check(rel < 1e-8, f"numerical kernel vs einsum path at box nodes {rel:.3e}")
    print(f"phase 15 seconds {time.perf_counter() - t:.3f}")

    # ---- 16. calibration: EKI through the scaled whole step (B1s) ---------
    t = time.perf_counter()
    from cloudy_tpu_torch.tools import calibration_bench as cb

    for variant in ("fixed2gamma", *VARIANTS):
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            step = fc.make_rainshaft_step_fn(
                vdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz, dt=1.0,
                device=dev, dtype=dt, kernel_scale=True)
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            srow = torch.linspace(0.4, 2.5, N_CMP_COLUMNS, dtype=dt,
                                  device=dev).repeat_interleave(NZ)
            got = step(x, srow)
            check(step.launches == 1, "scaled step wrapper did not count one launch")
            want = step.plain(x, srow)
            torch.cuda.synchronize()
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            err, abs_err = row_scaled(got / norm, want / norm)
            print(f"phase 16 scaled step kernel [{variant}, arms {step.plan.arms}] vs twin "
                  f"{name}, scale 0.4-2.5 per column: row-scaled {err:.3e} (tol "
                  f"{TOL[name]:.0e}), max abs {abs_err:.3e} (normalized) {card}")
            check(bool(torch.isfinite(got).all()), f"scaled step [{variant}] {name} not finite")
            check(err < TOL[name], f"scaled step [{variant}] {name} vs twin {err:.3e}")
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data_s = build_coalescence_data(spec, K.CoalescenceTensor(1.7 * ker.array),
                                    (5e-10, np.inf), norms=(1e6, 1e-9), fast_tier=True)
    kw = dict(nz=NZ, dz=sc_cfg.dz, dt=1.0, device=dev, dtype=torch.float64)
    x = torch.as_tensor(state_np, dtype=torch.float64, device=dev)
    got = fc.make_rainshaft_step_fn(fdata, sc_cfg.vel, sc_cfg.norms, kernel_scale=True,
                                    **kw)(x, 1.7)
    want = fc.make_rainshaft_step_fn(data_s, sc_cfg.vel, sc_cfg.norms, **kw)(x)
    ierr, _ = row_scaled(got, want)
    print(f"phase 16 scaled step kernel at s = 1.7 vs the unscaled kernel from the "
          f"1.7-scaled kernel tensor, f64: row-scaled {ierr:.3e} (tol {TOL['float64']:.0e}) "
          f"{card}")
    check(ierr < TOL["float64"], f"scaled step vs scaled tensor {ierr:.3e}")

    records = {}
    for rec in cb.pod_main(dev, members=CAL_MEMBERS, n_steps=CAL_STEPS):
        records[rec["ensemble_members"]] = rec
        print(f"phase 16 EKI J={rec['ensemble_members']} x {rec['member_columns']} columns "
              f"x {rec['nz']} levels x {rec['forward_steps']} steps f32 through B1s: "
              f"{rec['seconds_per_iter'] * 1e3:.4f} ms per iteration (n1 {rec['n1']}, n2 "
              f"{rec['n2']}, median of 5, CUDA events), {rec['eki_iters_per_s']:.4f} "
              f"iterations/s, {rec['member_forwards_per_s']:.4e} member forwards/s, "
              f"{rec['member_model_steps_per_s']:.4e} member model steps/s, "
              f"{rec['member_column_steps_per_s']:.4e} member column-steps/s; one forward "
              f"{rec['forward_seconds'] * 1e3:.4f} ms; 8 iterations: s "
              f"{rec['s_recovered_8iters']:.6f} (true 1.7), {rec['b1s_launches_8iters']} "
              f"launches, observables finite {rec['observables_finite']}, misfit "
              f"{rec['misfit_8iters'][0]:.4e} -> {rec['misfit_8iters'][-1]:.4e} {card}")
        print(json.dumps({**rec, "card": smi.splitlines()[0]}))
    rec = records[CAL_MEMBERS[-1]]
    want_launches = 9 * CAL_STEPS
    check(rec["b1s_launches_8iters"] == want_launches,
          f"B1s launched {rec['b1s_launches_8iters']} times in the 8-iteration EKI run, "
          f"not {want_launches}")
    check(all(r["observables_finite"] for r in records.values()), "EKI observables not finite")
    check(abs(rec["s_recovered_8iters"] - 1.7) / 1.7 < 0.02,
          f"EKI recovered s = {rec['s_recovered_8iters']:.6f}, not within 2 % of 1.7")

    # B1s against its twin at the main path's shape, and the times there
    n_ens = CAL_MEMBERS[-1]
    forward, _ = cb.make_pod_forward(n_ens, device=dev)
    state = forward.state0
    theta = torch.linspace(math.log(0.5), math.log(3.0), n_ens, device=dev)
    srow = torch.exp(theta).repeat_interleave(state.shape[1] // n_ens)
    step = forward.step
    norm = torch.tensor(step.plan.mom_norms, dtype=torch.float32, device=dev)[:, None]
    y = state
    for _ in range(10):  # a state with both modes populated
        y = step(y, srow)
    serr, sabs = row_scaled(step(y, srow) / norm, step.plain(y, srow) / norm)
    print(f"phase 16 scaled step kernel vs twin at the main-path shape [6, {state.shape[1]}] "
          f"f32 (after 10 steps, scale 0.5-3.0 by member): row-scaled {serr:.3e} (tol "
          f"{TOL['float32']:.0e}), max abs {sabs:.3e} (normalized) {card}")
    check(serr < TOL["float32"], f"scaled step vs twin at the main-path shape {serr:.3e}")
    b1s_ms = _time_ms(lambda: step(y, srow), 100)
    b1s_plain_ms = _time_ms(lambda: step.plain(y, srow), 5)
    print(f"phase 16 per call at [6, {state.shape[1]}]: B1s kernel {b1s_ms:.4f} ms, B1s twin "
          f"{b1s_plain_ms:.4f} ms; unscaled B1 fixed2gamma at [6, {N_POD_COLUMNS * NZ}] in "
          f"this call (phase 6) {b1_ms:.4f} ms/step (recorded spread 27.15-27.50) {card}")
    small = 8 * NZ
    kernels.append({"name": "rainshaft_step[scaled]", "route": "cuda", "source": SOURCE,
                    "replaces": B1S_REPLACES, "launches": rec["b1s_launches_8iters"],
                    "max_abs_err": sabs, "max_row_scaled_err": serr,
                    "ms": b1s_ms, "plain_ms": b1s_plain_ms,
                    **bound("rainshaft_step[scaled]",
                            lambda v: step.plain(v, srow[:small]),
                            y[:, :small].contiguous(), state.shape[1], 7, 6)})
    del forward, state, y, step
    torch.cuda.empty_cache()
    print(f"phase 16 seconds {time.perf_counter() - t:.3f}")

    print(f"total seconds {time.perf_counter() - t_all:.3f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _time_ms(fn, n):
    """Milliseconds per call on the card (CUDA events, one warm-up call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


if __name__ == "__main__":
    main()
