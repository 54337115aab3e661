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
   the main path's shapes (f32), and the twins' times there.

The launch counts of both kernels are zeroed just before phase 6 and read
after the timed chain of phase 7. The last two lines are a JSON object of
per-kernel numbers (errors from the main-path-shape comparison, the step's
in normalized moment units) and ``{"ok": true, "device": {...}}``. Exits nonzero, printing no result, when
no CUDA device is present or the port's package is missing.

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_POD_COLUMNS = 1 << 20
N_CMP_COLUMNS = 4096
NZ = 32
N_RHS_STEPS = 100
TOL = {"float32": 1e-4, "float64": 1e-9}  # kernel vs twin, row-scaled
GOLDEN_TOL = 1e-3  # fast tier vs the stored f64 Simpson-tier trajectory
B1_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:876"
B3_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:662"
SOURCE = "cloudy_tpu_torch/csrc/fused_coalescence.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def row_scaled(got, want):
    """max over rows of |got - want| / max|want| of the row, and max abs."""
    d = (got.double() - want.double()).abs()
    scale = want.double().abs().amax(dim=1).clamp_min(1e-300)
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

    from cloudy_tpu_torch import bench, harness
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch.ops import fused_coalescence as fc
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
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]
    print(f"phase 2 build: {_build.library_path().name} in {build_s:.3f} s {card}")
    for ln in regs:
        print(f"  ptxas: {ln}")
    print(f"phase 2 seconds {time.perf_counter() - t:.3f}")

    spec, bdata = bench.bench_data()
    results = {}

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
         "ms": pod_s / 120 * 1e3, "plain_ms": step_plain_ms},
        {"name": "coal_rhs", "route": "cuda", "source": SOURCE,
         "replaces": B3_REPLACES, "launches": launches["coal"],
         "max_abs_err": results[("coal", "main")][1],
         "max_row_scaled_err": results[("coal", "main")][0],
         "ms": coal_ms, "plain_ms": coal_plain_ms},
    ]
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
