"""Where the device time goes: the pod steps and bench.py's RHS chains.

Profiles, on one CUDA device,

1. each pod variant (``pod_ensemble``, ``pod_ensemble_moving``,
   ``pod_ensemble_lognorm``; f32) at 2^20 columns × 32 levels for 20 whole
   steps through the whole-step kernel;
2. ``full_step_fused``: the same ``fixed2gamma`` state advanced 20 SSPRK33
   steps through the fused per-level RHS kernel, with the upwind stencil
   and the RK combinations in torch (`models.rainshaft.make_rainshaft_rhs_fused`
   + `stepper.ssprk33_step`);
3. bench.py's Euler chain (2^20 boxes, f32) for 20 steps through the
   coalescence kernel;
4. the numerical bench's Euler chain (262,144 boxes, Long kernel, f32) for
   20 steps through the direct-quadrature kernel, with ``nvidia-smi``
   samples beside it;
5. ``eki_pod``: EKI at 256 members through the scaled whole-step kernel
   (`tools.calibration_bench.make_pod_forward`), two runs of 4 iterations
   (5 forwards of 60 steps and 4 Kalman updates each),

each under `torch.profiler` inside a window timed by CUDA events. For each
window it prints the profiler's table, each device activity's time, and the
busy share: the device activities' summed time over the window (the idle
share is one minus it). While the unprofiled 120-step run of each pod
variant goes, a thread samples ``nvidia-smi`` for the SM clock and the power
draw.

    python -m cloudy_tpu_torch.tools.profile_step
    python -m cloudy_tpu_torch.tools.profile_step --eki-only

The last line is one JSON object with every number printed before it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import threading

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cloudy_tpu_torch import bench, harness, stepper
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc

N_COLUMNS = 1 << 20
N_STEPS = 20

def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_window(fn, n: int, label: str) -> dict:
    """Run ``fn`` `n` times under the profiler inside a CUDA-event window;
    return the window, each device activity's time and the busy share."""
    fn()  # warm-up outside the window
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    avgs = prof.key_averages()
    print(f"--- {label}: {n} calls, CUDA-event window {window_ms:.4f} ms")
    sort_by = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(avgs.table(sort_by=sort_by, row_limit=8))
    # device activities: kernels, memcpy and memset; host rows (aten:: ops,
    # cudaLaunchKernel and other runtime calls) carry their children's
    # device time and would count it twice
    acts = {e.key: (_device_us(e) / 1e3, e.count) for e in avgs
            if _device_us(e) > 0 and e.device_type == DeviceType.CUDA}
    busy_ms = sum(ms for ms, _ in acts.values())
    for key, (ms, count) in sorted(acts.items(), key=lambda kv: -kv[1][0]):
        print(f"{label} device: {ms / count:.4f} ms x {count} = {ms:.4f} ms "
              f"({100 * ms / window_ms:.2f} % of the window) {key[:80]}")
    share = busy_ms / window_ms if busy_ms > 0 else None
    print(f"{label} busy share: "
          f"{'not measured (no device time in the trace)' if share is None else f'{share:.4f}'}")
    return {"window_ms": window_ms, "busy_share": share,
            "device_ms": {k[:80]: ms for k, (ms, _) in acts.items()}}


def sample_smi(stop: threading.Event, out: list) -> None:
    while not stop.is_set():
        out.append(_smi("clocks.sm,power.draw"))


def profile_eki(n_ens: int = 256, n_iters: int = 4) -> dict:
    """EKI through the scaled whole step at `n_ens` members: the kernel's
    share of the window and what the Kalman update adds."""
    from cloudy_tpu_torch import calibrate
    from cloudy_tpu_torch.tools import calibration_bench as cb

    forward1, truth = cb.make_pod_forward(1)
    forward, _ = cb.make_pod_forward(n_ens)
    y = forward1(truth[None])[0]
    theta0 = calibrate.ensemble_init(torch.Generator("cuda").manual_seed(0), [0.0], [0.7],
                                     n_ens, dtype=torch.float32)
    gen = torch.Generator("cuda").manual_seed(1)
    return profile_window(lambda: calibrate.run_eki(forward, theta0, y, 1e-4, n_iters, gen),
                          2, f"eki_pod J={n_ens}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--eki-only", action="store_true", help="profile the EKI loop alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device: torch.cuda.is_available() is False")
    card = _smi("name,power.limit")
    print(card)

    out = {"card": card, "columns": N_COLUMNS, "steps": N_STEPS}
    if args.eki_only:
        out["eki_pod"] = profile_eki()
        print(card)
        print(json.dumps(out))
        return
    for name in ("pod_ensemble", "pod_ensemble_moving", "pod_ensemble_lognorm"):
        sc = harness.SCENARIOS[name](n_columns=N_COLUMNS, device="cuda")
        state0, step, config = sc["state0"], sc["step"], sc["config"]
        out[name] = profile_window(lambda: step(state0), N_STEPS, f"{name} step")
        if name == "pod_ensemble":
            fused_fn = fc.make_rainshaft_rhs_fn(sc["data"], config.vel, config.norms,
                                                device="cuda")
            rhs = rs.make_rainshaft_rhs_fused(config, fused_fn)
            out["full_step_fused"] = profile_window(
                lambda: stepper.ssprk33_step(rhs, state0, 0.0, config.dt),
                N_STEPS, "full_step_fused")
            del fused_fn, rhs
        samples, stop = [], threading.Event()
        sampler = threading.Thread(target=sample_smi, args=(stop, samples))
        sampler.start()
        _, seconds, _ = sc["run"]()
        stop.set()
        sampler.join()
        print(f"{name} run: {sc['n_steps']} steps in {seconds:.4f} s (CUDA events), "
              f"{N_COLUMNS * sc['n_steps'] / seconds:.4e} column-updates/s")
        print(f"nvidia-smi during the {name} run (sm clock, power draw): {samples}")
        out[name].update(run_s=seconds, smi_samples=samples)
        del sc, state0, step
        torch.cuda.empty_cache()

    _, data = bench.bench_data()
    coal = fc.make_coal_fn(data, device="cuda", dtype=torch.float32)
    mom = torch.as_tensor(bench.bench_moments(bench.BENCH_COLUMNS).T.copy(),
                          dtype=torch.float32, device="cuda")
    box = [mom]

    def chain_step():
        box[0] = bench.relax_chain(coal.soa, box[0], 1)

    out["rhs_chain"] = profile_window(chain_step, N_STEPS, "rhs chain")

    num = bench.numerical_fn("cuda")
    box[0] = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=torch.float32,
                             device="cuda")

    def numerical_step():
        box[0] = bench.relax_chain(num.soa, box[0], 1)

    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_smi, args=(stop, samples))
    sampler.start()
    out["numerical_chain"] = profile_window(numerical_step, N_STEPS, "numerical chain")
    stop.set()
    sampler.join()
    print(f"nvidia-smi during the numerical chain (sm clock, power draw): {samples}")
    out["numerical_chain"]["smi_samples"] = samples
    del num, box
    torch.cuda.empty_cache()
    out["eki_pod"] = profile_eki()
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
