"""Where the device time goes: the pod whole step and bench.py's RHS chain.

Profiles, on one CUDA device,

1. the pod ensemble (``fixed2gamma``, f32) at 2^20 columns × 32 levels for
   20 whole steps through the whole-step kernel, and
2. bench.py's Euler chain (2^20 boxes, f32) for 20 steps through the
   coalescence kernel,

each under `torch.profiler` inside a window timed by CUDA events. For each
window it prints the profiler's table, each device activity's time, and the
busy share: the device activities' summed time over the window (the idle
share is one minus it). While the unprofiled pod run of 120 steps goes, a
thread samples ``nvidia-smi`` for the SM clock and the power draw.

    python -m cloudy_tpu_torch.tools.profile_step

The last line is one JSON object with every number printed before it.
"""

from __future__ import annotations

import json
import subprocess
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from cloudy_tpu_torch import bench, harness
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
    # device activities: kernels, memcpy and memset (aten:: rows repeat them)
    acts = {e.key: (_device_us(e) / 1e3, e.count) for e in avgs
            if _device_us(e) > 0 and not e.key.startswith("aten::")}
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device: torch.cuda.is_available() is False")
    card = _smi("name,power.limit")
    print(card)

    sc = harness.SCENARIOS["pod_ensemble"](n_columns=N_COLUMNS, device="cuda")
    state0, step = sc["state0"], sc["step"]
    pod = profile_window(lambda: step(state0), N_STEPS, "pod step")

    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_smi, args=(stop, samples))
    sampler.start()
    _, seconds, _ = sc["run"]()
    stop.set()
    sampler.join()
    print(f"pod run: {sc['n_steps']} steps in {seconds:.4f} s (CUDA events)")
    print(f"nvidia-smi during the run (sm clock, power draw): {samples}")
    del sc, state0, step

    _, data = bench.bench_data()
    coal = fc.make_coal_fn(data, device="cuda", dtype=torch.float32)
    mom = torch.as_tensor(bench.bench_moments(bench.BENCH_COLUMNS).T.copy(),
                          dtype=torch.float32, device="cuda")
    box = [mom]

    def chain_step():
        box[0] = bench.relax_chain(coal.soa, box[0], 1)

    chain = profile_window(chain_step, N_STEPS, "rhs chain")
    print(card)
    print(json.dumps({
        "card": card, "columns": N_COLUMNS, "steps": N_STEPS,
        "pod_step": pod, "pod_run_s": seconds, "smi_samples": samples,
        "rhs_chain": chain,
    }))


if __name__ == "__main__":
    main()
