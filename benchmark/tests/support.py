"""What the benchmark's tests share: each cell cut to a size a test run
holds, and a run of the harness on the CPU at that size."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: each cell cut to a size a test run holds (the traffic's keys)
TINY_TRAFFIC = {
    "pod_fixed2gamma.frames10": {"columns": 64, "scale_levels": 8, "frames_per_job": 2,
                                 "steps_per_frame": 3, "check_columns": 64, "trace_jobs": 1},
}


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cpu_run(bench, workload: str, seed: int = 2**31 + 12345, trace: bool = False,
            seconds: float = 0.01):
    from benchmark import run

    return run.run_cell(workload, seed, seconds, trace, "cpu",
                        copy.deepcopy(TINY_TRAFFIC[workload]), bench=bench)
