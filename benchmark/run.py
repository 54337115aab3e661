"""The benchmark of cloudy_tpu_torch: one run of one cell on a CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything is found by name from the
cell's entry in BENCHMARK.json: its configuration's file (the deployment,
the driver it uses, its plain reference and its limits), the traffic mix
``benchmark/traffic/<traffic>.json``, the job driver
``benchmark/drivers/<driver>.py``, and one reader per metric,
``benchmark/metrics/<metric>.py``. A cell, a mix or a metric is added by
adding files and entries.

A run sets up the program (its build, its state, a warm-up of every shape
the cell uses: ``setup_s``), measures for ``--seconds`` on the host clock,
reads the peak of device memory, frees the program's state, and judges what
the window produced against the plain reference (`correct`). With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled stretch of the
window. The last line of standard output is the result; the last lines of
standard error give each number compared beside its limit.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result. It exits with code 3 if JAX, or the JAX
package, has been loaded by the time the window closes.
"""

import time

_T_IMPORT = time.time()

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudy_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (from /proc where
    it is readable; else the moment this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


T0 = min(process_start(), _T_IMPORT)


def load_plugin(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``."""
    path = ROOT / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, workload: str):
    """(cell, configuration, traffic) of a cell, from their files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload named {workload!r}; there are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _number(v):
    """A JSON-safe number: a non-finite value becomes null."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             traffic_overrides: dict = None, bench: dict = None) -> dict:
    """One run of `workload`; returns the result object. ``device`` and
    ``traffic_overrides`` exist for the rehearsal on the CPU at a tiny
    size; the command line always asks for the card at the cell's size."""
    import torch

    from benchmark.core.trace import Tracer
    from benchmark.metrics import Context

    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = load_cell(bench, workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    limits = config["limits"]
    dev = torch.device(device)
    driver_mod = load_plugin("drivers", config["driver"])
    tracer = Tracer(trace, dev)
    t_driver = time.time()
    driver = driver_mod.Driver(config, traffic, seed, dev, tracer)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - T0
    print(f"setup: {setup_s:.3f} s, of which the driver's set-up {time.time() - t_driver:.3f} s",
          file=sys.stderr, flush=True)
    window = driver.run(seconds)
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.release()
    gaps = driver.check()
    checks = {name: {"value": _number(v), "limit": limits[name]} for name, (v, _) in gaps.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    failed = 0
    for name, (v, per) in gaps.items():
        if per is not None:
            failed = max(failed, sum(1 for g in per if not g <= limits[name]))
    if not correct:
        failed = max(failed, 1)
    ctx = Context(cell=cell, config=config, traffic=traffic, device=dev, setup_s=setup_s,
                  window=window, trace=tracer.trace, seed=seed)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = _number(load_plugin("metrics", m["name"]).read(ctx))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {
        "correct": correct,
        "attempted": window["attempted"],
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(mem)},
    }
    if trace and tracer.trace is not None:
        tr = tracer.trace
        print(f"trace: host-to-trace clock fit {tr.fit}, {len(tr.device)} device activities, "
              f"spans {dict((k, len(v)) for k, v in tr.spans.items())}", file=sys.stderr)
        result["device"]["busy_s"] = tr.busy_us() / 1e6
        result["device"]["window_s"] = tr.window_us() / 1e6
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths; with
    # them Python's bytecode, which an environment that writes none
    # (PYTHONDONTWRITEBYTECODE) would otherwise compile from torch's sources
    # in every run
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    t_torch = time.time()
    import torch

    print(f"import of torch: {time.time() - t_torch:.3f} s", file=sys.stderr, flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell['chips']} CUDA card(s); found {n}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      bench=bench)
    # read after the window, so that nvidia-smi's start-up is no part of set-up
    print(f"card: {card()}", file=sys.stderr, flush=True)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"the process loaded {loaded}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name}: {c['value']} limit {c['limit']} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
