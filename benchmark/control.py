"""The readings that the limits of `correct` are set from, in one process:
the numbers a run compares, for the program on many seeds (a short window
at the cell's own size and load), and for the control on others: the
reference computed in bfloat16, the precision below the float32 the
configurations state, put in the program's place and judged as the
program is. The benchmark's own runs never run the control.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 3

One JSON line per reading on standard output; the last line gives, for
each number, the largest program reading, the smallest control reading
and the configuration's limit. Needs the card, as run.py does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seeds, control_seeds, seconds: float, device: str = "cuda",
             traffic_overrides: dict = None, bench: dict = None):
    """Yield one record per reading: program readings for `seeds`, control
    readings for `control_seeds`; then the summary."""
    import torch

    from benchmark import run
    from benchmark.core.trace import Tracer

    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = run.load_cell(bench, workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    mod = run.load_plugin("drivers", config["driver"])
    dev = torch.device(device)
    lows, highs = {}, {}
    for seed, control in [(s, False) for s in seeds] + [(s, True) for s in control_seeds]:
        t0 = time.perf_counter()
        d = mod.Driver(config, traffic, seed, dev, Tracer(False, dev))
        w = d.run(seconds)
        d.release()
        gaps = d.check(control_dtype=torch.bfloat16 if control else None)
        del d
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for name, (v, _) in gaps.items():
            book = highs if control else lows
            if control:
                book[name] = min(book.get(name, float("inf")), v)
            else:
                book[name] = max(book.get(name, 0.0), v)
        yield {"seed": seed, "reading": "control" if control else "program",
               "attempted": w["attempted"], "gaps": {k: v for k, (v, _) in gaps.items()},
               "seconds": time.perf_counter() - t0}
    yield {"summary": {k: {"program_max": lows.get(k), "control_min": highs.get(k),
                           "limit": config["limits"][k]} for k in config["limits"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds of the control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card; none found", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    for rec in readings(args.workload, seeds, control, args.seconds):
        print(json.dumps(rec, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
