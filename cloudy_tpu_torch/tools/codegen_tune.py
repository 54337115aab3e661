"""The generated whole step (B1), fused per-level RHS (B4) and coalescence
RHS (B3) against their table-driven instances on the card.

For each pod variant (`harness.POD_VARIANTS`: ``fixed2gamma``, ``moving``,
``lognorm``) or family-matrix case asked for, the generated kernels
(`ops.codegen`) are built, all at once, and reported beside the
table-driven fast instances of csrc/fused_coalescence.cu
(`tools.yardstick`):

- each unit's ``ptxas`` line (registers, stack frame, spills) and seconds
  of ``nvcc``; the SASS counts of LDL, STL, LDS, STS, BAR and SHFL and of
  all instructions (``cuobjdump -sass``), for the generated and the
  table-driven instance side by side; resident blocks per SM
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
- the kernel against its plain twin at 4,096 columns × 32 levels (one
  whole step or one RHS; f32 < 1e-4, f64 < 1e-9, row-scaled in normalized
  units);
- ms per step of B1 at 2^20 columns × 32 levels (f32: chains of `steps`
  whole steps from the pod's initial state, CUDA events, in turns table,
  generated, generated, table; the median of each) and ms per launch of
  B4 on the pod state [6, 2^25] and of B3 on `columns` boxes of
  bench-style moments (`yardstick.coal_moments`), in the same turns.

One JSON record per variant and kernel on stdout, with the card's name and
power limit.

    python -m cloudy_tpu_torch.tools.codegen_tune
    python -m cloudy_tpu_torch.tools.codegen_tune --variants fixed2gamma --kinds step,coal
"""

from __future__ import annotations

import argparse
import itertools
import json
import threading
import time

import torch

from cloudy_tpu_torch.ops import _build
from cloudy_tpu_torch.tools import yardstick as ys
from cloudy_tpu_torch.utils.metrics import card_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(ys.VARIANTS),
                    help="pod variants or family-matrix cases")
    ap.add_argument("--kinds", default="step,rhs")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--columns", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--no-time", action="store_true", help="build, report and check only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("codegen_tune: no CUDA device; the kernels run on the card only")
    dev = torch.device("cuda", 0)
    card = card_name(dev)
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    cases = [(variant, kind, dtypes[dname], *ys.make_fns(variant, kind, dev, dtypes[dname]))
             for variant, kind, dname in itertools.product(args.variants.split(","),
                                                           args.kinds.split(","),
                                                           args.dtypes.split(","))]
    t0 = time.perf_counter()
    # the table-driven library builds beside the generated units
    lib_thread = threading.Thread(target=_build.load_library)
    lib_thread.start()
    records = {r["label"]: r for r in _build.build_generated([c[3].unit for c in cases])}
    lib_thread.join()
    _build.load_library()
    print(f"codegen_tune: built {sum(r['built'] for r in records.values())} generated units "
          f"and the table-driven library in {time.perf_counter() - t0:.3f} s [card: {card}]")
    for variant, kind, dtype, gen, table in cases:
        out = {"variant": variant, "kind": kind, "dtype": str(dtype).split(".")[-1],
               "unit": gen.unit.label, "card": card}
        out["generated"] = ys.gen_report(gen.unit, records[gen.unit.label])
        out["table"] = ys.table_report(kind, dtype, gen.plan.arms, gen.plan)
        out["gen_vs_twin"], finite = ys.check_vs_twin(gen, kind, variant, dev, dtype)
        out["table_vs_twin"], _ = ys.check_vs_twin(table, kind, variant, dev, dtype)
        out["finite"] = finite
        out["ok"] = finite and out["gen_vs_twin"] < ys.TOL[dtype]
        if not args.no_time and dtype == torch.float32:
            x = (ys.coal_moments(variant, args.columns, dev, dtype) if kind == "coal"
                 else ys.pod_state(variant, args.columns, dev, dtype))
            (t_table, t_gen), raw = ys.time_turns([table, gen], kind, x, args.steps)
            out.update({"table_ms": t_table, "gen_ms": t_gen, "turns_ms": raw,
                        "lanes": x.shape[1], "speedup": t_table / t_gen})
            del x
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
