"""Time B5's traced units (the ``KT_GEN`` arm of csrc/numerical_coalescence.cu)
on the card, each against the others in turns, with each unit's ptxas report.

The units: `tools.traced_kernels.traced` (those this tree's tracer takes;
one it refuses is reported and left out), at the numerical bench's state
([6, 262144] f32, (96, 48) nodes; the `traced_kernels.CAPPED` ones at
fewer boxes), as `chip_smoke.py` phase 30(a) times them. Each unit is
first held against its twin on the CPU, the reference semantics, at 128
boxes (f32 and f64, the row-scaled error within `traced_kernels.NUM_TOL`).
With ``--variants KINDS`` it also builds variants of `VARIANT_UNITS` for
the design's choices: ``noinline`` (``cloudy_kernel_gen``, which Q/S calls,
not inlined), ``untabled`` (no y value tabled but y itself: the remainder
recomputes the others per pair, `kernel_expr.TABLE_BUDGET` 1) and
``minblocks1`` (``quad_kernel`` asking for one block per SM, so that ptxas
may take the registers it needs: a patched copy of the source under
build/), and holds `traced_kernels.check_only`'s units against their twin.

The tool runs on any tree whose package has `ops.numerical_coalescence`'s
traced units (`codegen.numerical_unit` with a kernel) and
`tools.yardstick.turns`: to time two trees on one card, copy this file and
tools/traced_kernels.py into the other tree's ``cloudy_tpu_torch/tools/``,
run it from each tree's root in turns (parent, this, this, parent) and
compare the medians. One JSON record per unit on stdout (``--out FILE``
appends them there too):

    python -m cloudy_tpu_torch.tools.traced_tune [--rounds 2] [--tag NAME]
        [--units tensor,lambda,...] [--variants noinline,untabled,minblocks1]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

#: the units the design variants are built for
VARIANT_UNITS = ("coverage", "special", "activations")
NODES = (96, 48)
TYPES = {"f32": torch.float32, "f64": torch.float64}


def _wrapper(kf, dtype, dev="cuda", nodes=NODES):
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    return nc.make_numerical_fn(SpectrumSpec((Family.GAMMA, Family.GAMMA)), kf, *nodes,
                                device=dev, dtype=dtype)


@contextlib.contextmanager
def _budget(n):
    from cloudy_tpu_torch.ops import kernel_expr

    old = kernel_expr.TABLE_BUDGET
    kernel_expr.TABLE_BUDGET = n
    try:
        yield
    finally:
        kernel_expr.TABLE_BUDGET = old


def _min_blocks_source() -> str:
    """csrc/numerical_coalescence.cu with ``quad_kernel``'s launch bounds
    asking for one block per SM, written under build/; its path."""
    from cloudy_tpu_torch.ops import _build

    src = (_build.CSRC / "numerical_coalescence.cu").read_text()
    bounds = "__launch_bounds__(NUM_BLOCK)\n    quad_kernel("
    if bounds not in src:
        raise RuntimeError("quad_kernel's launch bounds were not found to patch")
    path = _build.BUILD_DIR / "variants" / "numerical_coalescence.minblocks1.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(bounds, "__launch_bounds__(NUM_BLOCK, 1)\n    quad_kernel("))
    return str(path)


def variant(fn, kind: str):
    """`fn` (a traced wrapper) launching a variant of its unit: ``noinline``,
    ``untabled`` or ``minblocks1`` (the module docstring)."""
    from cloudy_tpu_torch.ops import codegen, kernel_expr

    u = fn.unit
    if kind == "noinline":
        head = "__device__ __forceinline__ T cloudy_kernel_gen("
        cfg = u.cfg.replace(head, "__device__ __noinline__ T cloudy_kernel_gen(")
        u = dataclasses.replace(u, cfg=cfg, digest=codegen._digest(cfg, u.source))
    elif kind == "minblocks1":
        path = _min_blocks_source()
        source = u.source.replace('#include "numerical_coalescence.cu"', f'#include "{path}"')
        with open(path) as f:
            u = dataclasses.replace(u, source=source,
                                    digest=codegen._digest(u.cfg, source, f.read()))
    elif kind == "untabled":
        with _budget(1):
            u = codegen.numerical_unit(fn.plan.n_modes, fn.dtype,
                                       kernel_expr.trace(fn.plan.kernel_func, fn.dtype))
    else:
        raise ValueError(kind)
    fn._unit = u
    return fn


def _check_moments(n=128, seed=5):
    """Normalized moments [6, n] of seeded two-gamma parameters (phase 30(a)'s)."""
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    rng = np.random.default_rng(seed)
    par = np.stack([np.stack([rng.uniform(10, 200, n), rng.uniform(0.05, 5.0, n),
                              rng.uniform(0.5, 5.0, n)], -1) for _ in range(2)], 1)
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    return pd.get_moments(spec, torch.as_tensor(par)).numpy().T.copy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns (each unit twice a round: in order, then reversed)")
    ap.add_argument("--launches", type=int, default=5, help="launches per turn")
    ap.add_argument("--tag", default="")
    ap.add_argument("--units", default="", help="comma-separated (default: all)")
    ap.add_argument("--variants", default="",
                    help="comma-separated kinds of `variant` (noinline, untabled, minblocks1)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("traced_tune needs a CUDA device: torch.cuda.is_available() is False")
    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch.ops.kernel_expr import KernelTraceError
    from cloudy_tpu_torch.tools import traced_kernels as tk
    from cloudy_tpu_torch.tools import yardstick

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    kfs = tk.traced()
    names = [n for n in (args.units.split(",") if args.units else kfs) if n in kfs]
    fns = {}
    if args.variants:
        for name, kf in tk.check_only().items():
            for dt in TYPES.values():
                fns[f"{name}:check", dt] = _wrapper(kf, dt)
    for name in names:
        try:
            for dt in TYPES.values():
                fns[name, dt] = _wrapper(kfs[name], dt)
                fns[name, dt].unit  # traces it
        except KernelTraceError as e:
            print(json.dumps({"tool": "traced_tune", "unit": name, "tag": args.tag,
                              "refused": str(e)}), flush=True)
            for dt in TYPES.values():
                fns.pop((name, dt), None)
            continue
        for dt in TYPES.values():
            if args.variants and name in VARIANT_UNITS:
                for kind in args.variants.split(","):
                    fns[f"{name}:{kind}", dt] = variant(_wrapper(kfs[name], dt), kind)
    recs = {r["label"]: r for r in _build.build_generated([f.unit for f in fns.values()])}
    build_s = time.perf_counter() - t0

    mom = _check_moments()
    x_bench = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=torch.float32,
                              device="cuda")
    out, timed, refs = {}, {}, {}
    for (key, dt), fn in fns.items():
        tname = next(k for k, v in TYPES.items() if v == dt)
        x = torch.as_tensor(mom, dtype=dt)
        got = fn.soa(x.cuda())
        name = key.split(":")[0] if key.endswith(("noinline", "untabled", "minblocks1")) else key
        if (name, dt) not in refs:  # a unit's variants share its twin
            refs[name, dt] = fn.plain(x)
        err = yardstick._row_scaled(got.cpu(), refs[name, dt])
        rec = recs[fn.unit.label]
        entry = out.setdefault(key, {"unit": key, "tag": args.tag, "card": card})
        entry[f"label_{tname}"] = fn.unit.label
        entry[f"ptxas_{tname}"] = _build.ptxas_report(rec.get("log", ""))
        entry[f"ptxas_lines_{tname}"] = [ln.strip() for ln in rec.get("log", "").splitlines()
                                         if "registers" in ln or "stack frame" in ln]
        entry[f"nvcc_s_{tname}"] = rec.get("seconds")
        entry[f"vs_twin_{tname}"] = err
        entry[f"vs_twin_ok_{tname}"] = bool(torch.isfinite(got).all()) and \
            err < tk.NUM_TOL[str(dt).removeprefix("torch.")]
        entry["gen"] = dict(getattr(fn.unit, "gen", ()) or ())
        if dt == torch.float32 and not key.endswith(":check"):
            xt = x_bench[:, :tk.CAPPED.get(key.split(":")[0], x_bench.shape[1])].contiguous()
            entry["boxes"] = xt.shape[1]
            fn.soa(xt)  # loads the unit at this width, outside the turns
            timed[key] = lambda _, fn=fn, xt=xt: fn.soa(xt)
    order = list(timed)
    turns = {k: [] for k in order}
    for _ in range(args.rounds):
        _, times = yardstick.turns([timed[k] for k in order], x_bench, args.launches,
                                   chain=False)
        for i, k in enumerate(order):
            turns[k] += times[i]
    for k, e in out.items():
        if k in turns:
            e["turns_ms"] = turns[k]
            e["median_ms"] = float(np.median(turns[k]))
        e["seconds"] = time.perf_counter() - t0
        e["build_s"] = build_s
        line = json.dumps({"tool": "traced_tune", **e})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    if not all(v for e in out.values() for kk, v in e.items() if kk.startswith("vs_twin_ok")):
        raise SystemExit("a traced unit disagrees with its twin")


if __name__ == "__main__":
    main()
