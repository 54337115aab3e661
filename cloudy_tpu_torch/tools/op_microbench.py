"""The card's cost per element for each operation class: B6 on the H100.

Port of tools/op_microbench.py. Each chain of `ops.op_chains` (the JAX
tool's 18: 12 primitive and mixed chains, 6 special-function bundles)
applies K serial links of its bundle to ILP independent streams, one CUDA
thread per column of ``x [ilp, n]`` (csrc/op_chains.cu). Two chain lengths
are timed and differenced, which cancels the launch and the loads and
stores; divided by the elements ``n·ilp`` that gives seconds per element
per link (:189-190). A nonnegative least-squares fit over the chain system,
each chain's row its class counts plus a per-link memory column of 1, rows
weighted by 1/b so that the residuals are relative, gives seconds per
element-operation for each class (:266-282). The class costs are marginal
costs: the memory column takes what every link pays whatever its
operations (:257-265).

Sized for the card, where the JAX tool's blocks ([64, 1024] × 8) run in
microseconds, under the launch-to-launch floor: ``n`` fills every SM in
whole waves at the kernel instance's occupancy (about 2048 threads per SM),
ILP stays 8, K1 is the JAX tool's short length (32; bundles 4;
gammaincinv_gl12 2) and K2 is set by a pilot so that the K2 launch runs
about 3 ms (at least 2 ms, with at least 1 ms of it the K2 − K1 links).
Each launch starts from the same inputs, U(0.3, 0.9) from
``numpy.random.default_rng(0)``, the range each chain was designed for;
each length is timed by CUDA events around single launches, median of
`reps`. Before the sweep each kernel is held against its twin at K1 links
over the same elements (relative error per element: f64 ≤ 1e-12, f32 ≤
1e-5; the f32 kernel of a `CANCELLING` chain against the f64 twin,
≤ `TOL_CANCELLING`: `compare`). The mul
and add chains cannot run faster than the card executes their instruction,
one per lane and clock: a reading under ``1 / (SMs · lanes · max SM
clock)`` (128 FP32 or 64 FP64 lanes per SM) is a timing fault and raises.
``nvidia-smi`` samples the SM clock and the power draw during the sweep.

Records per chain and type on stdout (JSON), then the fit and the class
table per type. ``--device cpu`` runs the twin on the host at a small
size: its times are host times, and no floor is checked. ``--out DIR``
writes ``DIR/op_microbench.json``; ``--refit FILE`` re-solves the fit from
the records stored in such a file. The tool writes nothing else.

    python -m cloudy_tpu_torch.tools.op_microbench
    python -m cloudy_tpu_torch.tools.op_microbench --dtype f32 --out DIR
    python -m cloudy_tpu_torch.tools.op_microbench --device cpu
    python -m cloudy_tpu_torch.tools.op_microbench --refit DIR/op_microbench.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import threading
import time

import numpy as np
import torch

from cloudy_tpu_torch.ops import op_chains as oc
from cloudy_tpu_torch.tools import opcount

DTYPES = {"f32": torch.float32, "f64": torch.float64}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # kernel vs twin, relative
#: chains whose link subtracts terms several times its result (lgamma about
#: 0.3 from terms near 5): in f32 rounding alone moves them by more than
#: `TOL` (the f32 twin itself reads up to 1.4e-5 from the f64 twin), so their
#: f32 kernel is held to the f64 twin on the same inputs, at `TOL_CANCELLING`
CANCELLING = ("lgamma", "lgamma_stirling")
TOL_CANCELLING = 2e-5
#: FP32 and FP64 lanes of one H100 SM (the Hopper architecture white paper)
LANES_PER_SM = {torch.float32: 128, torch.float64: 64}
TARGET_MS = 3.0  # the K2 launch
MIN_K2_MS, MIN_DIFF_MS = 2.0, 1.0
CPU_COLUMNS = 256  # columns of x on the host


def fit(links: dict) -> dict:
    """The JAX tool's fit (:266-282) of seconds per element per link
    (`links`, one per chain): per class ``sec_per_elem_op``,
    ``slots_vs_mul`` and ``elem_ops_per_s``, the memory column and the
    relative residual per chain and at its maximum."""
    from scipy.optimize import nnls

    names = list(oc.CHAINS)
    A = np.array(
        [[oc.CHAINS[n][0].get(c, 0) for c in oc.CLASSES] + [1.0] for n in names], float)
    b = np.array([links[n] for n in names])
    w = 1.0 / b
    t_fit, _ = nnls(A * w[:, None], b * w)
    resid_rel = np.abs(A @ t_fit / b - 1.0)
    costs = dict(zip(oc.CLASSES, t_fit[:-1]))
    mul = max(costs["mul"], 1e-15)
    return {
        "mem_sec_per_elem_link": float(t_fit[-1]),
        "ls_residual_rel_max": float(resid_rel.max()),
        "ls_residual_rel": {n: float(r) for n, r in zip(names, resid_rel)},
        "classes": {
            c: {"sec_per_elem_op": float(costs[c]),
                "slots_vs_mul": float(costs[c] / mul),
                "elem_ops_per_s": float(1.0 / costs[c]) if costs[c] > 0 else None}
            for c in oc.CLASSES},
    }


def predict_ms(by_class: dict, lanes: int, classes: dict) -> float:
    """The class model's time of a kernel: ``lanes · Σ_c n_c · t_c`` in ms,
    with `by_class` the operations per lane by class
    (`opcount.count_ops_by_class` over the lanes it ran) and `classes` a
    fit's class table; predicates are priced as adds, ``other`` is not
    priced. The memory column stays out: it is the chains' own per-link
    cost."""
    t = {c: classes[c]["sec_per_elem_op"] for c in oc.PRIMITIVE_CLASSES}
    sec = sum(by_class[c] * t[c] for c in oc.PRIMITIVE_CLASSES)
    sec += sum(by_class["predicate"].values()) * t["add"]
    return 1e3 * lanes * sec


def link_ops(name: str) -> dict:
    """Operations by primitive class per element of one link of chain
    `name`: those of its twin that depend on the element
    (`opcount.count_ops_by_class` with ``data_only``; the constants'
    operations, such as lgamma(2.5) of gammaincinv_gl12, are the kernel's
    once, not per element)."""
    x = inputs(1, 8, torch.float32, "cpu")
    c = opcount.count_ops_by_class(lambda v: oc.chain_plain(name, v, 1), x, data_only=True)
    out = {k: c[k] / x.numel() for k in oc.PRIMITIVE_CLASSES}
    out["predicate"] = {o: v / x.numel() for o, v in c["predicate"].items()}
    out["other"] = {o: v / x.numel() for o, v in c["other"].items()}
    return out


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def floor_sec(dtype: torch.dtype, device) -> float:
    """The least seconds per element per link of a one-instruction link:
    one instruction per lane and clock on every SM at the card's maximum
    SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    return 1.0 / (sms * LANES_PER_SM[dtype] * hz)


def columns(fn: oc.ChainFn, device) -> int:
    """Columns of x: whole waves of `THREADS`-thread blocks at the
    instance's occupancy, about the SMs' resident threads (on the host,
    `CPU_COLUMNS`)."""
    if device.type != "cuda":
        return CPU_COLUMNS
    props = torch.cuda.get_device_properties(device)
    blocks = fn.blocks_per_sm()
    if blocks < 1:
        raise RuntimeError(f"chain {fn.name}: no block of {oc.THREADS} threads fits an SM")
    threads_per_sm = getattr(props, "max_threads_per_multi_processor", 2048)
    waves = max(1, round(threads_per_sm / (blocks * oc.THREADS)))
    return props.multi_processor_count * blocks * oc.THREADS * waves


def inputs(ilp: int, n: int, dtype: torch.dtype, device, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.3, 0.9, (ilp, n)), dtype=dtype, device=device)


def launch_ms(call, x: torch.Tensor, k: int, reps: int) -> float:
    """Median milliseconds of `reps` single calls ``call(x, k)``: CUDA
    events around each launch on the card, the host clock on the CPU."""
    times = []
    for _ in range(reps):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(x, k)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            call(x, k)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def compare(name: str, dtype: torch.dtype, x: torch.Tensor) -> dict:
    """The kernel (the twin on the CPU) against the twin at K1 links on `x`:
    max relative and absolute error; raises above `TOL`. The f32 kernel of
    a `CANCELLING` chain is held instead to the f64 twin on the same inputs,
    at `TOL_CANCELLING` (``vs`` names the reference): f32 rounding alone
    moves it by more than `TOL`, and the kernel's FMA contraction rounds
    otherwise than the twin's separate operations. Its record also holds
    the f32 twin's own error against the f64 twin."""
    fn = oc.chain_kernel(name, dtype)
    k1 = oc.k1_of(name)
    got, want = fn(x, k1).double(), fn.plain(x, k1).double()
    out = {"k1": k1, "max_rel_err": float(((got - want).abs() / want.abs()).max()),
           "max_abs_err": float((got - want).abs().max()), "vs": "twin", "tol": TOL[dtype]}
    err = out["max_rel_err"]
    if dtype == torch.float32 and name in CANCELLING:
        truth = oc.chain_plain(name, x.double(), k1)
        err = float(((got - truth).abs() / truth.abs()).max())
        out.update(vs="f64 twin", tol=TOL_CANCELLING, f64_rel_err=err,
                   twin_f64_rel_err=float(((want - truth).abs() / truth.abs()).max()))
    finite = bool(torch.isfinite(got).all())
    if not finite or not err <= out["tol"]:
        raise RuntimeError(f"chain {name} {dtype} vs {out['vs']} at K1={k1}: relative "
                           f"error {err:.3e} (tol {out['tol']:.3e}), finite {finite}")
    return out


def measure(name: str, dtype: torch.dtype, x: torch.Tensor, reps: int = 5,
            plain: bool = False) -> dict:
    """Seconds per element per link of chain `name` on `x` (K1 and the
    pilot's K2, differenced), with the launch times, the twin's operations
    per element and link and the bound of the K2 launch; `plain` also
    times the twin at K2 (once)."""
    fn = oc.chain_kernel(name, dtype)
    ilp, n = x.shape
    k1 = oc.k1_of(name)
    # the pilot takes medians too: a launch the host is late to enqueue (the
    # sampler's nvidia-smi starting) reads its wait as kernel time
    k = k1
    t = launch_ms(fn, x, k, 3)  # also the warm-up
    while t < TARGET_MS / 6 and k < 1 << 28:
        k *= 2
        t = launch_ms(fn, x, k, 3)
    pilot_k, pilot_ms = k, t
    k2 = max(k1 + 1, math.ceil(TARGET_MS * k / t))
    t1, t2 = launch_ms(fn, x, k1, reps), launch_ms(fn, x, k2, reps)
    if x.device.type == "cuda" and not (MIN_K2_MS <= t2 <= 2 * TARGET_MS
                                        and t2 - t1 >= MIN_DIFF_MS):
        # the pilot misjudged the link: size K2 again from the K2 launch
        k2 = max(k1 + 1, math.ceil(k1 + (k2 - k1) * TARGET_MS / max(t2 - t1, 1e-3)))
        t1, t2 = launch_ms(fn, x, k1, reps), launch_ms(fn, x, k2, reps)
    sec = max((t2 - t1) * 1e-3 / (k2 - k1), 1e-15) / (n * ilp)
    # the link's operations per element, counted on the f32 twin in both
    # types (the f64 twin's exp adds the JAX package's range extension, which
    # the kernels leave out); the constants' operations are the kernel's once
    small = inputs(1, 8, torch.float32, "cpu")
    ops = opcount.count_ops(lambda v: oc.chain_plain(name, v, 1), small,
                            data_only=True) / small.numel()
    f64 = dtype == torch.float64
    n_bytes = 2 * n * ilp * x.element_size()
    bound, by = opcount.bound_ms(n_bytes, ops * n * ilp * k2, f64=f64)
    rec = {"chain": name, "dtype": "f64" if f64 else "f32", "E": n * ilp, "columns": n,
           "ilp": ilp, "k1": k1, "k2": k2, "k1_ms": t1, "k2_ms": t2,
           "pilot_k": pilot_k, "pilot_ms": pilot_ms,
           "sec_per_elem_link": sec, "ops_per_elem_link": ops,
           "bound_ms": bound, "bound_by": by, "reps": reps}
    if plain:
        rec["plain_k2_ms"] = launch_ms(fn.plain, x, k2, 1)
    return rec


def sweep(dtypes, device, reps: int = 5, plain: bool = False, on_record=None):
    """Compare every chain with its twin, then time it, in each of `dtypes`:
    (records, {dtype tag: fit}, nvidia-smi samples). The kernels' launch
    counts are zeroed after the comparisons, so that they count the timed
    sweep's launches only."""
    device = torch.device(device)
    xs, checks = {}, {}
    for dt in dtypes:
        for name in oc.CHAINS:
            n = columns(oc.chain_kernel(name, dt), device)
            xs[name, dt] = inputs(oc.ILP, n, dt, device)
            checks[name, dt] = compare(name, dt, xs[name, dt])
    for fn in (oc.chain_kernel(name, dt) for dt in dtypes for name in oc.CHAINS):
        fn.launches = 0
    samples, stop = [], threading.Event()
    sampler = None
    if device.type == "cuda":
        def sample():
            while not stop.wait(0.2):
                samples.append(smi("clocks.sm,power.draw"))

        samples.append(smi("clocks.sm,power.draw"))

        sampler = threading.Thread(target=sample)
        sampler.start()
    records = []
    try:
        for dt in dtypes:
            for name in oc.CHAINS:
                rec = measure(name, dt, xs[name, dt], reps, plain)
                rec.update(checks[name, dt], device=device.type)
                records.append(rec)
                if on_record:
                    on_record(rec)
    finally:
        if sampler is not None:
            stop.set()
            sampler.join()
    for rec in records:
        rec["launches"] = oc.chain_kernel(rec["chain"], DTYPES[rec["dtype"]]).launches
    fits = refit(records)
    if device.type == "cuda":
        check_floor(records, device)
    return records, fits, samples


def refit(records) -> dict:
    """The fit of each type present in `records`."""
    out = {}
    for tag in DTYPES:
        links = {r["chain"]: r["sec_per_elem_link"] for r in records if r["dtype"] == tag}
        if links:
            out[tag] = fit(links)
    return out


def check_floor(records, device) -> None:
    """Raise if the mul or add chain reads faster than the card can execute
    its one instruction per link."""
    for rec in records:
        if rec["chain"] in ("mul", "add"):
            floor = floor_sec(DTYPES[rec["dtype"]], device)
            rec["floor_sec"] = floor
            if rec["sec_per_elem_link"] < floor:
                raise RuntimeError(
                    f"chain {rec['chain']} {rec['dtype']}: {rec['sec_per_elem_link']:.3e} s "
                    f"per element per link is below the card's floor {floor:.3e}: a "
                    "timing fault")


def class_lines(tag: str, f: dict):
    yield (f"{tag} fit: memory column {f['mem_sec_per_elem_link']:.4e} s per element "
           f"per link, residual (rel) max {f['ls_residual_rel_max']:.4f}")
    for c, cc in f["classes"].items():
        yield (f"{tag} {c}: {cc['sec_per_elem_op']:.4e} s/elem-op, "
               f"{cc['slots_vs_mul']:.3f} x mul")
    yield f"{tag} residual (rel) per chain: " + ", ".join(
        f"{n} {r:.4f}" for n, r in f["ls_residual_rel"].items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="both", choices=("f32", "f64", "both"))
    ap.add_argument("--ilp", type=int, default=oc.ILP, choices=(oc.ILP,),
                    help="independent streams per thread (the kernels are built for 8)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="directory for op_microbench.json")
    ap.add_argument("--refit", help="re-solve the fit from this file's records")
    args = ap.parse_args(argv)
    if args.refit:
        with open(args.refit) as f:
            doc = json.load(f)
        doc["fits"] = refit(doc["records"])
        samples = doc.get("smi_samples", [])
    else:
        if args.device == "cpu":
            torch.set_num_threads(1)
        dtypes = [DTYPES[t] for t in (("f32", "f64") if args.dtype == "both" else (args.dtype,))]
        card = smi("name,power.limit") if args.device == "cuda" else "cpu (host times)"
        records, fits, samples = sweep(
            dtypes, args.device, args.reps, on_record=lambda r: print(json.dumps(r), flush=True))
        doc = {"card": card, "records": records, "fits": fits, "smi_samples": samples}
    for tag, f in doc["fits"].items():
        for ln in class_lines(tag, f):
            print(ln)
    if samples:
        print(f"nvidia-smi during the sweep (sm clock, power draw): {samples}")
    print(doc["card"])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "op_microbench.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {path}")
    print(json.dumps(doc["fits"]))


if __name__ == "__main__":
    main()
