"""Benchmark: coalescence-RHS moment-updates/s on one CUDA device.

Port of the repository's bench.py configuration (bench.py:43-46, 62-85):
two gamma modes, Golovin kernel 5.0 fitted at order 1, fixed threshold
5e-10 kg, norms (1e6, 1e-9), exact F2 with the GL-12 incomplete gamma
(``gammainc_iters=12``), 2^20 independent boxes in the SoA layout
``[6, B]``, and the Euler relaxation chain ``m ← m + 1e-9·rhs(m)`` whose
data dependency keeps every evaluation (bench.py:103-104). The RHS is the
CUDA coalescence kernel (`ops.fused_coalescence.make_coal_fn`).

``--impl numerical`` is bench.py's ``BENCH_IMPL=pallas_numerical``
(bench.py:106-117): the same seeded state cut to its first 262,144 boxes,
and the RHS by direct quadrature of the Smoluchowski equation with the Long
kernel 5.236e-10 / 9.44e9 / 5.78 (normalized), default node budgets (96, 48),
through the CUDA quadrature kernel
(`ops.numerical_coalescence.make_numerical_fn`).

bench.py's switches (bench.py:37-46, 66-100) are options here:
``--f2-exact {0,1}`` (BENCH_F2_EXACT), ``--gl-nodes N`` (BENCH_GL_NODES; 0
is the series/continued-fraction incomplete gamma), ``--gauss-nodes N``
(BENCH_GAUSS_NODES, the Gauss grid of the quadrature fallback) and
``--gammainc-iters N`` (BENCH_GAMMAINC_ITERS); the kernel is built with
``quad_rule="gauss"`` as bench.py builds it. The defaults are bench.py's:
the fast tier. Any other setting launches the kernel's reference-tier
instance (the JSON line names the instance).

Timed with CUDA events after a warm-up; the build is outside the timed
window. Needs a CUDA device; prints one JSON line per run:

    python -m cloudy_tpu_torch.bench
    python -m cloudy_tpu_torch.bench --f2-exact 0 --gl-nodes 0
    python -m cloudy_tpu_torch.bench --impl numerical
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.ops import numerical_coalescence as nc

BENCH_F2_EXACT = True
BENCH_GAUSS_NODES = 12
BENCH_GAMMAINC_ITERS = 12
BENCH_GL_NODES = 12
BENCH_COLUMNS = 1 << 20
BENCH_RELAX = 1e-9
NUMERICAL_COLUMNS = 1 << 18
NORMS = (1e6, 1e-9)


def bench_data(f2_exact: bool = BENCH_F2_EXACT, gl_nodes: int = BENCH_GL_NODES):
    """(spec, CoalescenceData) of bench.py's configuration at its switches
    BENCH_F2_EXACT and BENCH_GL_NODES."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=NORMS,
        gammainc_iters=BENCH_GAMMAINC_ITERS, f2_exact=bool(f2_exact),
        gammainc_gl_nodes=int(gl_nodes),
    )
    return spec, data


def coal_fn(device="cuda", f2_exact: bool = BENCH_F2_EXACT,
            gl_nodes: int = BENCH_GL_NODES, gauss_nodes: int = BENCH_GAUSS_NODES,
            gammainc_iters: int = BENCH_GAMMAINC_ITERS,
            dtype: torch.dtype = torch.float32) -> fc.CoalFn:
    """The bench RHS at bench.py's switches: its data and the per-call
    overrides it passes to `make_pallas_coal_fn` (quad_rule "gauss")."""
    _, data = bench_data(f2_exact, gl_nodes)
    return fc.make_coal_fn(data, device=device, dtype=dtype, quad_rule="gauss",
                           gauss_nodes=gauss_nodes, gammainc_iters=gammainc_iters)


def bench_moments(n_columns: int, seed: int = 0) -> np.ndarray:
    """Normalized moments ``[n_columns, 6]`` (float64) with bench.py's
    physically consistent per-column variation: joint amplitude and mass
    scalings per mode (independent per-moment noise drives the gamma k-clip
    into f32 overflow)."""
    rng = np.random.default_rng(seed)
    mom_norms = np.concatenate([1e6 * 1e-9 ** np.arange(3)] * 2)
    base = np.array([1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16]) / mom_norms
    amp = np.repeat(rng.uniform(0.5, 2.0, (n_columns, 2)), 3, axis=1)
    msc = np.repeat(rng.uniform(0.8, 1.25, (n_columns, 2)), 3, axis=1) ** np.tile(
        np.arange(3.0), 2
    )
    return base[None, :] * amp * msc


def numerical_fn(device="cuda") -> nc.NumericalFn:
    """The quadrature RHS of the numerical bench: two gamma modes, the Long
    kernel normalized by `NORMS`, default node budgets, f32."""
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(NORMS)
    return nc.make_numerical_fn(SpectrumSpec((Family.GAMMA, Family.GAMMA)), kf,
                                device=device, dtype=torch.float32)


def numerical_moments(n_columns: int = NUMERICAL_COLUMNS) -> np.ndarray:
    """The numerical bench's state ``[n_columns, 6]``: the first `n_columns`
    boxes of the 2^20-box seeded state (bench.py:112)."""
    return bench_moments(BENCH_COLUMNS)[:n_columns]


def relax_chain(rhs_soa, mom: torch.Tensor, n: int) -> torch.Tensor:
    """`n` dependent Euler relaxation steps ``m + 1e-9·rhs(m)``."""
    for _ in range(n):
        mom = mom + BENCH_RELAX * rhs_soa(mom)
    return mom


def time_chain(rhs_soa, mom: torch.Tensor, n: int, warmup: int = 3) -> float:
    """Seconds per chain step on a CUDA device (CUDA events, after
    `warmup` untimed steps)."""
    relax_chain(rhs_soa, mom, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    relax_chain(rhs_soa, mom, n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", choices=("coal", "numerical"), default="coal")
    ap.add_argument("--f2-exact", type=int, choices=(0, 1), default=int(BENCH_F2_EXACT))
    ap.add_argument("--gl-nodes", type=int, default=BENCH_GL_NODES)
    ap.add_argument("--gauss-nodes", type=int, default=BENCH_GAUSS_NODES)
    ap.add_argument("--gammainc-iters", type=int, default=BENCH_GAMMAINC_ITERS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA device: torch.cuda.is_available() is False")
    if args.impl == "numerical":
        n_columns, n_steps = NUMERICAL_COLUMNS, 20
        fn = numerical_fn()
        mom_np = numerical_moments(n_columns)
    else:
        n_columns, n_steps = BENCH_COLUMNS, 100
        fn = coal_fn("cuda", bool(args.f2_exact), args.gl_nodes, args.gauss_nodes,
                     args.gammainc_iters)
        mom_np = bench_moments(n_columns)
    mom = torch.as_tensor(mom_np.T.copy(), dtype=torch.float32, device="cuda")
    fn.launches = 0
    s = time_chain(fn.soa, mom, n_steps)
    switches = {} if args.impl == "numerical" else {
        "f2_exact": bool(args.f2_exact), "gl_nodes": args.gl_nodes,
        "gauss_nodes": args.gauss_nodes, "gammainc_iters": args.gammainc_iters,
        "instance": "reference tier" if fn.plan.ref else "fast tier",
    }
    print(json.dumps({
        "metric": "coalescence_moment_updates_per_s",
        "impl": args.impl,
        "value": n_columns * fn.plan.n_tot / s,
        "unit": "moment-updates/s",
        "device": torch.cuda.get_device_name(0),
        "n_columns": n_columns,
        "s_per_step": s,
        "launches": fn.launches,
        **switches,
    }))


if __name__ == "__main__":
    main()
