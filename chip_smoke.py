#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`cloudy_tpu_torch`) on one GPU.

Drives the port's main path once on the card and fails loudly:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles the table-driven CUDA kernels from cloudy_tpu_torch/csrc
   and, started with them, every kernel generated per configuration
   (`ops.codegen`: the whole step and fused RHS of each configuration, tier
   and type the phases launch, one nvcc each), printing each generated
   unit's nvcc seconds and `ptxas` line
   (f32: 0 B of stack and spills, checked);
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
   the main path's shapes (f32), and the twins' times there;
8. the coalescence kernel's MovingThreshold and lognormal arms against the
   twin (bench-style inputs, 65,536 boxes, f32 and f64), then each arm's
   Euler chain at 2^20 boxes and a comparison at that shape;
9. the whole-step kernel's arms against the twin (the `moving` and
   `lognorm` pod data, 4,096 columns x 32 levels, one step, f32 and f64);
10. the fused per-level RHS kernel against its twin (4,096 columns, f32 and
   f64, all three variants; then the pod state [6, 2^25], f32), and the
   fused-RHS route (that kernel + torch stencil + `stepper.ssprk33_step`)
   for 20 steps at 2^20 x 32 `fixed2gamma`, held against 20 whole steps;
11. the `moving` and `lognorm` pod scenarios at 2^20 columns x 32 levels x
   40 f32 steps through the whole-step kernel, the first 4,096 columns
   held against the twin run on the card;
12. the f64 anchor of each variant: the f64 whole-step kernel against the
   f64 twin on the card, 128 columns, 40 steps;
13. the direct-quadrature kernel against its twin: 128 boxes (one empty, one
   with an empty second mode), (64, 32) nodes, f32 and f64, two gamma modes
   with each of the four kernel functions and exponential + gamma +
   lognormal with the Long kernel; the f32 kernel against the f64 kernel
   and the f64 twin;
14. the numerical bench: the Euler chain of 262,144 boxes, two gamma modes,
   the Long kernel, f32, default budgets (96, 48), through the quadrature
   kernel; the kernel against its twin (run in chunks of boxes) at the full
   [6, 262144], and both times there;
15. the three box scenarios through the harness on the card in f64 against
   tests/golden/box_*.npz, and one quadrature-kernel launch at the box
   model's (256, 96) budgets on the numerical box's initial state against
   the einsum path `get_coal_ints_numerical` on the card;
16. calibration: the whole-step kernel with its per-lane kernel scale (B1s)
   against its twin (4,096 columns x 32 levels, a different scale per
   column, f32 and f64, all three variants: both kernel instances), and at
   s = 1.7 against the unscaled kernel built from the 1.7-scaled kernel
   tensor (f64); then the main path, `tools.calibration_bench.pod_main`: EKI
   at 64 and 256 members x 32 columns x 32 levels x 60 f32 steps through
   B1s (generated for the configuration), its 8-iteration run at 256
   members checked for 540 launches, finite observables and s within 2 %
   of 1.7 at both sizes, and each size's busy share of an EKI window; B1s
   against its twin at that run's shape [6, 262144]; the generated B1s
   against its table-driven instance there (ptxas, SASS counts, blocks per
   SM, ms per step in turns), with the unscaled generated B1 `fixed2gamma`
   at 2^20 x 32 read in a turn before and after them;
17. the reference tier (quadrature-grid F2, series/CF incomplete gamma,
   Newton percentile inverse, Lanczos-pair flux): the `ptxas` lines of its
   instances beside phase 6's unscaled B1 time; the coalescence kernel's
   reference instance against its twin at 65,536 boxes, f32 and f64, for
   the fixed Simpson and Gauss grids, the moving Simpson grid (lanes with
   T < 1 and T > 1, the twin's bin counts printed) and Gauss grid, exact F2
   on series/CF and an exponential mode; the whole-step and fused-RHS
   kernels' reference tier (generated for each configuration) against
   their twins at 4,096 columns x 32 levels, one step, f32 and f64, and
   (the fixed Simpson arm, the kernels line's rows) against the twin and
   timed at that shape on `rainshaft_small`'s own states
   (`reference_tune.small_trajectory`: column c after 20 (c mod 7) of its
   120 steps), its bound counted on those states;
18. the goldens at their own tier: `rainshaft_128` through the coalescence
   kernel's `coal_fn` hook for 150 s (the golden's frames t = 0-150 s of
   its 300), f64 at the reference tier (< 1e-6) and f32 at
   tests/test_golden.py's bench overrides (< 1e-3);
   `rainshaft_small` through the reference whole-step kernel and through
   the fused-RHS route, 128 columns x 120 steps, f64 (< 1e-6; the whole
   step also against its twin over those steps, 4 columns, < 1e-9) and f32
   (< 1e-3); `box_exp_gamma_mixture` through the coalescence kernel, f64 at
   the reference tier (< 1e-6) and f32 at bench.py's quadrature fallback
   (< 1e-3);
19. the bench chain at 2^20 boxes, f32, at bench.py's four switch settings
   (f2_exact, gl_nodes) = (1, 12), (0, 12), (1, 0), (0, 0): moment-updates/s
   and launches, the kernel against its twin and both times there;
20. the monodisperse and lognormal Φ-grid arms (reference-tier instance):
   every instance's `ptxas` line beside phase 6's unscaled B1 time; the
   coalescence kernel against its twin at 65,536 boxes, f32 and f64, for
   mono + gamma (fixed, lanes on both sides of θ = T/2; moving), gamma +
   mono, lognormal + gamma on the fixed Simpson grid (series erf) and Gauss
   grid (12, rational erf), on the moving Simpson and Gauss grids, and
   exponential + lognormal + gamma; each arm's Euler chain at 2^20 boxes and
   a comparison there; the whole-step and fused-RHS kernels (generated for
   each configuration; the monodisperse units without FMA contraction)
   against their twins at 4,096 columns x 32 levels, one step, f32 and f64,
   for the family matrix's `mono-gamma-closed` and `lognorm-gamma-grid`,
   and the f64 anchor of each (128 columns x 40 steps); then the family
   matrix
   (`tools.whole_step_ablation`, all nine cases at 2^20 columns x 32 levels,
   f32), each case's first 4,096 columns after its timed chain held against
   the twin run on the card, beside the twin's own spread from a start one
   ulp away;
21. the per-op-class chain benchmark (B6, `tools.op_microbench`): every
   chain kernel in f32 and f64 against its twin at K1 links over the full
   element set, the timed sweep (E elements, ILP 8, K1 and a K2 sized to a
   ~3 ms launch), the least-squares fit of the class costs in both types,
   the floor check of the mul and add chains, and the class model's time
   of B1 `fixed2gamma` and B5 beside their times of phases 6 and 14;
22. B-cover: an exponential-only and a three-mode (exponential +
   lognormal + gamma) fast-tier configuration through B3, B4 and B1 against
   their twins (4,096 columns x 32 levels, f32 and f64) and their times at
   2^20 x 32 (f32); B5 with three modes at [8, 262144] (f32) and B5 in f64
   at [6, 262144], each against its twin.
23. the generated B1 and B4 of each pod variant against their table-driven
   fast instances (reached only through the wrappers' private `_table`):
   `ptxas`, SASS counts of LDL, STL, LDS, STS, BAR and SHFL, blocks per
   SM, both against the twin at 4,096 x 32 (f32 and f64), and ms per step
   of B1 at 2^20 x 32 and per launch of B4 at [6, 2^25] in turns (f32);
24. B3 and B5 as redesigned, against what they replace, in turns: the
   generated coalescence RHS of each pod variant against its table-driven
   fast instance (`ptxas`, SASS counts, blocks per SM, vs twin at 2^20
   boxes f32 and 65,536 f64, ms per launch at 2^20), and of B-cover's two
   configurations at 2^25 lanes; the reference tier at the `rainshaft_128`
   hook's configuration with a warp per box against a thread per box at
   B = 128 to 262,144, f64 and f32 (the crossover `coal_layout` takes), and
   at 2^20 boxes for bench.py's reference switches and the mono and Φ-grid
   arms; the quadrature kernel against its twin with each kernel function
   at [6, 262144], and against the body it replaced at [6, 262144] (the
   bench), [8, 262144] (E + G + L) and in f64, with their `ptxas` lines,
   SASS counts and phase 21's class model;
25. C.1 and C.2: the four-gamma-mode configuration of
   examples/box_gamma_mixture_4modes.py (n_tot 12, past the prebuilt
   kernels' 3 modes and 9 moments) through B1 generated for it at 2^20
   columns x 32 levels (ms/step, column-updates/s), B3 and B4 at [12,
   2^20], B5 at [12, 262144] (the unit built for four modes), the reference
   tier's B1 and B4 (generated for the plan) and B3 (units built at
   capacities (4, 12, 5)) at [12, 131072], and the scaled whole step at the
   reference tier in f64 at [6, 4096]; each against its twin, with its
   `kernels` entry;
26. A.13, the pod job's durability and output: `harness.run_scenario` with
   a checkpoint directory and an output directory (under build/, its free
   space checked first, removed afterwards) for the pod `fixed2gamma` at
   2^20 columns x 32 levels x 120 f32 steps in segments of 40, cut after
   the first segment and resumed: the resumed state bit for bit phase 6's,
   the report's `n_steps_run` 80 and its rate over those steps, 40 + 80
   launches; a re-run over the finished directory records 0 steps and a
   null rate; the mean-profile NetCDF has 12 frames and its last is the
   column mean of phase 6's state; the checkpoint's bytes, each save's
   seconds and the resumed ms/step beside phase 6's;
27. A.14, the long horizon (`tools.longhorizon`): at nz 32 (128 columns)
   and nz 128 (32 columns), each [6, 4096], the generated f32 B1 on the
   fast data against B1's f64 reference tier (generated) on the Simpson-tier data
   for 1000 steps from the same spread start, held to the JAX gates'
   bounds (scaled error < 1e-3 at t = 300, 600, 1000 at nz 32, < 2e-3 at
   t = 500, 1000 at nz 128, |drift32 - drift64| < 1e-4 there, every state
   finite); each kernel's ms/step; the f64 run at t = 100 against its twin
   run on the card over the first 4 columns (< 1e-9), the f32 kernel
   against its twin for one step at [6, 4096] (< 1e-4);
28. A.9: the adiabatic parcel (`models.parcel.run_parcel`) of each kind
   (monodisperse, gamma, exponential + gamma) in f64 on the card against
   the same call on the CPU (< 1e-10 relative), tests/test_parcel.py's
   sanity checks and the Rogers (1975) curves at its bounds; the adaptive
   parcel (`run_parcel_adaptive`, mixture) against the CPU's trials; the
   condensation box over 100 steps against the CPU; host seconds each
   (the path is torch ops on 5-10 numbers, no hand-written kernel);
29. A.10, in child processes of this script (`--phase29 CASE ...`), so that
   no process group outlives the phase: (a) the pod `fixed2gamma` at 2^20 x
   32 x 120 f32 through the harness's sharded route
   (`parallel.ensemble.ensemble_whole_step`) under a one-rank NCCL group
   (torchrun's environment: `MASTER_ADDR=localhost`, a free port), its
   state held to phase 6's by SHA-256 over each half's bytes, its ms/step
   in turns against the unsharded step, the all-reduced mass against the
   local sum; (b) the same under two gloo ranks on cuda:0, 2^19 columns
   each, each shard held to (a)'s half; (c) the z-split step
   (`parallel.halo`) over two gloo ranks on cuda:0, 4,096 columns x 32
   levels as 2 x 16, one f64 step, against the unsplit AoS step; (d)
   `tools.scaling_measure` (the fused-RHS route through B4 and
   `ensemble_rainshaft_step_soa`) at 2^20 x 32, one rank, its record
   printed, and B4 against its twin at that shape;
30. (a) B5 with a traced kernel function (`ops.kernel_expr`, the
   `KT_GEN` arm of its own unit, R from the trace's factored form): the
   Long kernel fitted as a tensor, a torch lambda, a collection efficiency
   (tanh, erf), the coverage unit (the arithmetic, trigonometric, error,
   rounding and modulus forms), the special unit (the special functions,
   closed forms, masks and cleanups) and the activations unit
   (`torch.nn.functional`'s activations; `tools.traced_kernels`) against
   the twin on the CPU at 128 boxes, (64, 32) nodes, f32 and f64 (B5's
   tolerances),
   each unit's registers, stack and spills, whether R took block sums and
   how many, the remainder's operations per pair and the y values it
   tables (the tensor: block sums alone, checked), then the numerical bench
   chain through each at [6, 262144] f32 (the special unit at 4,096
   boxes, `tools.traced_kernels.CAPPED`; launches counted), each against the twin there, its ms, the twin's, the
   unit's ptxas line and nvcc seconds, and B5's Long in turns with all six
   (and at the special unit's width); (b) the native oracle (`native.coal_ints_golden`,
   g++ on the host) on the card's f64 state against `get_coal_ints` on the
   card (rtol 1e-8) and against B3's f64 reference tier at the Simpson
   switches, 65,536 bench boxes; (c) five examples in FAST mode on the card,
   each a child process with `--outdir` in a temporary directory, all five
   at once, their host seconds, and the calibration example once more in
   this process under `torch.profiler` (its device busy share); (d)
   `tools.whole_step_1m` (B1 at 2^20 x 32) beside phase 6's ms/step;
31. ROADMAP B.5, the reference tier of B1, B1s and B4 generated per
   configuration (`tools.reference_tune`): each reading (B1 at
   `rainshaft_small`'s configuration [6, 131072] f32 and f64 on that run's
   own states, as phase 17 times its rows, and at the long horizon's [6,
   4096] f64 on its start, nz 32 and 128; B4 [6, 131072] f32 and f64 on
   `rainshaft_small`'s states; B1s
   [6, 4096] f64; the four-gamma-mode B1 and B4 [12, 131072] f32; the family
   matrix's Φ-grid and `mono-gamma-closed` cases at 2^20 x 32 f32) against
   the table-driven instance of the same plan (`_table`) in turns, each
   unit's `ptxas` line and SASS counts (LDL and STL checked 0 for the
   generated ones), both against the twin; the series early exit against
   the fixed loop on 2^20 lanes of both branches per type (bit for bit,
   csrc/series_check.cuh, a unit of its own).

From phase 3 on, the whole step (scaled or not) and the fused RHS of every
configuration, and the coalescence RHS of every fast-tier configuration,
launch the kernel generated for it (the wrappers' `route` "generated",
printed with each main path's launch counts); the reference tier's
coalescence RHS launches the table-driven kernels, with a warp per box at
small batches (phase 18's `rainshaft_128` hook: 128 boxes), past the
prebuilt capacities from units built at first use.

Each main path's launch counts are zeroed just before it runs and read just
after: phases 6-7 (the fixed2gamma whole step and coalescence kernels), each
arm's chain in phase 8, the fused-RHS route in phase 10, each variant's run
in phase 11, the numerical chain in phase 14, and in phase 16 `pod_main`'s
8-iteration EKI run at 256 members (`pod_main` zeroes the scaled step's
count just before that run and reports it just after), each golden run in
phase 18, each switch setting's chain in phase 19, and in phase 20 each arm's
chain and each family-matrix case (`whole_step_ablation.run_case` zeroes the
step's count after its warm-up and reports it with the record), in phase 21
the timed sweep (`op_microbench.sweep` zeroes every chain kernel's count
after the comparisons), in phase 22 each configuration's timed
launches, in phase 25 each kernel's timed run, in phase 26 the cut and the
resumed run (each report counts its scenario's launches from its start), and
in phase 27 each long run (`longhorizon.run_depth` zeroes each wrapper's
count before its run), and in phase 29 each child's pod run
(`harness.run_scenario` zeroes the step's count) and the scaling tool's
timed chains (it zeroes B4's count after its warm-up), in phase 30 each
traced kernel function's chain and `whole_step_1m`'s timed chains (it zeroes
the step's count after its warm-up). The last two lines are a JSON
object of per-kernel numbers (errors from the main-path-shape comparison, the
steps' in normalized moment units; ``source`` the kernel's file, for a
generated kernel its shells with ``generator`` and ``unit`` beside;
``kernel_path`` "generated" or "table"; ``bound_ms`` the larger of the bytes moved
over 3.35 TB/s and the twin's operation count over the card's peak rate for
the type, `cloudy_tpu_torch.tools.opcount`, a traced kernel function counted
as the device function emitted from its trace computes it, a generated
reference-tier kernel with each lane's series stopped where the kernel
stops it; ``library_ms`` null: no single
PyTorch call computes any of these functions) and
``{"ok": true, "device": {...}}``. Exits nonzero, printing no
result, when no CUDA device is present or the port's package is missing.

    python3 chip_smoke.py
"""

import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_POD_COLUMNS = 1 << 20
N_CMP_COLUMNS = 4096
NZ = 32
N_RHS_STEPS = 100
N_ARM_STEPS = 20  # Euler chain steps of each coalescence arm (phase 8)
N_FUSED_STEPS = 20  # fused-RHS route vs whole step (phase 10)
N_VARIANT_STEPS = 40  # pod steps of the moving and lognorm runs (phases 11-12)
N_ANCHOR_COLUMNS = 128
N_NUM_STEPS = 20  # Euler chain steps of the numerical bench (phase 14)
#: phase 18's runs of `rainshaft_128` stop here (model seconds; the golden
#: holds 300 s in frames every 30 s, and the runs are held on those they reach)
GOLDEN_128_T_END = 150.0
N_NUM_BOXES = 128  # quadrature kernel vs twin (phase 13)
NUM_NODES = (64, 32)
NUM_CHUNK = 32768  # boxes per twin call at the full bench width
BOX_SCENARIOS = ("box_single_gamma_golovin", "box_exp_gamma_mixture",
                 "box_long_numerical")
VARIANTS = {"moving": "pod_ensemble_moving", "lognorm": "pod_ensemble_lognorm"}
TOL = {"float32": 1e-4, "float64": 1e-9}  # kernel vs twin, row-scaled
#: the quadrature kernel vs its twin, row-scaled: tools/traced_kernels.py's
#: NUM_TOL, set in main()
NUM_TOL = None
BOX_TOL = 1e-6  # box scenarios vs the stored f64 trajectories (rtol)
GOLDEN_TOL = 1e-3  # fast tier vs the stored f64 Simpson-tier trajectory
B1_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:876"
B3_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:662"
B4_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:771"
B5_REPLACES = "cloudy_tpu/ops/pallas_numerical.py:166"
B1S_REPLACES = "cloudy_tpu/ops/pallas_coalescence.py:1022"
CAL_MEMBERS = (64, 256)  # EKI ensemble sizes of phase 16
N_REF_BOXES = 65536  # reference-tier coalescence kernel vs twin (phase 17)
REF_GOLDEN_TOL = 1e-6  # reference-tier f64 kernels vs the goldens at their own tier
#: tests/test_golden.py's bench overrides (bench.py's configuration, quad_rule gauss)
BENCH_OVERRIDES = dict(quad_rule="gauss", gauss_nodes=12, gammainc_iters=12, f2_exact=True,
                       gammainc_gl_nodes=12)
BENCH_SWITCHES = ((1, 12), (0, 12), (1, 0), (0, 0))  # (f2_exact, gl_nodes), phase 19
N_BENCH_STEPS = 20  # Euler chain steps per switch setting (phase 19)
CAL_STEPS = 60  # forward steps per member (tools/calibration_bench.py:102)
FM_REPS = 3  # timed runs of each family-matrix chain (the tool's default is 5)
N_FM_ANCHOR_STEPS = 40  # the arms' f64 anchor (phase 20)
SOURCE = "cloudy_tpu_torch/csrc/fused_coalescence.cu"
GEN_SOURCE = "cloudy_tpu_torch/csrc/gen_kernels.cuh"
GEN_GENERATOR = "cloudy_tpu_torch/ops/codegen.py"
NUM_SOURCE = "cloudy_tpu_torch/csrc/numerical_coalescence.cu"
CHAIN_SOURCE = "cloudy_tpu_torch/csrc/op_chains.cu"
B6_REPLACES = "tools/op_microbench.py:141"
N_COVER_STEPS = 6  # timed launches of each B-cover kernel (phase 22)
N_GEN_STEPS = 10  # whole steps per timed turn, generated vs table-driven (phase 23)
N_GEN_RHS = 20  # fused-RHS launches per timed turn (phase 23)
COVERS = ("exp-only", "three-mode")  # the B-cover configurations (phases 2, 22)
#: the kinds of the kernels generated per configuration (phase 2's f32
#: check; units of the table-driven sources built at first use are "ref"
#: and "numerical")
GEN_KINDS = ("step", "rhs", "coal")
#: the four-gamma-mode configuration of examples/box_gamma_mixture_4modes.py
#: (phase 25): thresholds, and per mode the column's number and mean mass
FOUR_THR = (5e-10, 5e-9, 5e-8, math.inf)
FOUR_AMPS = tuple((1e8 * 10.0 ** -j, 1e-10 * 10.0 ** j) for j in range(4))
N_FOUR_STEPS = 6  # timed whole steps or launches of each phase-25 kernel
N_REF_COLUMNS = 4096  # the reference tier's columns in phase 25: [12, 131072]
N_FOUR_NUM_BOXES = 262144  # B5's boxes at four modes (phase 25): the bench's width
N_SCALED_TURN_STEPS = 20  # B1s steps per timed turn, generated vs table-driven (phase 16)
PARCEL_KINDS = ("monodisperse", "gamma", "mixture")  # phase 28
PARCEL_TOL = 1e-10  # f64 on the card vs the CPU, relative (phase 28)
Z_COLUMNS = 4096  # the z-split step's columns (phase 29(c))
Z_TOL = 1e-12  # the z-split step vs the unsplit one, per-moment-scaled (phase 29(c))
N_SCALE_STEPS = 10  # steps per timed chain of tools.scaling_measure (phase 29(d))
#: the examples run on the card in FAST mode, each in a child process (phase 30(c))
CARD_EXAMPLES = ("box_single_gamma", "n_particles_gamma", "rainshaft_single_gamma",
                 "parcel_example", "calibration_example")
NATIVE_BOXES = 65536  # native oracle vs get_coal_ints and B3's reference tier (phase 30(b))
NATIVE_RTOL = 1e-8  # tests/test_native.py's bound
#: boxes of the reference coalescence kernel's layouts, timed in turns (phase 24)
REF_LAYOUT_BOXES = (128, 1024, 8192, 32768, 65536, 131072, 262144)


#: the reference tier's arms (phase 17): build and call keywords of each
REF_CASES = {
    "fixed Simpson": ({}, {}),
    "fixed Gauss": ({}, {"quad_rule": "gauss"}),
    "moving Simpson": ({"moving": True}, {}),
    "moving Gauss": ({"moving": True}, {"quad_rule": "gauss"}),
    "exact F2, series/CF": ({"f2_exact": True}, {}),
    "exponential + gamma": ({"families": ("EXPONENTIAL", "GAMMA")}, {}),
}
#: the arms phase 17 runs through the whole step and the fused RHS
REF_STEP_CASES = ("fixed Simpson", "moving Simpson", "moving Gauss", "exact F2, series/CF")
#: the family matrix's reference-tier cases (phase 20)
MATRIX_REF_CASES = ("mono-gamma-closed", "lognorm-gamma-grid")


def kernel_source(fn, B=None):
    """The `kernels` keys naming a wrapper's kernel: the table-driven source
    (for the coalescence RHS with its layout at `B` boxes, a thread or a
    warp per box), the generated kernels' shells and their generator with
    the route, or the quadrature kernel's source and body; with the units
    built at first use where the prebuilt library does not hold the
    kernel."""
    from cloudy_tpu_torch.ops import numerical_coalescence as nc

    if getattr(fn, "route", "table") == "generated":
        return {"source": GEN_SOURCE, "generator": GEN_GENERATOR, "kernel_path": "generated",
                "unit": fn.unit.label}
    if isinstance(fn, nc.NumericalFn):
        out = {"source": NUM_SOURCE, "kernel_path": "quad"}
    else:
        out = {"source": SOURCE, "kernel_path": "table"}
        if B is not None and hasattr(fn, "layout"):
            out["layout"] = fn.layout(B)
    units = fn.build_units()
    if units:  # built at first use: past the prebuilt library's capacities
        out.update(generator=GEN_GENERATOR, units=[u.label for u in units])
    return out


def cover_case(name):
    """(spec, data, RainshaftConfig) of a B-cover configuration: the pod as
    exponential-only (E, E) or three-mode (E, L, G;
    tests/test_pallas.py:172-177), fast tier."""
    import numpy as np

    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    E, G, L = Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL
    fams, thr = {"exp-only": ((E, E), (5e-10, np.inf)),
                 "three-mode": ((E, L, G), (2e-10, 5e-10, np.inf))}[name]
    spec = SpectrumSpec(fams)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, thr, norms=(1e6, 1e-9), fast_tier=True)
    return spec, data, rs.RainshaftConfig(spec=spec, nz=NZ, zmax=3000.0, norms=(1e6, 1e-9))


def four_mode_case(fast=True):
    """(spec, data, RainshaftConfig) of the four-gamma-mode configuration
    (examples/box_gamma_mixture_4modes.py: thresholds 5e-10, 5e-9, 5e-8, ∞;
    n_tot 12, past the prebuilt kernels' 3 modes and 9 moments) in the pod's
    column (32 levels over 3000 m, Golovin 5.0 at order 1, norms (1e6,
    1e-9)); `fast`: the fast tier, else the reference tier (phase 25)."""
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA,) * 4)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, FOUR_THR, norms=(1e6, 1e-9), fast_tier=fast)
    return spec, data, rs.RainshaftConfig(spec=spec, nz=NZ, zmax=3000.0, norms=(1e6, 1e-9))


def four_mode_wrappers(dev, dtype, fast=True):
    """{kind: wrapper} of the four-gamma-mode configuration: the whole
    step, the fused RHS and the coalescence RHS (phase 25)."""
    from cloudy_tpu_torch.ops import fused_coalescence as fc

    _, data, cfg = four_mode_case(fast)
    kw = dict(device=dev, dtype=dtype)
    return {"step": fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz,
                                              dt=1.0, **kw),
            "rhs": fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, **kw),
            "coal": fc.make_coal_fn(data, **kw)}


def four_mode_numerical(dev, dtype):
    """B5 at four gamma modes: the Long kernel normalized by the bench's
    norms, its budgets (96, 48) (phase 25)."""
    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(bench.NORMS)
    return nc.make_numerical_fn(SpectrumSpec((Family.GAMMA,) * 4), kf, device=dev, dtype=dtype)


def scaled_reference_step(dev, dtype):
    """B1s at the reference tier (C.2): pod `fixed2gamma`'s two gamma modes
    at the default tier (Simpson grid, series/CF), the library's scaled
    reference instance (phase 25)."""
    import numpy as np

    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
    cfg = rs.RainshaftConfig(spec=spec, nz=NZ, zmax=3000.0, norms=(1e6, 1e-9))
    return fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz, dt=1.0,
                                     device=dev, dtype=dtype, kernel_scale=True)


def scaled_tensor_data(spec, s=1.7):
    """Pod `fixed2gamma` data from the s-scaled Golovin tensor (phase 16)."""
    import numpy as np

    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data

    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    return build_coalescence_data(spec, K.CoalescenceTensor(s * ker.array), (5e-10, np.inf),
                                  norms=(1e6, 1e-9), fast_tier=True)


def generated_wrappers(dev):
    """A wrapper of every kernel the phases launch from a unit built at
    first use (`build_units`), built from the same plans, hence the same
    units: the pod variants' whole step, fused RHS and coalescence RHS in
    f32 and f64 (phases 4-12, 23, 24) and their scaled whole step (B1s,
    phase 16), the bench's coalescence RHS (phases 3, 7, 19) and
    `rainshaft_128`'s at the bench overrides (phase 18), the unscaled step
    from the 1.7-scaled tensor in f64 (phase 16), the family matrix's fast
    cases in f32 (phase 20), the B-cover configurations (phase 22), the
    four-gamma-mode configuration's kernels at both tiers and B5 (f32,
    phase 25) and its scaled reference step (f64, phase 25), the long
    horizon's whole steps at nz 32 and 128 (phase 27), `tools.scaling_measure`'s
    fused RHS (phase 29, the pod's), and the reference tier's whole steps
    and fused RHS of phases 17, 18 and 20 (f32 and f64). Phase 31's units
    are `tools.reference_tune.build_units`."""
    import torch

    from cloudy_tpu_torch import bench, harness
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.tools import longhorizon, scaling_measure, yardstick
    from cloudy_tpu_torch.tools import whole_step_ablation as wsa
    from cloudy_tpu_torch.tools.reference_tune import ref_data

    fns = []
    for dt in (torch.float32, torch.float64):
        for variant in yardstick.VARIANTS:
            for kind in ("step", "rhs", "coal"):
                fns.append(yardstick.make_fns(variant, kind, dev, dt)[0])
        for name in COVERS:
            _, data, cfg = cover_case(name)
            fns.append(fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz,
                                                 dt=1.0, device=dev, dtype=dt))
            fns.append(fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, device=dev, dtype=dt))
            fns.append(fc.make_coal_fn(data, device=dev, dtype=dt))
        fns.append(fc.make_coal_fn(bench.bench_data()[1], device=dev, dtype=dt))
        fns.append(harness.SCENARIOS["rainshaft_128"](device=dev, dtype=dt, hook=True,
                                                      **BENCH_OVERRIDES)["coal_fn"])
    fns.append(bench.coal_fn(dev))
    for dt in (torch.float32, torch.float64):
        for variant in yardstick.VARIANTS:
            _, data, cfg = yardstick.pod_config(variant)
            fns.append(fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz,
                                                 dt=1.0, device=dev, dtype=dt,
                                                 kernel_scale=True))
    for fast in (True, False):
        fns += four_mode_wrappers(dev, torch.float32, fast).values()
    fns.append(four_mode_numerical(dev, torch.float32))
    spec, _ = harness.pod_data("fixed2gamma")
    _, _, cfg = yardstick.pod_config("fixed2gamma")
    fns.append(fc.make_rainshaft_step_fn(scaled_tensor_data(spec), cfg.vel, cfg.norms, nz=NZ,
                                         dz=cfg.dz, dt=1.0, device=dev, dtype=torch.float64))
    fns += [wsa.build_case(case, NZ, dev, torch.float32)[1] for case in wsa.CASE_NAMES]
    fns += [f for nz in longhorizon.DEPTHS.values() for f in longhorizon.make_steps(nz, dev)]
    fns.append(scaling_measure.build_step(True, None, dev)[3])
    for dt in (torch.float32, torch.float64):
        fns += [f for f in traced_numerical(dev, dt).values()]
    fns.append(scaled_reference_step(dev, torch.float64))
    for dt in (torch.float32, torch.float64):
        cases = [(ref_data(**REF_CASES[c][0]), REF_CASES[c][1]) for c in REF_STEP_CASES]
        cases += [wsa.case_data(c) for c in MATRIX_REF_CASES]
        for data, kw in cases:
            fns.append(fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz,
                                                 dt=1.0, device=dev, dtype=dt, **kw))
            fns.append(fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, device=dev,
                                                dtype=dt, **kw))
    return [f for f in fns if f.build_units()]


def traced_kernels():
    """B5's traced kernel functions (phase 30): the Long kernel fitted as a
    kernel tensor (order 2, normalized), a torch lambda, and
    `tools.traced_kernels`' collection efficiency (tanh, erf, `torch.mul`
    and method forms), coverage unit (the arithmetic, trigonometric, error,
    rounding and modulus forms, one term each), special unit (the special
    functions, closed forms, masks and cleanups, one term each) and
    activations unit (`torch.nn.functional`'s activations, one term each):
    `tools.traced_kernels.traced`."""
    from cloudy_tpu_torch.tools import traced_kernels as tk

    return tk.traced()


def traced_numerical(dev, dtype, nodes=(96, 48)):
    """B5's wrappers of the traced kernel functions, two gamma modes."""
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    return {k: nc.make_numerical_fn(spec, kf, *nodes, device=dev, dtype=dtype)
            for k, kf in traced_kernels().items()}


def arm_moments(families, n, seed):
    """Normalized moments [n_tot, n] of the family arms (phases 20, 24),
    parameters drawn first: gamma (θ, k) ∈ [0.05, 5] × [0.5, 5], lognormal
    (μ, σ) ∈ [−2, 0.5] × [0.3, 1.2], monodisperse θ ∈ [0.05, 0.6] (about
    T/2 = 0.25), exponential θ ∈ [0.02, 0.5]; n ∈ [10, 200]."""
    import numpy as np
    import torch

    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    ranges = {Family.GAMMA: ((0.05, 5.0), (0.5, 5.0)),
              Family.LOGNORMAL: ((-2.0, 0.5), (0.3, 1.2)),
              Family.MONODISPERSE: ((0.05, 0.6), (0.0, 0.0)),
              Family.EXPONENTIAL: ((0.02, 0.5), (0.0, 0.0))}
    rng = np.random.default_rng(seed)
    par = np.stack([np.stack([rng.uniform(10, 200, n), rng.uniform(*ranges[f][0], n),
                              rng.uniform(*ranges[f][1], n)], -1) for f in families], axis=1)
    return pd.get_moments(SpectrumSpec(families), torch.as_tensor(par)).numpy().T.copy()


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def ptxas_summary(log, chains=False):
    """One line per kernel instance from the build's ``-Xptxas -v`` report:
    registers, stack frame and spills; with `chains`, also the chain kernels
    (B6)."""
    out, entry, props, stack = [], None, None, ("?", "?", "?")
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\w+)", ln):
            props = m.group(1)
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads", ln)) and props == entry:
            stack = m.groups()
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            name = entry
            if k := re.search(r"cloudy\d+(\w+?)I([fd])((?:Lb[01]E)+)", entry):
                # coal/rhs_kernel<T, kArms, kRef>, step_kernel<T, kArms, kScale, kRef>
                flags = [f == "1" for f in re.findall(r"Lb([01])E", k.group(3))]
                args = ["float" if k.group(2) == "f" else "double",
                        "true" if flags[0] else "false"]
                if len(flags) == 3:
                    args.append("scaled" if flags[1] else "unscaled")
                if flags[-1]:
                    args.append("reference")
                name = f"{k.group(1)}<{', '.join(args)}>"
            elif k := re.search(r"chain_kernelI([fd])NS0_\d+([A-Za-z]\w*?)I[fd]EELi(\d+)E",
                                entry):
                if not chains:
                    entry = None
                    continue
                name = (f"chain_kernel<{'float' if k.group(1) == 'f' else 'double'}, "
                        f"{k.group(2)}, ILP {k.group(3)}>")
            elif k := re.search(r"cloudy\d+(coal_warp_kernel)I([fd])E", entry):
                name = f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}, reference>"
            elif k := re.search(r"cloudy\d+(\w+?)I([fd])Li(\d)ELi(\d)E", entry):
                name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}, "
                        f"{k.group(3)} modes, kernel function {k.group(4)}>")
            out.append(f"{name}: {m.group(1)} registers, {stack[0]} B stack, "
                       f"{stack[1]} B spill stores, {stack[2]} B spill loads")
            entry = None
    return out


def row_scaled(got, want, cancelling=()):
    """max over rows of |got - want| / max|want| of the row, and max abs. A
    row in `cancelling` is zero in exact arithmetic (a lone mode's mass
    tendency: what is left of two sums of like size), so its own values are
    no scale: it takes the geometric mean of its neighbours', the size of
    those sums."""
    d = (got.double() - want.double()).abs()
    scale = want.double().abs().amax(dim=1).clamp_min(1e-300)
    for r in cancelling:
        scale[r] = (scale[r - 1] * scale[r + 1]).sqrt()
    return float((d.amax(dim=1) / scale).max()), float(d.max())


def main():
    global NUM_TOL
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

    from cloudy_tpu_torch import bench, harness, stepper
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch import coalescence_numerical as cn
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec, get_moments_normalizing_factors
    from cloudy_tpu_torch.tools import opcount, reference_tune, yardstick
    from cloudy_tpu_torch.tools import traced_kernels as tk
    from cloudy_tpu_torch.utils import metrics

    NUM_TOL = tk.NUM_TOL
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
    # the table-driven library (one nvcc per unit) and every generated
    # kernel the phases launch (one nvcc each), all started together
    t = time.perf_counter()
    lib_err = []

    def build_library():
        # then the library's SASS counts (phases 23, 24: one cuobjdump of the
        # whole library, about a minute), here so that no timed phase runs
        # beside the listing's parse
        try:
            _build.load_library()
            _build.sass_counts(_build.library_path())
        except BaseException as e:  # re-raised below
            lib_err.append(e)

    lib_thread = threading.Thread(target=build_library)
    lib_thread.start()
    gen_fns = generated_wrappers(dev)
    gen_records = _build.build_generated([u for f in gen_fns for u in f.build_units()]
                                         + reference_tune.build_units(dev, ablations=False))
    gen_s = time.perf_counter() - t
    lib_thread.join()
    if lib_err:
        raise lib_err[0]
    _build.load_library()
    build_s = time.perf_counter() - t
    n_gen_built = len(_build.GEN_BUILDS)
    log = _build.library_path().with_suffix(".log").read_text()
    print(f"phase 2 build: {_build.library_path().name} and {len(gen_records)} generated "
          f"units ({sum(r['built'] for r in gen_records)} built here) in {build_s:.3f} s, the "
          f"generated ones done after {gen_s:.3f} s {card}")
    for ln in ptxas_summary(log, chains=True):
        print(f"  ptxas: {ln}")
    for rec in gen_records:
        pt = _build.ptxas_report(rec.get("log", ""))
        retried = (", rebuilt with a minimum of 1 block per SM: ptxas spilled under its own "
                   "register target" if rec["retried"] else "")
        print(f"  generated {rec['label']}: nvcc {rec['seconds']:.3f} s{retried}; ptxas: "
              f"{pt.get('registers')} registers, {pt.get('stack')} B stack, "
              f"{pt.get('spill_stores')} B spill stores, {pt.get('spill_loads')} B spill loads")
        if "_f32_" in rec["label"] and rec["label"].split("_")[0] in GEN_KINDS:
            check(pt.get("stack") == 0 and pt.get("spill_stores") == 0
                  and pt.get("spill_loads") == 0,
                  f"generated f32 unit {rec['label']} has stack or spills: {pt}")
    del gen_fns
    print(f"phase 2 seconds {time.perf_counter() - t:.3f}")

    spec, bdata = bench.bench_data()
    results = {}

    def bound(label, twin, x_small, lanes, rows_in, rows_out, f64=False,
              count=opcount.count_ops, series_exit=None):
        """The least time the card could take for one launch on `lanes`
        lanes: bytes (each input and output row once) over the memory rate
        against the twin's operations (`count`: `opcount.count_ops`, or
        `count_ops_traced` of a B5 wrapper with a traced kernel function),
        counted on `x_small` and scaled to `lanes`, over the peak rate of the
        type (f32, or `f64`). `series_exit`: count the lower series as a
        kernel that stops it early sums it (default: as the wrapper whose
        bound twin `twin` is)."""
        kw = {} if series_exit is None else {"series_exit": series_exit}
        ops_per_lane = count(twin, x_small, **kw) / x_small.shape[1]
        if series_exit is None:
            series_exit = getattr(getattr(twin, "__self__", None), "series_exit", False)
        n_bytes = (rows_in + rows_out) * lanes * (8 if f64 else 4)
        ms, by = opcount.bound_ms(n_bytes, ops_per_lane * lanes, f64=f64)
        rate = opcount.H100_F64_OPS_PER_S if f64 else opcount.H100_F32_OPS_PER_S
        print(f"bound {label}: {ops_per_lane:.2f} operations per lane ({count.__name__}"
              f"{', series stopped per lane' if series_exit else ''}) x {lanes} "
              f"lanes at {rate:.3g} op/s, {n_bytes} bytes "
              f"at {opcount.H100_BYTES_PER_S:.3g} B/s: {ms:.4f} ms, bound by {by}")
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

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
    check(sc["step"].route == "generated", "the pod step does not take the generated kernel")
    # a few steps at full width first, outside the counts and the timing: the
    # caching allocator's blocks of this size and the card's clocks under load
    sc["run"](3)
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
    print(f"launch counts of the main path: {launches}; routes: step {sc['step'].route} "
          f"({sc['step'].unit.label}), coal {coal32.route}")
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
    step_bound = bound("rainshaft_step", sc["step"].plain,
                       sc["state0"][:, :8 * NZ].contiguous(), N_POD_COLUMNS * NZ, 6, 6)
    coal_bound = bound("coal_rhs", coal32.plain, rhs_mom[:, :256].contiguous(),
                       bench.BENCH_COLUMNS, 6, 6)
    step_src = kernel_source(sc["step"])
    # B1's time is the median of three timed runs of the main path, the
    # counted one and two more after the counts were read, so that a run
    # disturbed once does not move the readings later phases compare with
    pod_runs = [pod_s] + [sc["run"]()[1] for _ in range(2)]
    pod_s = float(np.median(pod_runs))
    b1_ms = pod_s / sc["n_steps"] * 1e3  # unscaled B1 fixed2gamma, phase 16 prints it again
    print(f"phase 7 main path's three timed runs of {sc['n_steps']} steps: "
          f"{', '.join(f'{s:.4f}' for s in pod_runs)} s; median {b1_ms:.4f} ms/step {card}")
    # phase 26 resumes this run from a checkpoint and holds it to these
    pod_final, pod_twin = y, yt
    del sc, y, yt
    print(f"phase 7 per call at main-path shapes: coal kernel {coal_ms:.4f} ms, "
          f"coal twin {coal_plain_ms:.4f} ms; step kernel "
          f"{pod_s / 120 * 1e3:.4f} ms, step twin {step_plain_ms:.4f} ms {card}")
    print(f"phase 7 seconds {time.perf_counter() - t:.3f}")

    kernels = [
        {"name": "rainshaft_step", "route": "cuda", **step_src,
         "replaces": B1_REPLACES, "launches": launches["step"],
         "max_abs_err": results[("step", "main")][1],
         "max_row_scaled_err": results[("step", "main")][0],
         "ms": pod_s / 120 * 1e3, "plain_ms": step_plain_ms, **step_bound},
        {"name": "coal_rhs", "route": "cuda", **kernel_source(coal32),
         "replaces": B3_REPLACES, "launches": launches["coal"],
         "max_abs_err": results[("coal", "main")][1],
         "max_row_scaled_err": results[("coal", "main")][0],
         "ms": coal_ms, "plain_ms": coal_plain_ms, **coal_bound},
    ]

    # ---- 8. coalescence-kernel arms vs twin, and each arm's chain ----------
    t = time.perf_counter()
    for variant in VARIANTS:
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            fn = fc.make_coal_fn(vdata, device=dev, dtype=dt)
            x = yardstick.coal_moments(variant, 65536, dev, dt, seed=1)
            got = fn.soa(x)
            want = fn.plain(x)
            torch.cuda.synchronize()
            err, abs_err = row_scaled(got, want)
            print(f"phase 8 coal kernel [{variant}] vs twin {name}: row-scaled {err:.3e} "
                  f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e}, finite "
                  f"{bool(torch.isfinite(got).all())} {card}")
            check(bool(torch.isfinite(got).all()), f"coal kernel [{variant}] {name} not finite")
            check(err < TOL[name], f"coal kernel [{variant}] {name} vs twin {err:.3e}")
        fn = fc.make_coal_fn(vdata, device=dev, dtype=torch.float32)
        x = yardstick.coal_moments(variant, bench.BENCH_COLUMNS, dev, torch.float32, seed=0)
        fn.launches = 0
        s_chain = bench.time_chain(fn.soa, x, N_ARM_STEPS)
        n_launch = fn.launches
        check(n_launch == N_ARM_STEPS + 3,
              f"coal kernel [{variant}] launched {n_launch} times, not {N_ARM_STEPS + 3}")
        err, abs_err = row_scaled(fn.soa(x), fn.plain(x))
        check(err < TOL["float32"], f"coal kernel [{variant}] vs twin at [6, 2^20] {err:.3e}")
        ms, plain_ms = _time_ms(lambda: fn.soa(x), 20), _time_ms(lambda: fn.plain(x), 2)
        print(f"phase 8 coal RHS chain [{variant}] {bench.BENCH_COLUMNS} boxes f32: "
              f"{s_chain * 1e3:.4f} ms/step, {bench.BENCH_COLUMNS * 6 / s_chain:.4e} "
              f"moment-updates/s, launches {n_launch}; at [6, {bench.BENCH_COLUMNS}] "
              f"row-scaled {err:.3e}, max abs {abs_err:.3e}; kernel {ms:.4f} ms, "
              f"twin {plain_ms:.4f} ms {card}")
        kernels.append({"name": f"coal_rhs[{variant}]", "route": "cuda", **kernel_source(fn),
                        "replaces": B3_REPLACES, "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        **bound(f"coal_rhs[{variant}]", fn.plain, x[:, :256].contiguous(),
                                bench.BENCH_COLUMNS, 6, 6)})
        del fn, x
    print(f"phase 8 seconds {time.perf_counter() - t:.3f}")

    # ---- 9. whole-step kernel arms vs twin --------------------------------
    t = time.perf_counter()
    for variant in VARIANTS:
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            step = fc.make_rainshaft_step_fn(
                vdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz, dt=1.0,
                device=dev, dtype=dt)
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            got = step(x)
            want = step.plain(x)
            torch.cuda.synchronize()
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            err, abs_err = row_scaled(got / norm, want / norm)
            print(f"phase 9 step kernel [{variant}] vs twin {name}: row-scaled {err:.3e} "
                  f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e} (normalized) {card}")
            check(bool(torch.isfinite(got).all()), f"step kernel [{variant}] {name} not finite")
            check(err < TOL[name], f"step kernel [{variant}] {name} vs twin {err:.3e}")
    print(f"phase 9 seconds {time.perf_counter() - t:.3f}")

    # ---- 10. fused per-level RHS kernel, and the fused-RHS route ----------
    t = time.perf_counter()
    for variant in ("fixed2gamma", *VARIANTS):
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            rfn = fc.make_rainshaft_rhs_fn(vdata, sc_cfg.vel, sc_cfg.norms, device=dev,
                                           dtype=dt)
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            got = rfn.soa(x)
            want = rfn.plain(x)
            torch.cuda.synchronize()
            norm = torch.tensor(rfn.plan.mom_norms * 2, dtype=dt, device=dev)[:, None]
            err, abs_err = row_scaled(got / norm, want / norm)
            print(f"phase 10 rhs kernel [{variant}] vs twin {name}: row-scaled {err:.3e} "
                  f"(tol {TOL[name]:.0e}), max abs {abs_err:.3e} (normalized) {card}")
            check(bool(torch.isfinite(got).all()), f"rhs kernel [{variant}] {name} not finite")
            check(err < TOL[name], f"rhs kernel [{variant}] {name} vs twin {err:.3e}")
    sc = harness.SCENARIOS["pod_ensemble"](
        n_columns=N_POD_COLUMNS, device=dev, dtype=torch.float32)
    cfg = sc["config"]
    rfn = fc.make_rainshaft_rhs_fn(sc["data"], cfg.vel, cfg.norms, device=dev)
    check(rfn.route == "generated", "the fused-RHS route does not take the generated kernel")
    rhs = rs.make_rainshaft_rhs_fused(cfg, rfn)
    rfn.soa(sc["state0"][:, :NZ].contiguous())  # warm-up outside the count
    torch.cuda.synchronize()
    rfn.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    y = sc["state0"]
    for _ in range(N_FUSED_STEPS):
        y = stepper.ssprk33_step(rhs, y, 0.0, cfg.dt)
    end.record()
    end.synchronize()
    fused_s = start.elapsed_time(end) / 1e3
    rhs_launches = rfn.launches
    check(rhs_launches == 3 * N_FUSED_STEPS,
          f"rhs kernel launched {rhs_launches} times, not {3 * N_FUSED_STEPS}")
    yb = sc["state0"]
    for _ in range(N_FUSED_STEPS):
        yb = sc["step"](yb)
    ferr, _ = row_scaled(y, yb)
    print(f"phase 10 fused-RHS route fixed2gamma {N_POD_COLUMNS} x {NZ} x {N_FUSED_STEPS} "
          f"f32: {fused_s / N_FUSED_STEPS * 1e3:.4f} ms/step, "
          f"{N_POD_COLUMNS * N_FUSED_STEPS / fused_s:.4e} column-updates/s, rhs launches "
          f"{rhs_launches} ({rfn.route}, {rfn.unit.label}); vs {N_FUSED_STEPS} whole steps: row-scaled {ferr:.3e} "
          f"(tol {TOL['float32']:.0e}) {card}")
    check(bool(torch.isfinite(y).all()), "fused-RHS route not finite")
    check(ferr < TOL["float32"], f"fused-RHS route vs whole step {ferr:.3e}")
    del y, yb
    norm = torch.tensor(rfn.plan.mom_norms * 2, dtype=torch.float32, device=dev)[:, None]
    rerr, rabs = row_scaled(rfn.soa(sc["state0"]) / norm, rfn.plain(sc["state0"]) / norm)
    print(f"phase 10 rhs kernel vs twin at the main-path shape [6, {N_POD_COLUMNS * NZ}] "
          f"f32: row-scaled {rerr:.3e} (tol {TOL['float32']:.0e}), max abs {rabs:.3e} "
          f"(normalized) {card}")
    check(rerr < TOL["float32"], f"rhs kernel vs twin at the main-path shape {rerr:.3e}")
    rhs_ms = _time_ms(lambda: rfn.soa(sc["state0"]), 5)
    rhs_plain_ms = _time_ms(lambda: rfn.plain(sc["state0"]), 2)
    print(f"phase 10 per call at [6, {N_POD_COLUMNS * NZ}]: rhs kernel {rhs_ms:.4f} ms, "
          f"rhs twin {rhs_plain_ms:.4f} ms {card}")
    kernels.append({"name": "rainshaft_rhs", "route": "cuda", **kernel_source(rfn),
                    "replaces": B4_REPLACES, "launches": rhs_launches,
                    "max_abs_err": rabs, "max_row_scaled_err": rerr,
                    "ms": rhs_ms, "plain_ms": rhs_plain_ms,
                    **bound("rainshaft_rhs", rfn.plain, sc["state0"][:, :8 * NZ].contiguous(),
                            N_POD_COLUMNS * NZ, 6, 12)})
    del sc, rfn, rhs
    torch.cuda.empty_cache()
    print(f"phase 10 seconds {time.perf_counter() - t:.3f}")

    # ---- 11. the moving and lognorm pod scenarios at full width -----------
    t = time.perf_counter()
    for variant, scenario in VARIANTS.items():
        sc = harness.SCENARIOS[scenario](
            n_columns=N_POD_COLUMNS, device=dev, dtype=torch.float32)
        sc["n_steps"] = N_VARIANT_STEPS  # of the scenario's 120: the time budget
        check(sc["step"].route == "generated", f"[{variant}] pod step not generated")
        sc["step"].launches = 0
        y, pod_s, clock = sc["run"](N_VARIANT_STEPS)
        n_launch = sc["step"].launches
        check(n_launch == sc["n_steps"],
              f"[{variant}] whole-step kernel launched {n_launch} times, not {sc['n_steps']}")
        rep = metrics.conservation_report(sc["spec"], rs.from_soa(y, NZ))
        finite = bool(torch.isfinite(y).all())
        print(f"phase 11 {scenario} {N_POD_COLUMNS} x {NZ} x {sc['n_steps']} f32: "
              f"{pod_s:.4f} s ({clock}), {pod_s / sc['n_steps'] * 1e3:.4f} ms/step, "
              f"{N_POD_COLUMNS * sc['n_steps'] / pod_s:.4e} column-updates/s, launches "
              f"{n_launch} ({sc['step'].route}, {sc['step'].unit.label}), finite {finite}, negative_fraction {rep['negative_fraction']}, "
              f"nonfinite_fraction {rep['nonfinite_fraction']}, total_mass "
              f"{rep['total_mass']:.6e} {card}")
        check(finite and rep["nonfinite_fraction"] == 0.0, f"[{variant}] pod state not finite")
        check(rep["negative_fraction"] == 0.0, f"[{variant}] pod state has negative moments")
        yt = sc["state0"][:, :N_CMP_COLUMNS * NZ].contiguous()
        for _ in range(sc["n_steps"]):
            yt = sc["step"].plain(yt)
        perr, _ = row_scaled(y[:, :N_CMP_COLUMNS * NZ], yt)
        print(f"phase 11 [{variant}] first {N_CMP_COLUMNS} columns vs twin on the card: "
              f"row-scaled {perr:.3e} (tol {TOL['float32']:.0e}) {card}")
        check(perr < TOL["float32"], f"[{variant}] pod kernel vs twin {perr:.3e}")
        del y, yt
        norm = torch.tensor(sc["step"].plan.mom_norms, dtype=torch.float32,
                            device=dev)[:, None]
        err, abs_err = row_scaled(sc["step"](sc["state0"]) / norm,
                                  sc["step"].plain(sc["state0"]) / norm)
        check(err < TOL["float32"],
              f"[{variant}] step kernel vs twin at the main-path shape {err:.3e}")
        plain_ms = _time_ms(lambda: sc["step"].plain(sc["state0"]), 1)
        print(f"phase 11 [{variant}] step kernel vs twin at [6, {N_POD_COLUMNS * NZ}] f32: "
              f"row-scaled {err:.3e}, max abs {abs_err:.3e} (normalized); kernel "
              f"{pod_s / sc['n_steps'] * 1e3:.4f} ms/step, twin {plain_ms:.4f} ms/step {card}")
        kernels.append({"name": f"rainshaft_step[{variant}]", "route": "cuda",
                        **kernel_source(sc["step"]), "replaces": B1_REPLACES,
                        "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err,
                        "ms": pod_s / sc["n_steps"] * 1e3, "plain_ms": plain_ms,
                        **bound(f"rainshaft_step[{variant}]", sc["step"].plain,
                                sc["state0"][:, :8 * NZ].contiguous(),
                                N_POD_COLUMNS * NZ, 6, 6)})
        del sc
        torch.cuda.empty_cache()
    print(f"phase 11 seconds {time.perf_counter() - t:.3f}")

    # ---- 12. f64 anchor per variant: kernel vs twin over 120 steps --------
    t = time.perf_counter()
    for variant, scenario in VARIANTS.items():
        sc = harness.SCENARIOS[scenario](
            n_columns=N_ANCHOR_COLUMNS, device=dev, dtype=torch.float64)
        check(sc["step"].route == "generated", f"[{variant}] f64 pod step not generated")
        y, _, _ = sc["run"](N_VARIANT_STEPS)
        yt = sc["state0"]
        for _ in range(N_VARIANT_STEPS):
            yt = sc["step"].plain(yt)
        aerr, _ = row_scaled(y, yt)
        print(f"phase 12 [{variant}] f64 anchor ({N_ANCHOR_COLUMNS} columns, "
              f"{N_VARIANT_STEPS} steps, {sc['step'].route}): kernel vs twin row-scaled {aerr:.3e} "
              f"(tol {TOL['float64']:.0e}) {card}")
        check(bool(torch.isfinite(y).all()), f"[{variant}] f64 anchor not finite")
        check(aerr < TOL["float64"], f"[{variant}] f64 anchor {aerr:.3e}")
    print(f"phase 12 seconds {time.perf_counter() - t:.3f}")

    # ---- 13. the direct-quadrature kernel vs its twin ----------------------
    t = time.perf_counter()
    num_kernels = {
        "linear": K.LinearKernelFunction(5e-3),
        "constant": K.ConstantKernelFunction(1e-3),
        "long": K.LongKernelFunction(2.0, 1e-3, 5e-3),
        "hydro": K.HydrodynamicKernelFunction(1e-2),
    }
    two_gamma = (Family.GAMMA, Family.GAMMA)
    three_mode = (Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL)

    def numerical_moments(families, n, seed):
        """Normalized moments [n_tot, n], parameters drawn first
        (tests/test_pallas_numerical.py:16-29); box 5 empty, box 7 with an
        empty second mode."""
        rng = np.random.default_rng(seed)
        cols = []
        for fam in families:
            p1, p2 = (((-1.0, 1.0), (0.3, 1.0)) if fam == Family.LOGNORMAL
                      else ((0.05, 5.0), (0.5, 5.0)))
            cols.append(np.stack([rng.uniform(10, 200, n), rng.uniform(*p1, n),
                                  rng.uniform(*p2, n)], -1))
        vspec = SpectrumSpec(families)
        mom = pd.get_moments(vspec, torch.as_tensor(np.stack(cols, 1))).numpy().T.copy()
        mom[:, 5] = 0.0
        if vspec.n_modes > 1:
            mom[vspec.offsets[1]:, 7] = 0.0
        return vspec, mom

    one_gamma = (Family.GAMMA,)
    for families, kname in [(two_gamma, k) for k in sorted(num_kernels)] + [
            (three_mode, "long"), (one_gamma, "long"), (one_gamma, "linear")]:
        vspec, mom_np = numerical_moments(families, N_NUM_BOXES, seed=5)
        cancelling = (1,) if len(families) == 1 else ()  # a lone mode keeps its mass
        scale_note = " (mass row over the size of the sums it is left of)" if cancelling else ""
        got_by_type = {}
        for name, dt in dtypes.items():
            fn = nc.make_numerical_fn(vspec, num_kernels[kname], *NUM_NODES, device=dev,
                                      dtype=dt)
            x = torch.as_tensor(mom_np, dtype=dt, device=dev)
            got = fn.soa(x)
            check(fn.launches == 1, "numerical wrapper did not count one launch")
            want = fn.plain(x)
            torch.cuda.synchronize()
            err, abs_err = row_scaled(got, want, cancelling)
            finite = bool(torch.isfinite(got).all())
            empty_zero = bool((got[:, 5] == 0).all())
            repeat = bool(torch.equal(got, fn.soa(x)))
            print(f"phase 13 numerical kernel [{len(families)} modes, {kname}] vs twin "
                  f"{name}: row-scaled{scale_note} {err:.3e} (tol {NUM_TOL[name]:.0e}), max abs "
                  f"{abs_err:.3e}, finite {finite}, empty box exactly zero {empty_zero}, "
                  f"second launch bit-identical {repeat} {card}")
            check(finite, f"numerical kernel [{kname}] {name} not finite")
            check(empty_zero, f"numerical kernel [{kname}] {name}: empty box not zero")
            check(repeat, f"numerical kernel [{kname}] {name}: two launches differ")
            check(err < NUM_TOL[name], f"numerical kernel [{kname}] {name} vs twin {err:.3e}")
            got_by_type[name] = got
        err, _ = row_scaled(got_by_type["float32"], got_by_type["float64"], cancelling)
        err64, _ = row_scaled(got_by_type["float32"], want, cancelling)  # want: the f64 twin
        print(f"phase 13 numerical kernel [{len(families)} modes, {kname}] f32 kernel vs "
              f"f64 kernel: row-scaled {err:.3e}, vs f64 twin {err64:.3e} (tol "
              f"{NUM_TOL['float32']:.0e}) {card}")
        check(err < NUM_TOL["float32"] and err64 < NUM_TOL["float32"],
              f"numerical f32 vs f64 kernel [{kname}] {err:.3e}, vs f64 twin {err64:.3e}")
    print(f"phase 13 seconds {time.perf_counter() - t:.3f}")

    # ---- 14. the numerical bench: 262,144 boxes through the kernel ---------
    t = time.perf_counter()
    nfn = bench.numerical_fn(dev)
    n_box = bench.NUMERICAL_COLUMNS
    x = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=torch.float32, device=dev)
    nfn.soa(x[:, :64].contiguous())  # loads the module, outside the count
    torch.cuda.synchronize()
    nfn.launches = 0
    s_chain = bench.time_chain(nfn.soa, x, N_NUM_STEPS)  # 3 untimed steps first
    num_launches = nfn.launches
    y = bench.relax_chain(nfn.soa, x, N_NUM_STEPS)  # the chain's end state
    finite = bool(torch.isfinite(y).all())
    print(f"phase 14 numerical RHS chain {n_box} boxes f32, Long kernel, nodes "
          f"{nfn.plan.n_po} x {nfn.plan.g_outer} outer and {nfn.plan.n_pi} x "
          f"{nfn.plan.g_inner} inner: {s_chain * 1e3:.4f} ms per RHS step, "
          f"{n_box * 6 / s_chain:.4e} moment-updates/s, launches {num_launches}, "
          f"finite {finite} {card}")
    check(num_launches == N_NUM_STEPS + 3,
          f"numerical kernel launched {num_launches} times, not {N_NUM_STEPS + 3}")
    check(finite, "numerical chain state not finite")
    got = nfn.soa(x)
    want = nfn.plain(x, chunk=NUM_CHUNK)
    nerr, nabs = row_scaled(got, want)
    dm1 = float((got[1] + got[4]).abs().max() / got[1].abs().max())
    print(f"phase 14 numerical kernel vs twin (chunks of {NUM_CHUNK} boxes) at the "
          f"main-path shape [6, {n_box}] f32: row-scaled {nerr:.3e} (tol "
          f"{NUM_TOL['float32']:.0e}), max abs {nabs:.3e}, finite "
          f"{bool(torch.isfinite(got).all())}; total-mass tendency over the largest "
          f"mass tendency {dm1:.3e} {card}")
    check(bool(torch.isfinite(got).all()), "numerical kernel at the main-path shape not finite")
    check(nerr < NUM_TOL["float32"], f"numerical kernel vs twin at the main-path shape {nerr:.3e}")
    num_ms = _time_ms(lambda: nfn.soa(x), 10)
    num_plain_ms = _time_ms(lambda: nfn.plain(x, chunk=NUM_CHUNK), 1)
    print(f"phase 14 per call at [6, {n_box}]: numerical kernel {num_ms:.4f} ms, "
          f"twin {num_plain_ms:.4f} ms {card}")
    kernels.append({"name": "numerical_rhs", "route": "cuda", **kernel_source(nfn),
                    "replaces": B5_REPLACES, "launches": num_launches,
                    "max_abs_err": nabs, "max_row_scaled_err": nerr,
                    "ms": num_ms, "plain_ms": num_plain_ms,
                    **bound("numerical_rhs", nfn.plain, x[:, :64].contiguous(), n_box, 6, 6)})
    del x, y, got, want
    torch.cuda.empty_cache()
    print(f"phase 14 seconds {time.perf_counter() - t:.3f}")

    # ---- 15. the box scenarios on the card, and the kernel at box nodes ----
    t = time.perf_counter()
    for scenario in BOX_SCENARIOS:
        with np.load(ROOT / "tests" / "golden" / f"{scenario}.npz") as z:
            ys_g = z["ys"]
        ys, rep = harness.run_scenario(scenario, device=dev)
        berr = float(np.abs(ys.cpu().numpy() / ys_g - 1.0).max())
        print(f"phase 15 {scenario} f64 on {rep['device']}: {rep['n_steps']} steps in "
              f"{rep['seconds']:.3f} s (host clock), finite {rep['finite']}, total_mass "
              f"{rep['total_mass']:.6e}; vs the stored trajectory: max relative "
              f"{berr:.3e} (tol {BOX_TOL:.0e}) {card}")
        check(rep["finite"] and tuple(ys.shape) == ys_g.shape, f"{scenario} not finite")
        check(berr < BOX_TOL, f"{scenario} vs golden {berr:.3e}")
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(bench.NORMS)
    norm = np.asarray(get_moments_normalizing_factors(spec.nprogmoms, bench.NORMS))
    mom0 = torch.tensor(np.array([1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13]) / norm,
                        device=dev)[:, None].contiguous()
    bfn = nc.make_numerical_fn(spec, kf, 256, 96, device=dev, dtype=torch.float64)
    got = bfn.soa(mom0)[:, 0]
    want = cn.get_coal_ints_numerical(spec, pd.params_from_moments(spec, mom0.T), kf)[0]
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-13 * want.abs().max())).max())
    print(f"phase 15 numerical kernel at (256, 96) nodes ({bfn.plan.g_total} threads) on "
          f"the numerical box's initial state vs the einsum path on the card, f64: max "
          f"relative {rel:.3e} (tol 1e-08) {card}")
    check(rel < 1e-8, f"numerical kernel vs einsum path at box nodes {rel:.3e}")
    print(f"phase 15 seconds {time.perf_counter() - t:.3f}")

    # ---- 16. calibration: EKI through the scaled whole step (B1s) ---------
    t = time.perf_counter()
    from cloudy_tpu_torch.tools import calibration_bench as cb

    for variant in ("fixed2gamma", *VARIANTS):
        _, vdata = harness.pod_data(variant)
        for name, dt in dtypes.items():
            step = fc.make_rainshaft_step_fn(
                vdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz, dt=1.0,
                device=dev, dtype=dt, kernel_scale=True)
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            srow = torch.linspace(0.4, 2.5, N_CMP_COLUMNS, dtype=dt,
                                  device=dev).repeat_interleave(NZ)
            got = step(x, srow)
            check(step.launches == 1, "scaled step wrapper did not count one launch")
            want = step.plain(x, srow)
            torch.cuda.synchronize()
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            err, abs_err = row_scaled(got / norm, want / norm)
            print(f"phase 16 scaled step kernel [{variant}, arms {step.plan.arms}, "
                  f"{step.route}] vs twin {name}, scale 0.4-2.5 per column: row-scaled "
                  f"{err:.3e} (tol {TOL[name]:.0e}), max abs {abs_err:.3e} (normalized) {card}")
            check(bool(torch.isfinite(got).all()), f"scaled step [{variant}] {name} not finite")
            check(err < TOL[name], f"scaled step [{variant}] {name} vs twin {err:.3e}")
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data_s = scaled_tensor_data(spec)
    kw = dict(nz=NZ, dz=sc_cfg.dz, dt=1.0, device=dev, dtype=torch.float64)
    x = torch.as_tensor(state_np, dtype=torch.float64, device=dev)
    got = fc.make_rainshaft_step_fn(fdata, sc_cfg.vel, sc_cfg.norms, kernel_scale=True,
                                    **kw)(x, 1.7)
    want = fc.make_rainshaft_step_fn(data_s, sc_cfg.vel, sc_cfg.norms, **kw)(x)
    ierr, _ = row_scaled(got, want)
    print(f"phase 16 scaled step kernel at s = 1.7 vs the unscaled kernel from the "
          f"1.7-scaled kernel tensor, f64: row-scaled {ierr:.3e} (tol {TOL['float64']:.0e}) "
          f"{card}")
    check(ierr < TOL["float64"], f"scaled step vs scaled tensor {ierr:.3e}")

    records = {}
    for rec in cb.pod_main(dev, members=CAL_MEMBERS, n_steps=CAL_STEPS):
        records[rec["ensemble_members"]] = rec
        print(f"phase 16 EKI J={rec['ensemble_members']} x {rec['member_columns']} columns "
              f"x {rec['nz']} levels x {rec['forward_steps']} steps f32 through B1s: "
              f"{rec['seconds_per_iter'] * 1e3:.4f} ms per iteration (n1 {rec['n1']}, n2 "
              f"{rec['n2']}, median of 5, CUDA events), {rec['eki_iters_per_s']:.4f} "
              f"iterations/s, {rec['member_forwards_per_s']:.4e} member forwards/s, "
              f"{rec['member_model_steps_per_s']:.4e} member model steps/s, "
              f"{rec['member_column_steps_per_s']:.4e} member column-steps/s; one forward "
              f"{rec['forward_seconds'] * 1e3:.4f} ms; 8 iterations: s "
              f"{rec['s_recovered_8iters']:.6f} (true 1.7), {rec['b1s_launches_8iters']} "
              f"launches, observables finite {rec['observables_finite']}, misfit "
              f"{rec['misfit_8iters'][0]:.4e} -> {rec['misfit_8iters'][-1]:.4e} {card}")
        print(json.dumps({**rec, "card": smi.splitlines()[0]}))
    rec = records[CAL_MEMBERS[-1]]
    want_launches = 9 * CAL_STEPS
    check(rec["b1s_launches_8iters"] == want_launches,
          f"B1s launched {rec['b1s_launches_8iters']} times in the 8-iteration EKI run, "
          f"not {want_launches}")
    check(all(r["observables_finite"] for r in records.values()), "EKI observables not finite")
    for r in records.values():
        check(abs(r["s_recovered_8iters"] - 1.7) / 1.7 < 0.02,
              f"EKI J={r['ensemble_members']} recovered s = {r['s_recovered_8iters']:.6f}, "
              "not within 2 % of 1.7")
    # the device's busy share of an EKI window (torch.profiler's device
    # activities over a CUDA-event window of two 4-iteration runs)
    from cloudy_tpu_torch.tools import profile_step

    for J in CAL_MEMBERS:
        prof = profile_step.profile_eki(J)
        share = prof["busy_share"]
        print(f"phase 16 EKI J={J} through B1s ({records[J]['seconds_per_iter'] * 1e3:.4f} ms "
              f"per iteration above): busy share "
              f"{'not measured' if share is None else f'{share:.4f}'} of a "
              f"{prof['window_ms']:.4f} ms window of 2 x 4 iterations {card}")

    # B1s against its twin at the main path's shape, and the times there
    n_ens = CAL_MEMBERS[-1]
    forward, _ = cb.make_pod_forward(n_ens, device=dev)
    state = forward.state0
    theta = torch.linspace(math.log(0.5), math.log(3.0), n_ens, device=dev)
    srow = torch.exp(theta).repeat_interleave(state.shape[1] // n_ens)
    step = forward.step
    norm = torch.tensor(step.plan.mom_norms, dtype=torch.float32, device=dev)[:, None]
    y = state
    for _ in range(10):  # a state with both modes populated
        y = step(y, srow)
    serr, sabs = row_scaled(step(y, srow) / norm, step.plain(y, srow) / norm)
    print(f"phase 16 scaled step kernel vs twin at the main-path shape [6, {state.shape[1]}] "
          f"f32 (after 10 steps, scale 0.5-3.0 by member): row-scaled {serr:.3e} (tol "
          f"{TOL['float32']:.0e}), max abs {sabs:.3e} (normalized) {card}")
    check(serr < TOL["float32"], f"scaled step vs twin at the main-path shape {serr:.3e}")
    b1s_ms = _time_ms(lambda: step(y, srow), 100)
    b1s_plain_ms = _time_ms(lambda: step.plain(y, srow), 5)
    print(f"phase 16 per call at [6, {state.shape[1]}]: B1s kernel ({step.route}) "
          f"{b1s_ms:.4f} ms, B1s twin {b1s_plain_ms:.4f} ms; unscaled B1 fixed2gamma at [6, "
          f"{N_POD_COLUMNS * NZ}] in this call (phase 6, generated) {b1_ms:.4f} ms/step {card}")
    # B1s as redesigned: the generated unit against the table-driven instance
    # it replaces, in turns at the EKI run's shape, with the unscaled
    # generated B1 fixed2gamma at 2^20 x 32 read in a turn before and after
    check(step.route == "generated", f"the EKI forward's B1s runs route {step.route}")
    table = fc.ScaledRainshaftStepFn(step.plan, dev, torch.float32, _table=True)
    terr, _ = row_scaled(table(y, srow) / norm, step.plain(y, srow) / norm)
    check(terr < TOL["float32"], f"table-driven B1s vs twin {terr:.3e}")
    grec = next(r for r in gen_records if r["label"] == step.unit.label)
    g_rep = yardstick.gen_report(step.unit, grec)
    t_rep = yardstick.table_report("step", torch.float32, step.plan.arms, step.plan,
                                   scaled=True)

    def show(r):
        pt, sass = r["ptxas"], r["sass"]
        return (f"{pt.get('registers')} registers, {pt.get('stack')} B stack, "
                f"{pt.get('spill_stores')}/{pt.get('spill_loads')} B spill stores/loads; SASS "
                + " ".join(f"{k} {sass.get(k)}" for k in ("LDL", "STL", "LDS", "STS", "BAR",
                                                           "SHFL", "CALL"))
                + f" of {sass.get('total')} instructions; {r['blocks_per_sm']} blocks/SM")

    print(f"phase 16 B1s generated {step.unit.label} (nvcc {g_rep['nvcc_s']:.3f} s"
          f"{', rebuilt' if g_rep['retried'] else ''}): {show(g_rep)} | table-driven: "
          f"{show(t_rep)} | table-driven vs twin {terr:.3e} {card}")
    check(g_rep["ptxas"].get("stack") == 0 and g_rep["sass"].get("LDL") == 0,
          f"generated B1s has stack or local memory: {g_rep}")
    b1_gen, _ = yardstick.make_fns("fixed2gamma", "step", dev, torch.float32)
    x_pod = yardstick.pod_state("fixed2gamma", N_POD_COLUMNS, dev, torch.float32)

    def b1_turn():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        yy = b1_gen(x_pod)  # warm: the outputs' allocation outside the window
        start.record()
        for _ in range(N_GEN_STEPS):
            yy = b1_gen(yy)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / N_GEN_STEPS

    b1_turns = [b1_turn()]
    (s_tab, s_gen), s_raw = yardstick.time_turns([table, step], "step", y,
                                                 N_SCALED_TURN_STEPS, scale=srow)
    b1_turns.append(b1_turn())
    band = all(6.08 <= v <= 6.18 for v in b1_turns)
    print(f"phase 16 B1s at [6, {y.shape[1]}] f32, {N_SCALED_TURN_STEPS} steps per turn: "
          f"table-driven {s_tab:.4f} ms/step, generated {s_gen:.4f} ms/step "
          f"({s_tab / s_gen:.3f}x; turns table {[round(v, 4) for v in s_raw[0]]}, generated "
          f"{[round(v, 4) for v in s_raw[1]]}); unscaled generated B1 fixed2gamma at [6, "
          f"{x_pod.shape[1]}] in a turn before and after: {[round(v, 4) for v in b1_turns]} "
          f"ms/step ({'within' if band else 'outside'} its recorded band 6.08-6.18) {card}")
    print(json.dumps({"phase": 16, "b1s_generated": g_rep, "b1s_table": t_rep,
                      "b1s_ms_turns": s_raw, "b1_unscaled_ms_turns": b1_turns,
                      "card": smi.splitlines()[0]}))
    del table, x_pod, b1_gen
    small = 8 * NZ
    kernels.append({"name": "rainshaft_step[scaled]", "route": "cuda", **kernel_source(step),
                    "replaces": B1S_REPLACES, "launches": rec["b1s_launches_8iters"],
                    "max_abs_err": sabs, "max_row_scaled_err": serr,
                    "ms": b1s_ms, "plain_ms": b1s_plain_ms, "table_ms": s_tab,
                    **bound("rainshaft_step[scaled]",
                            lambda v: step.plain(v, srow[:small]),
                            y[:, :small].contiguous(), state.shape[1], 7, 6)})
    del forward, state, y, step
    torch.cuda.empty_cache()
    print(f"phase 16 seconds {time.perf_counter() - t:.3f}")

    # ---- 17. the reference tier: each new instance against its twin -------
    t = time.perf_counter()
    for ln in ptxas_summary(log):
        if "reference" in ln or ln.startswith("step_kernel<float, false, unscaled>"):
            print(f"phase 17 ptxas (phase 2): {ln}")
    print(f"phase 17 unscaled B1 fixed2gamma in this call (phase 6, generated): {b1_ms:.4f} "
          f"ms/step (table-driven, recorded: 27.15-27.50) {card}")

    from cloudy_tpu_torch.tools.reference_tune import ref_data, small_trajectory

    def param_moments(families, n, seed):
        """Normalized moments [n_tot, n], parameters drawn first: moving
        thresholds on both sides of T = 1."""
        rng = np.random.default_rng(seed)
        par = np.stack([np.stack([rng.uniform(10, 200, n), rng.uniform(0.05, 5.0, n),
                                  rng.uniform(0.5, 5.0, n)], -1) for _ in families], axis=1)
        return pd.get_moments(SpectrumSpec(families), torch.as_tensor(par)).numpy().T.copy()

    for case, (bkw, ckw) in REF_CASES.items():
        data = ref_data(**bkw)
        mom_np = param_moments(data.spec.families, N_REF_BOXES, seed=11)
        for name, dt in dtypes.items():
            fn = fc.make_coal_fn(data, device=dev, dtype=dt, **ckw)
            check(fn.plan.instance == 2, f"[{case}] does not select the reference tier")
            x = torch.as_tensor(mom_np, dtype=dt, device=dev)
            got = fn.soa(x)
            check(fn.launches == 1, "coal wrapper did not count one launch")
            want = fn.plain(x)
            torch.cuda.synchronize()
            err, abs_err = row_scaled(got, want)
            finite = bool(torch.isfinite(got).all())
            bins = ""
            if fn.plan.moving and fn.plan.quad_rule == "reference":
                thr = fc.moving_thresholds(fn.plan, x)[0]
                nb = fc.moving_bins(thr)
                lo, hi = thr < 1.0, thr > 1.0
                check(bool(lo.any()) and bool(hi.any()), "moving lanes not on both sides of T = 1")
                bins = (f"; twin nb: {int(lo.sum())} lanes T < 1 all at "
                        f"{sorted(set(nb[lo].tolist()))}, {int(hi.sum())} lanes T > 1 at "
                        f"{int(nb[hi].min())}-{int(nb[hi].max())}")
            ms = _time_ms(lambda: fn.soa(x), 5)
            print(f"phase 17 coal kernel [reference, {case}] vs twin {name} at [{data.spec.n_tot}, "
                  f"{N_REF_BOXES}]: row-scaled {err:.3e} (tol {TOL[name]:.0e}), max abs "
                  f"{abs_err:.3e}, finite {finite}; kernel {ms:.4f} ms{bins} {card}")
            check(finite, f"reference coal kernel [{case}] {name} not finite")
            check(err < TOL[name], f"reference coal kernel [{case}] {name} vs twin {err:.3e}")
    step_cases = {k: REF_CASES[k] for k in REF_STEP_CASES}
    ref_times = {}
    for case, (bkw, ckw) in step_cases.items():
        data = ref_data(**bkw)
        for name, dt in dtypes.items():
            x = torch.as_tensor(state_np, dtype=dt, device=dev)
            xt = None  # rainshaft_small's states, side by side (the rows' timing)
            step = fc.make_rainshaft_step_fn(data, sc_cfg.vel, sc_cfg.norms, nz=NZ,
                                             dz=sc_cfg.dz, dt=1.0, device=dev, dtype=dt, **ckw)
            rfn = fc.make_rainshaft_rhs_fn(data, sc_cfg.vel, sc_cfg.norms, device=dev,
                                           dtype=dt, **ckw)
            check(step.plan.instance == 2 and rfn.plan.instance == 2,
                  f"[{case}] does not select the reference tier")
            check(step.route == rfn.route == "generated",
                  f"[{case}] reference step and RHS routes {step.route}, {rfn.route}")
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            for kind, fn, nrm in (("step", step, norm), ("rhs", rfn, torch.cat([norm, norm]))):
                call = fn if kind == "step" else fn.soa
                got = call(x)
                check(fn.launches == 1, f"{kind} wrapper did not count one launch")
                want = fn.plain(x)
                torch.cuda.synchronize()
                err, abs_err = row_scaled(got / nrm, want / nrm)
                finite = bool(torch.isfinite(got).all())
                print(f"phase 17 {kind} kernel [reference, {case}] ({fn.unit.label}) vs twin "
                      f"{name} at [6, {N_CMP_COLUMNS * NZ}]: row-scaled {err:.3e} (tol "
                      f"{TOL[name]:.0e}), max abs {abs_err:.3e} (normalized), finite {finite} "
                      f"{card}")
                check(finite, f"reference {kind} kernel [{case}] {name} not finite")
                check(err < TOL[name], f"reference {kind} kernel [{case}] {name} vs twin {err:.3e}")
                if case == "fixed Simpson":
                    # the kernels line's row: rainshaft_small's own states (the
                    # path phase 18 counts), column c after 20 (c mod 7) steps
                    if xt is None:
                        xt = small_trajectory(step, N_CMP_COLUMNS)
                    got, want = call(xt), fn.plain(xt)
                    torch.cuda.synchronize()
                    err, abs_err = row_scaled(got / nrm, want / nrm)
                    check(err < TOL[name], f"reference {kind} kernel {name} on rainshaft_small's "
                          f"states vs twin {err:.3e}")
                    ms = _time_ms(lambda: call(xt), 5)
                    plain_ms = _time_ms(lambda: fn.plain(xt), 1)
                    rows_out = 6 if kind == "step" else 12
                    ref_times[(kind, name)] = (
                        kernel_source(fn), err, abs_err, ms, plain_ms,
                        bound(f"{kind}[reference, {name}]", fn.plain, xt[:, :7 * NZ].contiguous(),
                              N_CMP_COLUMNS * NZ, 6, rows_out, f64=name == "float64"))
                    print(f"phase 17 per call at [6, {N_CMP_COLUMNS * NZ}] {name} on rainshaft_small's "
                          f"states: {kind} kernel [reference, fixed Simpson] {ms:.4f} ms, twin "
                          f"{plain_ms:.4f} ms; vs twin row-scaled {err:.3e}, max abs {abs_err:.3e} "
                          f"(normalized) {card}")
            del step, rfn, x
    torch.cuda.empty_cache()
    print(f"phase 17 seconds {time.perf_counter() - t:.3f}")

    # ---- 18. the golden runs through the reference-tier kernels -----------
    t = time.perf_counter()
    with np.load(ROOT / "tests" / "golden" / "rainshaft_128.npz") as z:
        ys128 = z["ys"]  # [11, 128, 6]: every 30th of 300 f64 Simpson-tier steps
    scale128 = np.abs(ys128).max(axis=(0, 1))
    # the runs stop at GOLDEN_128_T_END and are held on the frames they reach
    ys128 = ys128[:int(GOLDEN_128_T_END) // 30 + 1]
    # tests/test_golden.py:168-191 runs the bench overrides with x64 on (f64);
    # in f32 the reference's own trajectory leaves 1e-3 of the golden at
    # t = 180 s (tests/test_torch_rainshaft.py), so the f32 run is held
    # against the torch-ops route in f32 at the same configuration
    hook_runs = {
        "reference, f64": (torch.float64, {}, REF_GOLDEN_TOL),
        "bench overrides (quad_rule gauss), f64": (torch.float64, BENCH_OVERRIDES, GOLDEN_TOL),
        "bench overrides (quad_rule gauss), f32": (torch.float32, BENCH_OVERRIDES, None),
    }
    golden_launches = {}
    for label, (dt, kw, tol) in hook_runs.items():
        sc = harness.SCENARIOS["rainshaft_128"](device=dev, dtype=dt, hook=True,
                                                t_end=GOLDEN_128_T_END, **kw)
        sc["coal_fn"].launches = 0
        ys, secs, _ = sc["run"]()
        n_launch = sc["coal_fn"].launches
        check(n_launch == 3 * sc["n_steps"],
              f"rainshaft_128 hook launched {n_launch} times, not {3 * sc['n_steps']}")
        ys = ys.double().cpu().numpy()
        check(ys.shape == ys128.shape and bool(np.isfinite(ys).all()),
              f"rainshaft_128 [{label}] not finite or of shape {ys.shape}")
        frames = (np.abs(ys - ys128) / scale128).max(axis=(1, 2))
        gerr = float(frames.max())
        hook_route = sc["coal_fn"].route
        if hook_route == "table":
            hook_route += f", a {sc['coal_fn'].layout(128)} per box"
        print(f"phase 18 rainshaft_128 through the coal kernel hook [{label}, instance "
              f"{sc['coal_fn'].plan.instance}, {hook_route}], 128 levels x "
              f"{GOLDEN_128_T_END:g} s (frames t = 0-{GOLDEN_128_T_END:g} s of the golden's 300): "
              f"per-moment-scaled "
              f"{gerr:.3e} vs its golden (largest at t = {30 * int(frames.argmax())} s"
              f"{f', tol {tol:.0e}' if tol else ''}), launches {n_launch}, {secs:.3f} s "
              f"(host clock) {card}")
        if tol is not None:
            check(gerr < tol, f"rainshaft_128 [{label}] vs golden {gerr:.3e}")
        else:
            fast = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9),
                                          gammainc_iters=12, f2_exact=True,
                                          gammainc_gl_nodes=12)
            _, yo = rs.run_rainshaft(sc["config"], rs.make_rainshaft_rhs(sc["config"], fast),
                                     sc["ic"], dtype=dt, device=dev)
            yo = yo.double().cpu().numpy()
            oerr = float((np.abs(yo - ys128) / scale128).max())
            rerr = float((np.abs(ys - yo) / scale128).max())
            print(f"phase 18 rainshaft_128 [{label}] through the kernel hook vs through torch "
                  f"ops (the same fast-tier configuration, f32, on the card): per-moment-scaled "
                  f"{rerr:.3e} (tol {GOLDEN_TOL:.0e}); torch ops vs the golden {oerr:.3e} {card}")
            check(rerr < GOLDEN_TOL, f"rainshaft_128 [{label}] hook vs torch ops {rerr:.3e}")
        golden_launches[("hook", dt, bool(kw))] = n_launch
        if dt == torch.float64 and not kw:
            hook_fn = sc["coal_fn"]
            mn = get_moments_normalizing_factors(spec.nprogmoms, sc["config"].norms)
            x128 = (torch.as_tensor(ys[1]) / torch.as_tensor(mn)).T.contiguous().to(dev)
        del sc
    with np.load(ROOT / "tests" / "golden" / "rainshaft_small.npz") as z:
        ys_small = z["ys"]
    scale_small = np.abs(ys_small).max(axis=(0, 1))
    sdata = ref_data()
    for name, dt in dtypes.items():
        tol = REF_GOLDEN_TOL if name == "float64" else GOLDEN_TOL
        step = fc.make_rainshaft_step_fn(sdata, sc_cfg.vel, sc_cfg.norms, nz=NZ, dz=sc_cfg.dz,
                                         dt=1.0, device=dev, dtype=dt)
        rfn = fc.make_rainshaft_rhs_fn(sdata, sc_cfg.vel, sc_cfg.norms, device=dev, dtype=dt)
        fused = rs.make_rainshaft_rhs_fused(sc_cfg, rfn)
        y0 = rs.to_soa(torch.as_tensor(np.tile(ys_small[0][None], (N_ANCHOR_COLUMNS, 1, 1)))
                       ).to(dev, dt)
        for kind in ("step", "rhs"):
            fn = step if kind == "step" else rfn
            fn.launches = 0
            y, gerr = y0, 0.0
            for s_ in range(1, 121):
                y = step(y) if kind == "step" else stepper.ssprk33_step(fused, y, 0.0, 1.0)
                if s_ % 20 == 0:
                    got = rs.from_soa(y, NZ).double().cpu().numpy()
                    gerr = max(gerr, float((np.abs(got - ys_small[s_ // 20][None])
                                            / scale_small).max()))
            n_launch = fn.launches
            if kind == "step" and dt == torch.float64:
                # the f64 kernel against its twin over the same 120 steps, 4 columns
                yt = y0[:, :4 * NZ].contiguous()
                for _ in range(120):
                    yt = step.plain(yt)
                nrm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
                terr, _ = row_scaled(y[:, :4 * NZ] / nrm, yt / nrm)
                print(f"phase 18 rainshaft_small reference-tier whole step f64 vs its twin on "
                      f"the card after 120 steps, 4 columns: row-scaled {terr:.3e} (tol "
                      f"{TOL['float64']:.0e}) {card}")
                check(terr < TOL["float64"], f"reference step f64 vs twin over 120 steps {terr:.3e}")
            want_launch = 120 if kind == "step" else 360
            route = "whole-step kernel" if kind == "step" else "fused-RHS route (rhs kernel)"
            route += f", {fn.route} {fn.unit.label}"
            print(f"phase 18 rainshaft_small through the reference-tier {route} {name}, "
                  f"{N_ANCHOR_COLUMNS} columns x 120 steps: per-moment-scaled {gerr:.3e} vs its "
                  f"golden (tol {tol:.0e}), launches {n_launch} {card}")
            check(n_launch == want_launch, f"{kind} kernel launched {n_launch}, not {want_launch}")
            check(bool(torch.isfinite(y).all()) and gerr < tol,
                  f"rainshaft_small through the reference {kind} kernel {name}: {gerr:.3e}")
            golden_launches[(kind, dt)] = n_launch
        del step, rfn, fused
    box = harness.SCENARIOS["box_exp_gamma_mixture"](device=dev)
    with np.load(ROOT / "tests" / "golden" / "box_exp_gamma_mixture.npz") as z:
        ys_box = z["ys"]  # [121, 5]
    box_norms = torch.tensor(get_moments_normalizing_factors(box["spec"].nprogmoms,
                                                             box["config"].norms), device=dev)
    for label, dt, kw, tol in (("reference, f64", torch.float64, {}, REF_GOLDEN_TOL),
                               ("gauss-fallback, f32", torch.float32,
                                dict(BENCH_OVERRIDES, f2_exact=False), GOLDEN_TOL)):
        fn = fc.make_coal_fn(box["data"], device=dev, dtype=dt, **kw)
        nrm = box_norms.to(dt)

        def box_rhs(mom, _t, fn=fn, nrm=nrm):
            return fn(mom / nrm) * nrm

        y0 = box["state0"].to(dt)[None].repeat(8, 1)
        fn.launches = 0
        _, ys = stepper.integrate(box_rhs, y0, 0.0, box["config"].dt, box["n_steps"])
        n_launch = fn.launches
        ys = ys[:, 0, :].double().cpu().numpy()
        berr = float((np.abs(ys - ys_box) / np.abs(ys_box).max(axis=0)).max())
        print(f"phase 18 box_exp_gamma_mixture through the coal kernel [{label}, instance "
              f"{fn.plan.instance}], 120 steps: per-moment-scaled {berr:.3e} vs its golden "
              f"(tol {tol:.0e}), launches {n_launch} {card}")
        check(n_launch == 3 * box["n_steps"], f"box coal kernel launched {n_launch} times")
        check(bool(np.isfinite(ys).all()) and berr < tol,
              f"box_exp_gamma_mixture [{label}] vs golden {berr:.3e}")
    # B3's f64 reference instance at its path's shape, after the counts were read
    herr, habs = row_scaled(hook_fn.soa(x128), hook_fn.plain(x128))
    check(herr < TOL["float64"], f"reference coal kernel at [6, 128] f64 vs twin {herr:.3e}")
    hook_ms = _time_ms(lambda: hook_fn.soa(x128), 50)
    hook_plain_ms = _time_ms(lambda: hook_fn.plain(x128), 5)
    print(f"phase 18 coal kernel [reference, f64] at its path's shape [6, 128] (a rainshaft_128 "
          f"state, {hook_fn.layout(128)} per box): row-scaled {herr:.3e}, max abs {habs:.3e}; "
          f"kernel {hook_ms:.4f} ms, twin {hook_plain_ms:.4f} ms {card}")
    check(hook_fn.layout(128) == "warp", "the rainshaft_128 hook does not take a warp per box")
    kernels.append({"name": "coal_rhs[reference, f64, rainshaft_128 hook]", "route": "cuda",
                    **kernel_source(hook_fn, 128), "replaces": B3_REPLACES,
                    "launches": golden_launches[("hook", torch.float64, False)],
                    "max_abs_err": habs, "max_row_scaled_err": herr, "ms": hook_ms,
                    "plain_ms": hook_plain_ms,
                    **bound("coal_rhs[reference, f64]", hook_fn.plain, x128, 128, 6, 6,
                            f64=True)})
    for (kind, name), (src, err, abs_err, ms, plain_ms, bnd) in ref_times.items():
        dt = dtypes[name]
        kernels.append({"name": f"{'rainshaft_step' if kind == 'step' else 'rainshaft_rhs'}"
                                f"[reference, {'f32' if name == 'float32' else 'f64'}]",
                        "route": "cuda", **src,
                        "replaces": B1_REPLACES if kind == "step" else B4_REPLACES,
                        "launches": golden_launches[(kind, dt)], "max_abs_err": abs_err,
                        "max_row_scaled_err": err, "ms": ms, "plain_ms": plain_ms, **bnd})
    del hook_fn, box
    print(f"phase 18 seconds {time.perf_counter() - t:.3f}")

    # ---- 19. the bench chain at bench.py's four switch settings -----------
    t = time.perf_counter()
    x = torch.as_tensor(bench.bench_moments(bench.BENCH_COLUMNS).T.copy(), dtype=torch.float32,
                        device=dev)
    for f2_exact, gl in BENCH_SWITCHES:
        fn = bench.coal_fn(dev, f2_exact=bool(f2_exact), gl_nodes=gl)
        fn.soa(x[:, :256].contiguous())  # warm-up outside the count
        torch.cuda.synchronize()
        fn.launches = 0
        s_chain = bench.time_chain(fn.soa, x, N_BENCH_STEPS)
        n_launch = fn.launches
        check(n_launch == N_BENCH_STEPS + 3,
              f"bench chain ({f2_exact}, {gl}) launched {n_launch} times, not {N_BENCH_STEPS + 3}")
        rate = bench.BENCH_COLUMNS * 6 / s_chain
        err, abs_err = row_scaled(fn.soa(x), fn.plain(x))
        check(err < TOL["float32"], f"bench ({f2_exact}, {gl}) kernel vs twin {err:.3e}")
        ms = _time_ms(lambda: fn.soa(x), 10)
        plain_ms = _time_ms(lambda: fn.plain(x), 1)
        inst = "reference tier" if fn.plan.ref else "fast tier"
        print(f"phase 19 bench chain f2_exact={f2_exact} gl_nodes={gl} ({inst}) "
              f"{bench.BENCH_COLUMNS} boxes f32: {s_chain * 1e3:.4f} ms/step, {rate:.4e} "
              f"moment-updates/s, launches {n_launch}; kernel vs twin at [6, "
              f"{bench.BENCH_COLUMNS}] row-scaled {err:.3e}, max abs {abs_err:.3e}; kernel "
              f"{ms:.4f} ms, twin {plain_ms:.4f} ms {card}")
        print(json.dumps({"metric": "coalescence_moment_updates_per_s", "value": rate,
                          "f2_exact": bool(f2_exact), "gl_nodes": gl, "instance": inst,
                          "launches": n_launch, "device": torch.cuda.get_device_name(0),
                          "card": smi.splitlines()[0]}))
        if fn.plan.ref:
            kernels.append({"name": f"coal_rhs[reference, f32, bench f2_exact={f2_exact} "
                                    f"gl_nodes={gl}]", "route": "cuda",
                            **kernel_source(fn, bench.BENCH_COLUMNS),
                            "replaces": B3_REPLACES, "launches": n_launch,
                            "max_abs_err": abs_err, "max_row_scaled_err": err, "ms": ms,
                            "plain_ms": plain_ms,
                            **bound(f"coal_rhs[reference, bench {f2_exact}/{gl}]", fn.plain,
                                    x[:, :256].contiguous(), bench.BENCH_COLUMNS, 6, 6)})
        del fn
    del x
    torch.cuda.empty_cache()
    print(f"phase 19 seconds {time.perf_counter() - t:.3f}")

    # ---- 20. the monodisperse and lognormal Φ-grid arms, the family matrix --
    phase_20(dev, card, smi, log, b1_ms, kernels, bound, sc_cfg)

    # ---- 21. the per-op-class chain benchmark (B6) and the class model -----
    class_model = phase_21(dev, card, b1_ms, num_ms, kernels)

    # ---- 22. B-cover: configurations no earlier phase drives ---------------
    phase_22(dev, card, kernels, bound)

    # ---- 23. the generated B1 and B4 against their table-driven instances --
    phase_23(dev, card, {r["label"]: r for r in gen_records})

    # ---- 24. B3 and B5 as redesigned, against what they replace -----------
    phase_24(dev, card, log, b1_ms, {r["label"]: r for r in gen_records}, class_model)

    # ---- 25. C.1 and C.2: four gamma modes, the scaled reference step ----
    phase_25(dev, card, kernels, bound, {r["label"]: r for r in gen_records})

    # ---- 26. A.13: checkpoint, resume and output of the pod job ---------
    phase_26(dev, card, kernels, pod_final, pod_twin, b1_ms, step_plain_ms, step_bound)
    pod_hashes = _shard_hashes(pod_final, 2)  # phase 29 holds the sharded pod to these
    del pod_final, pod_twin
    torch.cuda.empty_cache()

    # ---- 27. A.14: the long horizon, f32 generated B1 against f64 reference
    phase_27(dev, card, kernels, bound)

    # ---- 28. A.9: condensation, the parcel, the adaptive stepper ---------
    phase_28(dev, card)

    # ---- 29. A.10: the sharded pod and the parallel package, in children --
    torch.cuda.empty_cache()
    phase_29(dev, card, kernels, pod_hashes, kernels[0], bound)

    # ---- 30. B5 with a traced kernel function, the native oracle,
    # the examples and whole_step_1m on the card --------------------------
    torch.cuda.empty_cache()
    phase_30(dev, card, kernels, bound, b1_ms, log)

    # ---- 31. the generated reference tier against the table-driven one ----
    torch.cuda.empty_cache()
    phase_31(dev, card)
    late = _build.GEN_BUILDS[n_gen_built:]
    print(f"generated units built after phase 2: {len(late)} "
          f"{[r['label'] for r in late]}")
    check(not late, "a phase launched a generated unit that generated_wrappers does not "
          f"list: {[r['label'] for r in late]}")

    print(f"total seconds {time.perf_counter() - t_all:.3f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase_20(dev, card, smi, log, b1_ms, kernels, bound, sc_cfg):
    """Phase 20: the monodisperse and lognormal Φ-grid arms of the
    coalescence, whole-step and fused-RHS kernels against their twins, each
    arm's chain, and the whole-step family matrix; appends its entries to
    `kernels`. `bound` and `sc_cfg` are main's: the roofline helper and the
    32-level rainshaft configuration."""
    import numpy as np
    import torch

    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec
    from cloudy_tpu_torch.tools import whole_step_ablation as wsa

    t = time.perf_counter()
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    for ln in ptxas_summary(log):
        print(f"phase 20 ptxas (phase 2): {ln}")
    print(f"phase 20 unscaled B1 fixed2gamma in this call (phase 6, generated): {b1_ms:.4f} "
          f"ms/step (table-driven, recorded: 27.15-27.50) {card}")
    M_, L_, E_, G_ = Family.MONODISPERSE, Family.LOGNORMAL, Family.EXPONENTIAL, Family.GAMMA
    gauss12 = ({"gammainc_gl_nodes": 12}, {"quad_rule": "gauss", "gauss_nodes": 12})
    arm_cases = {
        "mono + gamma, fixed": ((M_, G_), False, {}, {}),
        "mono + gamma, moving": ((M_, G_), True, {}, {}),
        "gamma + mono (mono last)": ((G_, M_), False, {}, {}),
        "lognormal + gamma, fixed Simpson, series erf": ((L_, G_), False, {}, {}),
        "lognormal + gamma, fixed Gauss 12, erf_approx": ((L_, G_), False, *gauss12),
        "lognormal + gamma, moving Simpson, series erf": ((L_, G_), True, {}, {}),
        "lognormal + gamma, moving Gauss 12, erf_approx": ((L_, G_), True, *gauss12),
        "exponential + lognormal + gamma": ((E_, L_, G_), False, {}, {}),
    }
    for case, (fams, moving, bkw, ckw) in arm_cases.items():
        thr = (0.9, 1.0, 1.0)[:len(fams)] if moving else (2e-10, 5e-10, np.inf)[-len(fams):]
        data = build_coalescence_data(SpectrumSpec(fams), ker, thr, norms=(1e6, 1e-9),
                                      moving=moving, **bkw)
        mom_np = arm_moments(fams, N_REF_BOXES, seed=13)
        sides = ""
        if fams[0] == M_ and not moving:
            theta = mom_np[1] / mom_np[0]
            half = np.float32(data.thresholds[0]) / 2
            sides = f"; mono θ < T/2 in {int((theta < half).sum())} lanes, not in " \
                    f"{int((theta >= half).sum())}"
            check((theta < half).any() and (theta >= half).any(), "mono lanes on one side of T/2")
        for name, dt in dtypes.items():
            fn = fc.make_coal_fn(data, device=dev, dtype=dt, **ckw)
            check(fn.plan.instance == 2, f"[{case}] does not select the reference tier")
            x = torch.as_tensor(mom_np, dtype=dt, device=dev)
            got = fn.soa(x)
            check(fn.launches == 1, "coal wrapper did not count one launch")
            want = fn.plain(x)
            torch.cuda.synchronize()
            err, abs_err = row_scaled(got, want)
            finite = bool(torch.isfinite(got).all())
            print(f"phase 20 coal kernel [{case}] vs twin {name} at [{data.spec.n_tot}, "
                  f"{N_REF_BOXES}]: row-scaled {err:.3e} (tol {TOL[name]:.0e}), max abs "
                  f"{abs_err:.3e}, finite {finite}{sides} {card}")
            check(finite, f"arm coal kernel [{case}] {name} not finite")
            check(err < TOL[name], f"arm coal kernel [{case}] {name} vs twin {err:.3e}")

    # each arm's Euler chain at 2^20 boxes through the coalescence kernel, at
    # the family matrix's configurations
    for arm, case in (("mono", "mono-gamma-closed"), ("lognorm_grid", "lognorm-gamma-grid")):
        data, kw = wsa.case_data(case)
        fn = fc.make_coal_fn(data, device=dev, dtype=torch.float32, **kw)
        x = torch.as_tensor(arm_moments(data.spec.families, bench.BENCH_COLUMNS, seed=0),
                            dtype=torch.float32, device=dev)
        fn.soa(x[:, :256].contiguous())  # warm-up outside the count
        torch.cuda.synchronize()
        fn.launches = 0
        s_chain = bench.time_chain(fn.soa, x, N_ARM_STEPS)
        n_launch = fn.launches
        check(n_launch == N_ARM_STEPS + 3,
              f"coal kernel [{arm}] launched {n_launch} times, not {N_ARM_STEPS + 3}")
        err, abs_err = row_scaled(fn.soa(x), fn.plain(x))
        check(err < TOL["float32"], f"coal kernel [{arm}] vs twin at [n_tot, 2^20] {err:.3e}")
        ms, plain_ms = _time_ms(lambda: fn.soa(x), 20), _time_ms(lambda: fn.plain(x), 2)
        n_tot = data.spec.n_tot
        print(f"phase 20 coal RHS chain [{arm}] {bench.BENCH_COLUMNS} boxes f32: "
              f"{s_chain * 1e3:.4f} ms/step, {bench.BENCH_COLUMNS * n_tot / s_chain:.4e} "
              f"moment-updates/s, launches {n_launch}; at [{n_tot}, {bench.BENCH_COLUMNS}] "
              f"row-scaled {err:.3e}, max abs {abs_err:.3e}; kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms {card}")
        kernels.append({"name": f"coal_rhs[{arm}]", "route": "cuda",
                        **kernel_source(fn, bench.BENCH_COLUMNS),
                        "replaces": B3_REPLACES, "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        **bound(f"coal_rhs[{arm}]", fn.plain, x[:, :256].contiguous(),
                                bench.BENCH_COLUMNS, n_tot, n_tot)})
        del fn, x

    def mono_flips(a, b, data):
        """Lanes whose mono θ = m1/m0 lies on different sides of T/2 in two
        normalized states (the closed form's knife edge)."""
        half = float(np.float32(data.thresholds[0])) / 2
        ta, tb = a[1] / a[0], b[1] / b[0]
        return int(((ta < half) != (tb < half)).sum())

    def arm_state(spec, n_cols, seed):
        """[n_tot, n_cols·nz] physical states: the mode-1 pulse (first nprog
        moments), a seeded gamma mode 2, per-column amplitudes, a negative
        moment and a whole negative level."""
        n1 = spec.nprogmoms[0]
        ic = np.concatenate([rs.initial_condition(sc_cfg.z, [1e8, 1e-2, 2e-12])[:, :n1],
                             rs.initial_condition(sc_cfg.z, [1e7, 1e-3, 2e-13])], axis=-1)
        amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 1))
        st = np.tile(ic[None], (n_cols, 1, 1)) * amp
        st[0, NZ // 2, 0] *= -1.0
        st[1, NZ // 2 + 1, :] = -1e-3
        return rs.to_soa(torch.as_tensor(st))

    for case in MATRIX_REF_CASES:
        data, kw = wsa.case_data(case)
        st = arm_state(data.spec, N_CMP_COLUMNS, seed=2)
        for name, dt in dtypes.items():
            step = fc.make_rainshaft_step_fn(data, sc_cfg.vel, sc_cfg.norms, nz=NZ,
                                             dz=sc_cfg.dz, dt=1.0, device=dev, dtype=dt, **kw)
            rfn = fc.make_rainshaft_rhs_fn(data, sc_cfg.vel, sc_cfg.norms, device=dev,
                                           dtype=dt, **kw)
            check(step.plan.instance == 2 and rfn.plan.instance == 2,
                  f"[{case}] does not select the reference tier")
            x = st.to(dev, dt)
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            for kind, fn, nrm in (("step", step, norm), ("rhs", rfn, torch.cat([norm, norm]))):
                got = fn(x) if kind == "step" else fn.soa(x)
                check(fn.launches == 1, f"{kind} wrapper did not count one launch")
                want = fn.plain(x)
                torch.cuda.synchronize()
                err, abs_err = row_scaled(got / nrm, want / nrm)
                finite = bool(torch.isfinite(got).all())
                print(f"phase 20 {kind} kernel [{case}] ({fn.route} {fn.unit.label}, flags "
                      f"{list(fn.unit.flags)}) vs twin {name} at [{data.spec.n_tot}, "
                      f"{N_CMP_COLUMNS * NZ}]: row-scaled {err:.3e} (tol {TOL[name]:.0e}), max "
                      f"abs {abs_err:.3e} (normalized), bit-identical {bool(torch.equal(got, want))}"
                      f", finite {finite} {card}")
                check(finite, f"arm {kind} kernel [{case}] {name} not finite")
                check(err < TOL[name], f"arm {kind} kernel [{case}] {name} vs twin {err:.3e}")
        # the f64 anchor: the kernel against the twin over 40 steps from the pulse
        config, step = wsa.build_case(case, NZ, dev, torch.float64)
        y = yt = wsa.initial_state(config, N_ANCHOR_COLUMNS, dev, torch.float64)
        for _ in range(N_FM_ANCHOR_STEPS):
            y, yt = step(y), step.plain(yt)
        aerr, _ = row_scaled(y, yt)
        flips = ""
        if data.spec.families[0] == M_:
            mn = torch.tensor(step.plan.mom_norms, dtype=torch.float64, device=dev)[:, None]
            flips = f", mono lanes across T/2 between them {mono_flips(y / mn, yt / mn, data)}"
        print(f"phase 20 [{case}] f64 anchor ({N_ANCHOR_COLUMNS} columns, {N_FM_ANCHOR_STEPS} "
              f"steps): kernel vs twin row-scaled {aerr:.3e} (tol {TOL['float64']:.0e}), "
              f"bit-identical {bool(torch.equal(y, yt))}{flips} {card}")
        check(bool(torch.isfinite(y).all()), f"[{case}] f64 anchor not finite")
        check(aerr < TOL["float64"], f"[{case}] f64 anchor {aerr:.3e}")
        del step
    torch.cuda.empty_cache()

    # the family matrix at 2^20 columns x 32 levels, f32
    smi_line = smi.splitlines()[0]
    n_cmp = N_CMP_COLUMNS * NZ
    for case in wsa.CASE_NAMES:
        rec, step, state0, timing = wsa.run_case(case, N_POD_COLUMNS, NZ, dev, FM_REPS, smi_line)
        n_launch = rec["launches"]
        check(n_launch == rec["steps_run"],
              f"[{case}] whole-step kernel launched {n_launch} times in {rec['steps_run']} steps")
        check(rec["finite"], f"[{case}] family-matrix state not finite")
        yk = timing["state"][:, :n_cmp]
        yt = state0[:, :n_cmp].contiguous()
        # the comparison's resolving power: the twin from a start one ulp away
        # (each entry times 1 - eps, 1 or 1 + eps, seeded)
        g = torch.Generator(device=dev).manual_seed(0)
        yp = yt * (1 + torch.finfo(torch.float32).eps * torch.randint(
            -1, 2, yt.shape, generator=g, device=dev).float())
        for _ in range(rec["n2"]):
            yt, yp = step.plain(yt), step.plain(yp)
        norm = torch.tensor(step.plan.mom_norms, dtype=torch.float32, device=dev)[:, None]
        err, abs_err = row_scaled(yk / norm, yt / norm)
        floor, _ = row_scaled(yp / norm, yt / norm)
        flips = ""
        if rec["families"][0] == "MONODISPERSE":
            flips = (f", mono lanes across T/2 between them "
                     f"{mono_flips(yk / norm, yt / norm, wsa.case_data(case)[0])}")
        plain_ms = _time_ms(lambda: step.plain(state0), 1)
        print(f"phase 20 family matrix [{case}] {N_POD_COLUMNS} x {NZ} f32 ({rec['instance']}, "
              f"{step.route}): "
              f"{rec['ms_per_step']:.4f} ms/step, {rec['column_updates_per_s']:.4e} "
              f"column-updates/s (n1 {rec['n1']}, n2 {rec['n2']}, median of {FM_REPS}), "
              f"launches {n_launch} in {rec['steps_run']} steps; first {N_CMP_COLUMNS} columns "
              f"after {rec['n2']} steps vs twin on the card: row-scaled {err:.3e} (tol "
              f"{TOL['float32']:.0e}), max abs {abs_err:.3e} (normalized), bit-identical "
              f"{bool(torch.equal(yk, yt))}{flips}; twin vs twin from a start one ulp "
              f"away {floor:.3e}; twin "
              f"{plain_ms:.4f} ms/step at [{step.plan.n_tot}, {N_POD_COLUMNS * NZ}]; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['ops_per_lane']:.2f} twin "
              f"operations per lane), share {rec['bound_share']} {card}")
        print(json.dumps(rec))
        check(err < TOL["float32"], f"[{case}] family matrix vs twin {err:.3e}")
        kernels.append({"name": f"rainshaft_step[{case}]", "route": "cuda", **kernel_source(step),
                        "replaces": B1_REPLACES, "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err,
                        "ms": rec["ms_per_step"], "plain_ms": plain_ms,
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": None})
        del step, state0, timing, yk, yt, yp
        torch.cuda.empty_cache()
    print(f"phase 20 seconds {time.perf_counter() - t:.3f}")


def phase_21(dev, card, b1_ms, num_ms, kernels):
    """Phase 21: every chain kernel of B6 against its twin at K1 links over
    the full element set (f32 and f64), the timed sweep (its launch counts
    zeroed just before and read just after), the fit in both types, the
    floor check, and the class model of B1 `fixed2gamma` and B5 beside
    their times of phases 6 and 14; appends one `kernels` entry per chain
    and type. Returns the class model's time by kernel ("B1", "B5")."""
    import torch

    from cloudy_tpu_torch import bench, harness
    from cloudy_tpu_torch.ops import op_chains as oc
    from cloudy_tpu_torch.tools import op_microbench as om
    from cloudy_tpu_torch.tools import opcount

    t = time.perf_counter()

    def held(rec):
        if rec["vs"] == "twin":
            return f" (tol {rec['tol']:.3e})"
        return (f", kernel vs f64 twin {rec['f64_rel_err']:.3e} (tol {rec['tol']:.3e}), "
                f"f32 twin vs f64 twin {rec['twin_f64_rel_err']:.3e}")

    def show(rec):
        print(f"phase 21 chain [{rec['chain']}, {rec['dtype']}]: E {rec['E']} "
              f"({rec['columns']} columns x ILP {rec['ilp']}), K1 {rec['k1']} "
              f"{rec['k1_ms']:.4f} ms, K2 {rec['k2']} {rec['k2_ms']:.4f} ms: "
              f"{rec['sec_per_elem_link']:.4e} s per element per link; kernel vs twin at "
              f"K1 relative {rec['max_rel_err']:.3e}{held(rec)}; "
              f"twin at K2 {rec['plain_k2_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) {card}")

    records, fits, samples = om.sweep((torch.float32, torch.float64), dev, plain=True,
                                      on_record=show)
    for rec in records:
        check(rec["launches"] > 0, f"chain {rec['chain']} {rec['dtype']} never launched")
        if "floor_sec" in rec:
            print(f"phase 21 floor [{rec['chain']}, {rec['dtype']}]: "
                  f"{rec['sec_per_elem_link']:.4e} >= {rec['floor_sec']:.4e} s {card}")
    print(f"phase 21 launch counts of the sweep: "
          f"{ {r['chain'] + '/' + r['dtype']: r['launches'] for r in records} }")
    for tag, f in fits.items():
        for ln in om.class_lines(tag, f):
            print(f"phase 21 {ln} {card}")
    print(f"phase 21 nvidia-smi during the sweep (sm clock, power draw): {samples}")
    # additivity on real code: each bundle's link priced by the primitive
    # classes from its twin's operations, against its measured cost
    for rec in records:
        if rec["chain"] in oc.BUNDLES:
            ops = om.link_ops(rec["chain"])
            pred = om.predict_ms(ops, 1, fits[rec["dtype"]]["classes"]) * 1e-3
            print(f"phase 21 class model of the [{rec['chain']}, {rec['dtype']}] link: "
                  f"{pred:.4e} s per element from {rec['ops_per_elem_link']:.2f} twin "
                  f"operations (f32 twin), measured {rec['sec_per_elem_link']:.4e} "
                  f"({pred / rec['sec_per_elem_link']:.4f}) {card}")

    # the class model: the twins' operations by class (per lane) priced at
    # the f32 class costs, beside the measured times of phases 6 and 14
    classes = fits["f32"]["classes"]
    class_model = {}
    small = harness.SCENARIOS["pod_ensemble"](n_columns=8, device=dev)
    nfn = bench.numerical_fn(dev)
    boxes = torch.as_tensor(bench.numerical_moments(64).T.copy(), dtype=torch.float32,
                            device=dev)
    for label, twin, x, lanes, measured in (
            ("B1 fixed2gamma step [6, 2^25]", small["step"].plain, small["state0"],
             N_POD_COLUMNS * NZ, b1_ms),
            (f"B5 numerical RHS [6, {bench.NUMERICAL_COLUMNS}]", nfn.plain, boxes,
             bench.NUMERICAL_COLUMNS, num_ms)):
        counts = opcount.count_ops_by_class(twin, x)
        n = x.shape[1]
        per_lane = {c: counts[c] / n for c in oc.PRIMITIVE_CLASSES}
        per_lane["predicate"] = {o: v / n for o, v in counts["predicate"].items()}
        other = {o: v / n for o, v in counts["other"].items()}
        total = opcount.count_ops(twin, x) / n
        pred = om.predict_ms(per_lane, lanes, classes)
        print(f"phase 21 class model {label}: predicted {pred:.4f} ms against "
              f"{measured:.4f} ms measured in this call ({pred / measured:.4f}); operations "
              f"per lane { {c: round(v, 2) for c, v in per_lane.items() if c != 'predicate'} }, "
              f"predicates {round(sum(per_lane['predicate'].values()), 2)} (priced as add), "
              f"unpriced {other} ({sum(other.values()) / total:.4f} of {total:.2f}) {card}")
        check(pred > 0.0, f"class model of {label} is not positive")
        class_model[label.split()[0]] = pred
    del small, nfn, boxes

    for rec in records:
        kernels.append({
            "name": f"op_chain[{rec['chain']}, {rec['dtype']}]", "route": "cuda",
            "source": CHAIN_SOURCE, "replaces": B6_REPLACES, "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "max_rel_err": rec["max_rel_err"],
            "ms": rec["k2_ms"], "plain_ms": rec["plain_k2_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    torch.cuda.empty_cache()
    print(f"phase 21 seconds {time.perf_counter() - t:.3f}")
    return class_model


def phase_22(dev, card, kernels, bound):
    """Phase 22 (B-cover): an exponential-only and a three-mode fast-tier
    configuration through B3, B4 and B1 (kernel against twin at 4,096
    columns x 32 levels, f32 and f64; then their times at 2^20 x 32, f32),
    B5 with three modes at [8, 262144] and B5 in f64 at [6, 262144], each
    against its twin; appends their `kernels` entries."""
    import numpy as np
    import torch

    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    t = time.perf_counter()
    E, G, L = Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    # per family the column's moment amplitudes: exponential (N, N x), gamma
    # k = 1, lognormal sigma = 0.5 (M2 = N x^2 e^(sigma^2))
    amps = {E: [1e8, 1e-2], G: [1e6, 1e-3, 2e-12], L: [1e7, 1e-3, 1.2840254166877414e-13]}
    for name in COVERS:
        spec, data, cfg = cover_case(name)
        fams = spec.families
        ic = np.concatenate([rs.initial_condition(cfg.z, amps[f]) for f in fams], axis=-1)
        rng = np.random.default_rng(22)
        amp = np.concatenate([rng.uniform(0.5, 1.5, (N_CMP_COLUMNS, 1, 1)).repeat(n, axis=2)
                              for n in spec.nprogmoms], axis=2)
        st = rs.to_soa(torch.as_tensor(np.tile(ic[None], (N_CMP_COLUMNS, 1, 1)) * amp))
        errs_f32 = None
        for dname, dt in dtypes.items():
            kw = dict(device=dev, dtype=dt)
            step = fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz,
                                             dt=1.0, **kw)
            rhs = fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, **kw)
            coal = fc.make_coal_fn(data, **kw)
            x = st.to(dev, dt).contiguous()
            norm = torch.tensor(step.plan.mom_norms, dtype=dt, device=dev)[:, None]
            xn = (x / norm).contiguous()
            errs = {
                "step": row_scaled(step(x) / norm, step.plain(x) / norm),
                "rhs": row_scaled(rhs.soa(x) / torch.cat([norm, norm]),
                                  rhs.plain(x) / torch.cat([norm, norm])),
                "coal": row_scaled(coal.soa(xn), coal.plain(xn)),
            }
            print(f"phase 22 [{name}] {spec.n_modes} modes, instance {step.plan.instance}: "
                  f"kernel vs twin {dname} at {N_CMP_COLUMNS} x {NZ}, row-scaled (normalized) "
                  + ", ".join(f"{k} {e[0]:.3e}" for k, e in errs.items())
                  + f" (tol {TOL[dname]:.0e}) {card}")
            for k, (err, _) in errs.items():
                check(err < TOL[dname], f"[{name}] {k} kernel vs twin {dname} {err:.3e}")
            errs_f32 = errs_f32 or errs
        # times at 2^20 x 32, f32
        kw = dict(device=dev, dtype=torch.float32)
        step = fc.make_rainshaft_step_fn(data, cfg.vel, cfg.norms, nz=NZ, dz=cfg.dz,
                                         dt=1.0, **kw)
        rhs = fc.make_rainshaft_rhs_fn(data, cfg.vel, cfg.norms, **kw)
        coal = fc.make_coal_fn(data, **kw)
        col = torch.as_tensor(ic.T.copy(), dtype=torch.float32, device=dev)
        big = col.repeat(1, N_POD_COLUMNS).contiguous()
        lanes = big.shape[1]
        norm = torch.tensor(step.plan.mom_norms, dtype=torch.float32, device=dev)[:, None]
        bign = (big / norm).contiguous()
        small = st[:, :8 * NZ].to(dev, torch.float32).contiguous()
        step(small), rhs.soa(small), coal.soa((small / norm).contiguous())
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def window(y):
            start.record()
            for _ in range(N_COVER_STEPS):
                y = step(y)
            end.record()
            end.synchronize()
            return y, start.elapsed_time(end) / N_COVER_STEPS

        # B1 from two windows in a row: the first allocates the steps' outputs at
        # this size (the allocator was emptied after the last case) inside its
        # window, the second, whose time is kept, does not
        y, cold_ms = window(big)
        for fn in (step, rhs, coal):
            fn.launches = 0
        y, step_ms = window(y)
        rhs_ms = _time_ms(lambda: rhs.soa(big), N_COVER_STEPS - 1)
        coal_ms = _time_ms(lambda: coal.soa(bign), N_COVER_STEPS - 1)
        counts = {"step": step.launches, "rhs": rhs.launches, "coal": coal.launches}
        finite = bool(torch.isfinite(y).all())
        print(f"phase 22 [{name}] at {N_POD_COLUMNS} x {NZ} f32 (B1 and B4 {step.route}, B3 "
              f"{coal.route}): B1 {step_ms:.4f} ms/step "
              f"({N_POD_COLUMNS / step_ms * 1e3:.4e} column-updates/s, finite {finite}; the "
              f"window before it, with the outputs' allocation, {cold_ms:.4f}), "
              f"B4 {rhs_ms:.4f} ms, B3 {coal_ms:.4f} ms per launch; launches {counts} {card}")
        check(finite, f"[{name}] state after {2 * N_COVER_STEPS} steps not finite")
        check(all(v == N_COVER_STEPS for v in counts.values()), f"[{name}] launches {counts}")
        del y
        plain = {"step": _time_ms(lambda: step.plain(big), 1),
                 "rhs": _time_ms(lambda: rhs.plain(big), 1),
                 "coal": _time_ms(lambda: coal.plain(bign), 1)}
        sn = (small / norm).contiguous()
        for kk, kname, replaces, twin, x_small, rows_out, ms in (
                ("step", "rainshaft_step", B1_REPLACES, step.plain, small, spec.n_tot, step_ms),
                ("rhs", "rainshaft_rhs", B4_REPLACES, rhs.plain, small, 2 * spec.n_tot, rhs_ms),
                ("coal", "coal_rhs", B3_REPLACES, coal.plain, sn, spec.n_tot, coal_ms)):
            kernels.append({"name": f"{kname}[{name}]", "route": "cuda",
                            **kernel_source({"step": step, "rhs": rhs, "coal": coal}[kk]),
                            "replaces": replaces, "launches": counts[kk],
                            "max_abs_err": errs_f32[kk][1], "max_row_scaled_err": errs_f32[kk][0],
                            "ms": ms, "plain_ms": plain[kk],
                            **bound(f"{kname}[{name}]", twin, x_small, lanes, spec.n_tot,
                                    rows_out)})
        del big, bign, step, rhs, coal
        torch.cuda.empty_cache()

    # B5: three modes at [8, 262144] (f32) and the bench's two modes in f64
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(bench.NORMS)
    n_box = bench.NUMERICAL_COLUMNS
    rng = np.random.default_rng(23)
    three = SpectrumSpec((E, G, L))
    par = np.stack([np.stack([rng.uniform(10, 200, n_box), rng.uniform(*p1, n_box),
                              rng.uniform(*p2, n_box)], -1)
                    for p1, p2 in (((0.05, 5.0), (0.5, 5.0)), ((0.05, 5.0), (0.5, 5.0)),
                                   ((-1.0, 1.0), (0.3, 1.0)))], 1)
    mom3 = pd.get_moments(three, torch.as_tensor(par)).numpy().T.copy()
    for label, vspec, mom_np, dt in (
            ("3 modes exp+gamma+lognormal, f32", three, mom3, torch.float32),
            ("2 gamma modes, f64", SpectrumSpec((G, G)),
             bench.numerical_moments().T.copy(), torch.float64)):
        fn = nc.make_numerical_fn(vspec, kf, device=dev, dtype=dt)
        x = torch.as_tensor(mom_np, dtype=dt, device=dev)
        fn.soa(x[:, :64].contiguous())
        torch.cuda.synchronize()
        fn.launches = 0
        ms = _time_ms(lambda: fn.soa(x), N_COVER_STEPS - 1)
        launches = fn.launches
        got = fn.soa(x)
        want = fn.plain(x, chunk=NUM_CHUNK)
        err, abs_err = row_scaled(got, want)
        tol = NUM_TOL["float64" if dt == torch.float64 else "float32"]
        plain_ms = _time_ms(lambda: fn.plain(x, chunk=NUM_CHUNK), 1)
        print(f"phase 22 numerical kernel [{label}] at [{vspec.n_tot}, {n_box}]: "
              f"{ms:.4f} ms per launch (launches {launches}), twin {plain_ms:.4f} ms; kernel "
              f"vs twin row-scaled {err:.3e} (tol {tol:.0e}), max abs {abs_err:.3e}, finite "
              f"{bool(torch.isfinite(got).all())} {card}")
        check(bool(torch.isfinite(got).all()), f"numerical [{label}] not finite")
        check(err < tol, f"numerical [{label}] vs twin {err:.3e}")
        check(launches == N_COVER_STEPS, f"numerical [{label}] launches {launches}")
        kernels.append({"name": f"numerical_rhs[{label}]", "route": "cuda",
                        **kernel_source(fn), "replaces": B5_REPLACES, "launches": launches,
                        "max_abs_err": abs_err, "max_row_scaled_err": err, "ms": ms,
                        "plain_ms": plain_ms,
                        **bound(f"numerical_rhs[{label}]", fn.plain, x[:, :64].contiguous(),
                                n_box, vspec.n_tot, vspec.n_tot, f64=dt == torch.float64)})
        del fn, x, got, want
        torch.cuda.empty_cache()
    print(f"phase 22 seconds {time.perf_counter() - t:.3f}")


def phase_23(dev, card, gen_records):
    """Phase 23: the generated whole step (B1) and fused RHS (B4) of each pod
    variant against their table-driven fast instances, in this call: each
    unit's `ptxas` line (f32: 0 B of stack and of spills), the SASS counts
    of LDL, STL, LDS, STS, BAR and SHFL, resident blocks per SM, both
    kernels against the twin at 4,096 columns x 32 levels (f32 and f64);
    then ms per step of B1 at 2^20 x 32 (chains of N_GEN_STEPS steps from
    the pod's initial state) and per launch of B4 at [6, 2^25] (f32), in
    turns table, generated, generated, table. `gen_records`: phase 2's build
    records by unit label (their nvcc seconds)."""
    import json

    import torch

    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch.tools import yardstick

    t = time.perf_counter()
    dtypes = {"float32": torch.float32, "float64": torch.float64}

    def show(r):
        pt, sass = r["ptxas"], r["sass"]
        return (f"ptxas {pt.get('registers')} registers, {pt.get('stack')} B stack, "
                f"{pt.get('spill_stores')}/{pt.get('spill_loads')} B spill stores/loads; SASS "
                + " ".join(f"{k} {sass.get(k)}" for k in ("LDL", "STL", "LDS", "STS", "BAR",
                                                           "SHFL"))
                + f" of {sass.get('total')} instructions; {r['blocks_per_sm']} blocks/SM")

    for variant in yardstick.VARIANTS:
        for kind in ("step", "rhs"):
            label = "B1 whole step" if kind == "step" else "B4 fused RHS"
            for name, dt in dtypes.items():
                gen, table = yardstick.make_fns(variant, kind, dev, dt)
                rec = gen_records.get(gen.unit.label) or _build.build_generated([gen.unit])[0]
                g = yardstick.gen_report(gen.unit, rec)
                tb = yardstick.table_report(kind, dt, gen.plan.arms, gen.plan)
                gerr, gfin = yardstick.check_vs_twin(gen, kind, variant, dev, dt)
                terr, tfin = yardstick.check_vs_twin(table, kind, variant, dev, dt)
                print(f"phase 23 [{variant}, {label}, {name}] generated {gen.unit.label} "
                      f"({g['threads']} threads, {'shuffle' if g['shfl'] else 'no'} stencil, "
                      f"nvcc {g['nvcc_s']:.3f} s{', rebuilt' if g['retried'] else ''}): "
                      f"{show(g)} | table-driven: {show(tb)} | vs "
                      f"twin at [6, {N_CMP_COLUMNS * NZ}] (normalized): generated {gerr:.3e}, "
                      f"table-driven {terr:.3e} (tol {TOL[name]:.0e}) {card}")
                print(json.dumps({"phase": 23, "variant": variant, "kind": kind, "dtype": name,
                                  "unit": gen.unit.label, "generated": g, "table": tb,
                                  "gen_vs_twin": gerr, "table_vs_twin": terr}))
                check(gfin and tfin, f"[{variant}, {kind}, {name}] not finite")
                check(gerr < TOL[name] and terr < TOL[name],
                      f"[{variant}, {kind}, {name}] vs twin: generated {gerr:.3e}, table {terr:.3e}")
                if dt == torch.float32:
                    pt = g["ptxas"]
                    check(pt.get("stack") == 0 and pt.get("spill_stores") == 0
                          and pt.get("spill_loads") == 0,
                          f"[{variant}, {kind}] generated f32 stack or spills: {pt}")
                    check(g["sass"].get("LDL") == 0 and g["sass"].get("STL") == 0,
                          f"[{variant}, {kind}] generated f32 local memory: {g['sass']}")
                if kind == "step" and g["shfl"]:
                    check(g["sass"].get("BAR") == 0, f"[{variant}] shuffle step has barriers")
            x = yardstick.pod_state(variant, N_POD_COLUMNS, dev, torch.float32)
            gen, table = yardstick.make_fns(variant, kind, dev, torch.float32)
            n = N_GEN_STEPS if kind == "step" else N_GEN_RHS
            (t_tab, t_gen), raw = yardstick.time_turns([table, gen], kind, x, n)
            unit = "ms/step" if kind == "step" else "ms per launch"
            print(f"phase 23 [{variant}, {label}] at [6, {x.shape[1]}] f32: table-driven "
                  f"{t_tab:.4f} {unit}, generated {t_gen:.4f} {unit} ({t_tab / t_gen:.3f}x; "
                  f"turns table {[round(v, 4) for v in raw[0]]}, generated "
                  f"{[round(v, 4) for v in raw[1]]}, {n} per turn); {time.perf_counter() - t:.3f} "
                  f"s into the phase {card}")
            del x, gen, table
            torch.cuda.empty_cache()
    print(f"phase 23 seconds {time.perf_counter() - t:.3f}")


def phase_24(dev, card, log, b1_ms, gen_records, class_model):
    """Phase 24: B3 and B5 as redesigned, each against what it replaces, in
    this call:
    (a) B3's generated kernel of each pod variant against its table-driven
        fast instance (the wrapper's private `_table`): `ptxas`, SASS counts,
        blocks per SM, both against the twin at 2^20 boxes (f32) and 65,536
        (f64) of `yardstick.coal_moments`, ms per launch at 2^20 boxes in
        turns table, generated, generated, table (f32); the same at
        B-cover's (E, E) and (E, L, G) on phase 22's 2^25 lanes (f32);
    (b) B3's reference tier at the `rainshaft_128` hook's configuration
        (fixed Simpson grid, series/CF) with a warp per box against a thread
        per box (the private `_layout`), f64 and f32 at B = 128 to 262,144:
        both against the twin, two warp launches bit for bit, ms per launch
        in turns thread, warp, warp, thread, and the layout `coal_layout`
        takes at each B on this card; then the same at 2^20 boxes (f32) for
        bench.py's three reference switches and the mono and lognormal-Φ-grid
        arms;
    (c) B5's `quad_kernel` against its twin with each kernel function at
        [6, 262144] (f32 and f64); against the body it replaced (`_direct`)
        at the numerical bench's [6, 262144] (Long, f32), at B-cover's
        E + G + L [8, 262144] (f32) and at [6, 262144] in f64: both against
        the twin (in chunks), ms per launch in turns direct, quad, quad,
        direct, with the `ptxas` line and SASS counts of each instance and
        phase 21's class-model time of the old body's operation mix;
    and the unscaled B1 `fixed2gamma` time of phase 6 in this call beside
    them. `gen_records`: phase 2's build records by unit label; `class_model`:
    phase 21's predictions."""
    import json

    import numpy as np
    import torch

    from cloudy_tpu_torch import bench, harness
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.spec import Family, SpectrumSpec, get_moments_normalizing_factors
    from cloudy_tpu_torch.tools import whole_step_ablation as wsa
    from cloudy_tpu_torch.tools import yardstick

    t = time.perf_counter()
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    print(f"phase 24 unscaled B1 fixed2gamma in this call (phase 6, generated): {b1_ms:.4f} "
          f"ms/step (recorded: 6.09-6.18) {card}")

    def show(r):
        pt, sass = r["ptxas"], r["sass"]
        return (f"ptxas {pt.get('registers')} registers, {pt.get('stack')} B stack, "
                f"{pt.get('spill_stores')}/{pt.get('spill_loads')} B spill stores/loads; SASS "
                + " ".join(f"{k} {sass.get(k)}" for k in ("LDL", "STL", "LDS", "STS", "BAR",
                                                           "SHFL", "CALL"))
                + f" of {sass.get('total')} instructions; {r['blocks_per_sm']} blocks/SM")

    # (a) B3 fast tier: generated against table-driven
    for variant in yardstick.VARIANTS:
        for name, dt in dtypes.items():
            gen, table = yardstick.make_fns(variant, "coal", dev, dt)
            check(gen.route == "generated", f"[{variant}] B3 does not take the generated route")
            rec = gen_records.get(gen.unit.label) or _build.build_generated([gen.unit])[0]
            g = yardstick.gen_report(gen.unit, rec)
            tb = yardstick.table_report("coal", dt, gen.plan.arms, gen.plan)
            n = bench.BENCH_COLUMNS if dt == torch.float32 else N_REF_BOXES
            x = yardstick.coal_moments(variant, n, dev, dt, seed=24)
            want = gen.plain(x)
            got = gen.soa(x)
            gerr, gabs = row_scaled(got, want)
            terr, _ = row_scaled(table.soa(x), want)
            finite = bool(torch.isfinite(got).all())
            print(f"phase 24 [{variant}, B3 coal RHS, {name}] generated {gen.unit.label} "
                  f"(nvcc {g['nvcc_s']:.3f} s{', rebuilt' if g['retried'] else ''}): {show(g)} | "
                  f"table-driven: {show(tb)} | vs twin at [{x.shape[0]}, {n}]: generated "
                  f"{gerr:.3e} (max abs {gabs:.3e}), table-driven {terr:.3e} (tol "
                  f"{TOL[name]:.0e}), finite {finite} {card}")
            print(json.dumps({"phase": 24, "variant": variant, "kind": "coal", "dtype": name,
                              "unit": gen.unit.label, "generated": g, "table": tb,
                              "gen_vs_twin": gerr, "table_vs_twin": terr, "boxes": n}))
            check(finite, f"[{variant}, coal, {name}] generated not finite")
            check(gerr < TOL[name] and terr < TOL[name],
                  f"[{variant}, coal, {name}] vs twin: generated {gerr:.3e}, table {terr:.3e}")
            if dt == torch.float32:
                pt = g["ptxas"]
                check(pt.get("stack") == 0 and pt.get("spill_stores") == 0
                      and pt.get("spill_loads") == 0,
                      f"[{variant}, coal] generated f32 stack or spills: {pt}")
                check(g["sass"].get("LDL") == 0 and g["sass"].get("STL") == 0,
                      f"[{variant}, coal] generated f32 local memory: {g['sass']}")
                (t_tab, t_gen), raw = yardstick.time_turns([table, gen], "coal", x, N_GEN_RHS)
                print(f"phase 24 [{variant}, B3 coal RHS] at [{x.shape[0]}, {n}] f32: "
                      f"table-driven {t_tab:.4f} ms, generated {t_gen:.4f} ms per launch "
                      f"({t_tab / t_gen:.3f}x; turns table {[round(v, 4) for v in raw[0]]}, "
                      f"generated {[round(v, 4) for v in raw[1]]}, {N_GEN_RHS} per turn) {card}")
            del gen, table, x, want, got
            torch.cuda.empty_cache()

    # B-cover's (E, E) and (E, L, G) at phase 22's 2^25 lanes (the pod column, normalized)
    for cover in COVERS:
        spec, data, cfg = cover_case(cover)
        amps = {Family.EXPONENTIAL: [1e8, 1e-2], Family.GAMMA: [1e6, 1e-3, 2e-12],
                Family.LOGNORMAL: [1e7, 1e-3, 1.2840254166877414e-13]}
        ic = np.concatenate([rs.initial_condition(cfg.z, amps[f]) for f in spec.families],
                            axis=-1)
        norm = np.asarray(get_moments_normalizing_factors(spec.nprogmoms, cfg.norms))
        x = torch.as_tensor((ic / norm).T.copy(), dtype=torch.float32,
                            device=dev).repeat(1, N_POD_COLUMNS).contiguous()
        gen = fc.make_coal_fn(data, device=dev, dtype=torch.float32)
        table = fc.CoalFn(gen.plan, dev, torch.float32, _table=True)
        want = gen.plain(x)
        errs = [row_scaled(fn.soa(x), want)[0] for fn in (gen, table)]
        (t_tab, t_gen), raw = yardstick.time_turns([table, gen], "coal", x, N_COVER_STEPS)
        print(f"phase 24 [{cover}, B3 coal RHS] at [{x.shape[0]}, {x.shape[1]}] f32: "
              f"table-driven {t_tab:.4f} ms, generated {t_gen:.4f} ms per launch "
              f"({t_tab / t_gen:.3f}x; turns table {[round(v, 4) for v in raw[0]]}, generated "
              f"{[round(v, 4) for v in raw[1]]}); vs twin: generated {errs[0]:.3e}, "
              f"table-driven {errs[1]:.3e} (tol {TOL['float32']:.0e}) {card}")
        check(max(errs) < TOL["float32"], f"[{cover}, coal] vs twin {errs}")
        del x, gen, table, want
        torch.cuda.empty_cache()
    print(f"phase 24 (a) seconds {time.perf_counter() - t:.3f}")

    # (b) B3 reference tier: a warp per box against a thread per box
    sc = harness.SCENARIOS["rainshaft_128"](device=dev, hook=True)
    data = sc["data"]
    rng = np.random.default_rng(24)
    big = max(REF_LAYOUT_BOXES)
    par = np.stack([np.stack([rng.uniform(10, 200, big), rng.uniform(0.05, 5.0, big),
                              rng.uniform(0.5, 5.0, big)], -1) for _ in range(2)], axis=1)
    mom_np = pd.get_moments(data.spec, torch.as_tensor(par)).numpy().T.copy()
    mom_np[:, 5] = 0.0  # an empty box
    for name, dt in dtypes.items():
        auto = fc.make_coal_fn(data, device=dev, dtype=dt)
        check(auto.plan.ref, "the rainshaft_128 configuration is not at the reference tier")
        thread = fc.CoalFn(auto.plan, dev, dt, _layout="thread")
        warp = fc.CoalFn(auto.plan, dev, dt, _layout="warp")
        n_sm, slots = auto.slots()
        print(f"phase 24 [B3 reference, {name}] {n_sm} SMs x {slots} resident threads of the "
              f"thread-per-box instance: coal_layout takes a warp per box up to B = "
              f"{n_sm * slots} {card}")
        for n in REF_LAYOUT_BOXES:
            x = torch.as_tensor(mom_np[:, :n], dtype=dt, device=dev).contiguous()
            want = warp.plain(x)
            got = warp.soa(x)
            werr, wabs = row_scaled(got, want)
            terr, _ = row_scaled(thread.soa(x), want)
            same = bool(torch.equal(got, warp.soa(x)))
            finite = bool(torch.isfinite(got).all())
            reps = max(2, min(50, 2 ** 17 // n))
            (t_thr, t_warp), raw = yardstick.time_turns([thread, warp], "coal", x, reps)
            print(f"phase 24 [B3 reference, rainshaft_128 configuration, {name}] B = {n}: a warp "
                  f"per box {t_warp:.4f} ms, a thread per box {t_thr:.4f} ms per launch "
                  f"({t_thr / t_warp:.3f}x; turns thread {[round(v, 4) for v in raw[0]]}, warp "
                  f"{[round(v, 4) for v in raw[1]]}, {reps} per turn); coal_layout takes "
                  f"{auto.layout(n)}; vs twin: warp {werr:.3e} (max abs {wabs:.3e}), thread "
                  f"{terr:.3e} (tol {TOL[name]:.0e}); two warp launches bit-identical {same}, "
                  f"finite {finite} {card}")
            print(json.dumps({"phase": 24, "kind": "coal_reference_layout", "dtype": name,
                              "boxes": n, "warp_ms": t_warp, "thread_ms": t_thr,
                              "warp_turns": raw[1], "thread_turns": raw[0],
                              "layout": auto.layout(n), "warp_vs_twin": werr,
                              "thread_vs_twin": terr}))
            check(finite and same, f"[B3 reference, warp, {name}, B = {n}] not finite or not "
                  "bit-identical")
            check(werr < TOL[name] and terr < TOL[name],
                  f"[B3 reference, {name}, B = {n}] vs twin: warp {werr:.3e}, thread {terr:.3e}")
            del x, want, got
        del auto, thread, warp
    del sc
    # the reference rows at 2^20 boxes (f32): bench.py's three reference switches (phase 19)
    # and the mono and lognormal-Φ-grid arms' chains (phase 20), the layout coal_layout
    # takes against the other
    x_bench = torch.as_tensor(bench.bench_moments(bench.BENCH_COLUMNS).T.copy(),
                              dtype=torch.float32, device=dev)
    rows = {f"bench f2_exact={e} gl_nodes={g}": (bench.coal_fn(dev, f2_exact=bool(e),
                                                               gl_nodes=g), x_bench)
            for e, g in BENCH_SWITCHES if (e, g) != (1, 12)}
    for arm, case in (("mono", "mono-gamma-closed"), ("lognorm_grid", "lognorm-gamma-grid")):
        data, kw = wsa.case_data(case)
        rows[arm] = (fc.make_coal_fn(data, device=dev, dtype=torch.float32, **kw),
                     torch.as_tensor(arm_moments(data.spec.families, bench.BENCH_COLUMNS,
                                                 seed=0), dtype=torch.float32, device=dev))
    for label, (auto, x) in rows.items():
        fns = [fc.CoalFn(auto.plan, dev, torch.float32, _layout=lay) for lay in ("thread", "warp")]
        want = auto.plain(x)
        errs = [row_scaled(fn.soa(x), want)[0] for fn in fns]
        (t_thr, t_warp), raw = yardstick.time_turns(fns, "coal", x, 3)
        grid = fc.F2_GRID in auto.plan.f2_kind
        print(f"phase 24 [B3 reference, {label}, float32] B = {x.shape[1]} ({'a' if grid else 'no'}"
              f" grid F2): a warp per box {t_warp:.4f} ms, a thread per box {t_thr:.4f} ms per "
              f"launch ({t_thr / t_warp:.3f}x; turns thread {[round(v, 4) for v in raw[0]]}, warp "
              f"{[round(v, 4) for v in raw[1]]}); coal_layout takes {auto.layout(x.shape[1])}; vs "
              f"twin: thread {errs[0]:.3e}, warp {errs[1]:.3e} (tol {TOL['float32']:.0e}) {card}")
        check(max(errs) < TOL["float32"], f"[B3 reference, {label}] vs twin {errs}")
        del auto, fns, want
    del rows, x_bench, x
    torch.cuda.empty_cache()
    print(f"phase 24 (b) seconds {time.perf_counter() - t:.3f}")

    # (c) B5: quad_kernel against numerical_kernel
    lines = ptxas_summary(log)
    for ln in lines:
        if ln.startswith(("quad_kernel<", "numerical_kernel<")) and "kernel function 3" in ln:
            print(f"phase 24 ptxas (phase 2): {ln}")
    so = _build.library_path()
    for fname, counts in _build.sass_counts(so).items():
        if re.search(r"(quad|numerical)_kernelI[fd]Li[23]ELi3E", fname):
            print(f"phase 24 SASS {fname}: "
                  + " ".join(f"{k} {v}" for k, v in counts.items() if k != "total")
                  + f" of {counts['total']} instructions")
    n_box = bench.NUMERICAL_COLUMNS
    # each kernel function at the bench's [6, 262144] (two gamma modes, default budgets)
    G2 = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    for kname, kfun in (("constant", K.ConstantKernelFunction(1e-3)),
                        ("linear", K.LinearKernelFunction(5e-3)),
                        ("hydro", K.HydrodynamicKernelFunction(1e-2)),
                        ("long", K.LongKernelFunction(2.0, 1e-3, 5e-3))):
        errs = {}
        for name, dt in dtypes.items():
            fn = nc.make_numerical_fn(G2, kfun, device=dev, dtype=dt)
            x = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=dt, device=dev)
            got = fn.soa(x)
            errs[name] = row_scaled(got, fn.plain(x, chunk=NUM_CHUNK))[0]
            check(bool(torch.isfinite(got).all()), f"[B5 {kname}, {name}] not finite")
            del fn, x, got
        print(f"phase 24 [B5 {kname}, 2 gamma modes] quad_kernel vs twin at [6, {n_box}]: f32 "
              f"{errs['float32']:.3e} (tol {NUM_TOL['float32']:.0e}), f64 {errs['float64']:.3e} "
              f"(tol {NUM_TOL['float64']:.0e}) {card}")
        check(all(errs[k] < NUM_TOL[k] for k in errs), f"[B5 {kname}] vs twin {errs}")
    torch.cuda.empty_cache()
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78).normalized(bench.NORMS)
    rng = np.random.default_rng(23)
    E, G, L = Family.EXPONENTIAL, Family.GAMMA, Family.LOGNORMAL
    three = SpectrumSpec((E, G, L))
    par = np.stack([np.stack([rng.uniform(10, 200, n_box), rng.uniform(*p1, n_box),
                              rng.uniform(*p2, n_box)], -1)
                    for p1, p2 in (((0.05, 5.0), (0.5, 5.0)), ((0.05, 5.0), (0.5, 5.0)),
                                   ((-1.0, 1.0), (0.3, 1.0)))], 1)
    mom3 = pd.get_moments(three, torch.as_tensor(par)).numpy().T.copy()
    for label, vspec, mom, dt in (
            ("bench: 2 gamma modes, Long, f32", SpectrumSpec((G, G)),
             bench.numerical_moments().T.copy(), torch.float32),
            ("B-cover: E + G + L, Long, f32", three, mom3, torch.float32),
            ("B-cover: 2 gamma modes, Long, f64", SpectrumSpec((G, G)),
             bench.numerical_moments().T.copy(), torch.float64)):
        quad = nc.make_numerical_fn(vspec, kf, device=dev, dtype=dt)
        direct = nc.NumericalFn(quad.plan, dev, dt, _direct=True)
        x = torch.as_tensor(mom, dtype=dt, device=dev)
        want = quad.plain(x, chunk=NUM_CHUNK)
        qerr, qabs = row_scaled(quad.soa(x), want)
        derr, _ = row_scaled(direct.soa(x), want)
        tol = NUM_TOL["float64" if dt == torch.float64 else "float32"]
        (t_dir, t_quad), raw = yardstick.time_turns([direct, quad], "coal", x, 5)
        model = class_model.get("B5") if vspec.n_modes == 2 and dt == torch.float32 else None
        print(f"phase 24 [B5 {label}] at [{vspec.n_tot}, {n_box}]: quad_kernel {t_quad:.4f} ms, "
              f"numerical_kernel {t_dir:.4f} ms per launch ({t_dir / t_quad:.3f}x; turns direct "
              f"{[round(v, 4) for v in raw[0]]}, quad {[round(v, 4) for v in raw[1]]}, 5 per "
              f"turn); vs twin: quad {qerr:.3e} (max abs {qabs:.3e}), direct {derr:.3e} (tol "
              f"{tol:.0e})" + (f"; class model of the old body's operations (phase 21) "
                               f"{model:.4f} ms" if model else "") + f" {card}")
        print(json.dumps({"phase": 24, "kind": "numerical", "label": label, "quad_ms": t_quad,
                          "direct_ms": t_dir, "quad_turns": raw[1], "direct_turns": raw[0],
                          "quad_vs_twin": qerr, "direct_vs_twin": derr}))
        check(bool(torch.isfinite(want).all()), f"[B5 {label}] twin not finite")
        check(qerr < tol and derr < tol,
              f"[B5 {label}] vs twin: quad {qerr:.3e}, direct {derr:.3e}")
        del quad, direct, x, want
        torch.cuda.empty_cache()
    print(f"phase 24 seconds {time.perf_counter() - t:.3f}")


def four_mode_state(n_cols, seed=None):
    """The four-gamma-mode column's physical state [12, n_cols · 32]: each
    mode's top hat (`rainshaft.initial_condition`) with the number and mean
    mass of FOUR_AMPS (k = 1 gamma moments), every mode's mean below its
    threshold; with a `seed`, a seeded amplitude per column and mode (0.5 to
    1.5), one negative moment and one level of small negative ones."""
    import numpy as np
    import torch

    from cloudy_tpu_torch.models import rainshaft as rs

    z = (np.arange(NZ) + 0.5) * 3000.0 / NZ
    ic = np.concatenate([rs.initial_condition(z, [n, n * x, 2.0 * n * x * x])
                         for n, x in FOUR_AMPS], axis=-1)
    if seed is None:
        return torch.as_tensor(ic.T.copy()).repeat(1, n_cols)
    amp = np.random.default_rng(seed).uniform(0.5, 1.5, (n_cols, 1, 4)).repeat(3, axis=2)
    st = np.tile(ic[None], (n_cols, 1, 1)) * amp
    st[0, NZ // 2, 0] *= -1.0
    st[1, NZ // 2 + 1, 3:6] = -1e-3
    return rs.to_soa(torch.as_tensor(st))


def phase_25(dev, card, kernels, bound, gen_records):
    """Phase 25 (C.1, C.2): the four-gamma-mode configuration, past the
    prebuilt kernels' 3 modes and 9 moments, at the pod's width (2^20
    columns x 32 levels, f32): B1 generated for it (ms/step and
    column-updates/s), B3 and B4 at [12, 2^20], B5 at [12, 262144] (the unit
    built for four modes), the reference tier's B1, B3 and B4 (units built
    at capacities (4, 12, 5)) at [12, 131072], and the scaled whole step at
    the reference tier (the library's scaled reference instance) in f64 at
    [6, 4096]; each against its twin (f32 < 1e-4, f64 < 1e-9, B5 f32 < 1e-3)
    with its `kernels` entry: launches counted over its timed run."""
    import numpy as np
    import torch

    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.spec import Family

    t = time.perf_counter()
    f32 = torch.float32

    def timed(call, n):
        """ms per call over `n` calls after one untimed (CUDA events), and
        the last result."""
        out = call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n, out

    def entry(name, fn, replaces, launches, err, ms, plain_ms, bnd, B=None):
        kernels.append({"name": name, "route": "cuda", **kernel_source(fn, B),
                        "replaces": replaces, "launches": launches, "max_abs_err": err[1],
                        "max_row_scaled_err": err[0], "ms": ms, "plain_ms": plain_ms, **bnd})

    # (a) the fast tier: B1 at 2^20 x 32, B3 and B4 at [12, 2^20], B5 at
    # [12, 262144]
    fns = four_mode_wrappers(dev, f32, fast=True)
    step, rhs, coal = fns["step"], fns["rhs"], fns["coal"]
    check(all(f.route == "generated" for f in fns.values()),
          f"four-mode fast tier routes {[f.route for f in fns.values()]}")
    norm = torch.tensor(step.plan.mom_norms, dtype=f32, device=dev)[:, None]
    n2 = torch.cat([norm, norm])
    cmp = four_mode_state(N_CMP_COLUMNS, seed=25).to(dev, f32)
    errs = {"step": row_scaled(step(cmp) / norm, step.plain(cmp) / norm),
            "rhs": row_scaled(rhs.soa(cmp) / n2, rhs.plain(cmp) / n2)}
    mom = torch.as_tensor(arm_moments((Family.GAMMA,) * 4, 1 << 20, seed=26), dtype=f32,
                          device=dev)
    errs["coal"] = row_scaled(coal.soa(mom), coal.plain(mom))
    for k, (err, _) in errs.items():
        check(err < TOL["float32"], f"four-mode {k} (generated) vs twin {err:.3e}")
    big = four_mode_state(N_POD_COLUMNS).to(dev, f32)
    y = step(big)  # the outputs' allocation outside the window
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_FOUR_STEPS):
        y = step(y)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / N_FOUR_STEPS
    finite = bool(torch.isfinite(y).all())
    check(finite, "four-mode state after the timed steps not finite")
    del y
    phys = big[:, :1 << 20].contiguous()
    rhs_ms, _ = timed(lambda: rhs.soa(phys), N_FOUR_STEPS - 1)
    coal_ms, _ = timed(lambda: coal.soa(mom), N_FOUR_STEPS - 1)
    counts = {k: f.launches for k, f in fns.items()}
    check(all(v == N_FOUR_STEPS for v in counts.values()), f"four-mode launches {counts}")
    plain = {"step": _time_ms(lambda: step.plain(big), 1),
             "rhs": _time_ms(lambda: rhs.plain(phys), 1),
             "coal": _time_ms(lambda: coal.plain(mom), 1)}
    print(f"phase 25 [four gamma modes, generated] B1 at {N_POD_COLUMNS} x {NZ} f32: "
          f"{step_ms:.4f} ms/step ({N_POD_COLUMNS / step_ms * 1e3:.4e} column-updates/s, "
          f"finite {finite}); B4 at [12, {phys.shape[1]}] {rhs_ms:.4f} ms, B3 at [12, "
          f"{mom.shape[1]}] {coal_ms:.4f} ms per launch; launches {counts}; vs twin "
          f"(normalized, f32; B1 and B4 at {N_CMP_COLUMNS} x {NZ}): "
          + ", ".join(f"{k} {e[0]:.3e}" for k, e in errs.items())
          + f"; twins {', '.join(f'{k} {v:.4f} ms' for k, v in plain.items())} {card}")
    small = cmp[:, :8 * NZ].contiguous()
    for kk, kname, replaces, x_small, lanes, rows_out, ms in (
            ("step", "rainshaft_step", B1_REPLACES, small, big.shape[1], 12, step_ms),
            ("rhs", "rainshaft_rhs", B4_REPLACES, small, phys.shape[1], 24, rhs_ms),
            ("coal", "coal_rhs", B3_REPLACES, mom[:, :256].contiguous(), mom.shape[1], 12,
             coal_ms)):
        fn = fns[kk]
        entry(f"{kname}[four gamma modes]", fn, replaces, counts[kk], errs[kk], ms, plain[kk],
              bound(f"{kname}[four gamma modes]", fn.plain, x_small, lanes, 12, rows_out))
    del big, phys, mom, cmp, fns, step, rhs, coal
    torch.cuda.empty_cache()

    num = four_mode_numerical(dev, f32)
    check(num.unit is not None, "four-mode B5 does not run its unit")
    n_box = N_FOUR_NUM_BOXES
    x = torch.as_tensor(arm_moments((Family.GAMMA,) * 4, n_box, seed=27), dtype=f32,
                        device=dev)
    num.soa(x[:, :64].contiguous())
    torch.cuda.synchronize()
    num.launches = 0
    num_ms, got = timed(lambda: num.soa(x), N_FOUR_STEPS - 1)
    launches = num.launches
    want = num.plain(x, chunk=NUM_CHUNK)
    err = row_scaled(got, want)
    plain_ms = _time_ms(lambda: num.plain(x, chunk=NUM_CHUNK), 1)
    print(f"phase 25 [four gamma modes] numerical kernel ({num.unit.label}) at [12, {n_box}] "
          f"f32, Long kernel, nodes ({num.plan.g_total}, {num.plan.n_pi * num.plan.g_inner}): "
          f"{num_ms:.4f} ms per launch (launches {launches}), twin {plain_ms:.4f} ms; vs twin "
          f"row-scaled {err[0]:.3e} (tol {NUM_TOL['float32']:.0e}), max abs {err[1]:.3e}, "
          f"finite {bool(torch.isfinite(got).all())} {card}")
    check(bool(torch.isfinite(got).all()) and err[0] < NUM_TOL["float32"],
          f"four-mode numerical kernel vs twin {err[0]:.3e}")
    entry("numerical_rhs[four gamma modes, f32]", num, B5_REPLACES, launches, err, num_ms,
          plain_ms, bound("numerical_rhs[four gamma modes]", num.plain, x[:, :64].contiguous(),
                          n_box, 12, 12))
    del num, x, got, want
    torch.cuda.empty_cache()

    # (b) the reference tier at capacities (4, 12, 5): B1, B3, B4 at [12, 131072]
    fns = four_mode_wrappers(dev, f32, fast=False)
    step, rhs, coal = fns["step"], fns["rhs"], fns["coal"]
    check(coal.route == "table" and coal.caps == (4, 12, 5)
          and all(f.route == "generated" and f.unit.n_tot == 12 for f in (step, rhs)),
          "four-mode reference tier: B3 not on units at capacities (4, 12, 5), or B1 and B4 "
          "not generated for the plan")
    x = four_mode_state(N_REF_COLUMNS, seed=28).to(dev, f32)
    xn = (x.clamp_min(0) / norm).contiguous()
    lanes = x.shape[1]
    for f in fns.values():
        f.launches = 0
    times = {"step": timed(lambda: step(x), N_FOUR_STEPS - 1),
             "rhs": timed(lambda: rhs.soa(x), N_FOUR_STEPS - 1),
             "coal": timed(lambda: coal.soa(xn), N_FOUR_STEPS - 1)}
    counts = {k: f.launches for k, f in fns.items()}
    errs = {"step": row_scaled(times["step"][1] / norm, step.plain(x) / norm),
            "rhs": row_scaled(times["rhs"][1] / n2, rhs.plain(x) / n2),
            "coal": row_scaled(times["coal"][1], coal.plain(xn))}
    plain = {"step": _time_ms(lambda: step.plain(x), 1),
             "rhs": _time_ms(lambda: rhs.plain(x), 1),
             "coal": _time_ms(lambda: coal.plain(xn), 1)}
    units = {k: [u.label for u in f.build_units()] for k, f in fns.items()}
    print(f"phase 25 [four gamma modes, reference tier] at [12, {lanes}] f32 (units {units}, "
          f"B3 layout {coal.layout(lanes)}): "
          + ", ".join(f"{k} {times[k][0]:.4f} ms (twin {plain[k]:.4f}, vs twin {errs[k][0]:.3e})"
                      for k in times)
          + f" (tol {TOL['float32']:.0e}); launches {counts} {card}")
    for k, (err, _) in errs.items():
        check(err < TOL["float32"], f"four-mode reference {k} vs twin {err:.3e}")
        check(bool(torch.isfinite(times[k][1]).all()), f"four-mode reference {k} not finite")
    check(all(v == N_FOUR_STEPS for v in counts.values()), f"reference launches {counts}")
    small = x[:, :8 * NZ].contiguous()
    for kk, kname, replaces, x_small, rows_out in (
            ("step", "rainshaft_step", B1_REPLACES, small, 12),
            ("rhs", "rainshaft_rhs", B4_REPLACES, small, 24),
            ("coal", "coal_rhs", B3_REPLACES, xn[:, :8 * NZ].contiguous(), 12)):
        entry(f"{kname}[reference, four gamma modes]", fns[kk], replaces, counts[kk], errs[kk],
              times[kk][0], plain[kk],
              bound(f"{kname}[reference, four gamma modes]", fns[kk].plain, x_small, lanes, 12,
                    rows_out), B=lanes)
    del fns, step, rhs, coal, x, xn, times
    torch.cuda.empty_cache()

    # (c) the scaled whole step at the reference tier, f64, [6, 4096]
    f64 = torch.float64
    sfn = scaled_reference_step(dev, f64)
    check(sfn.plan.instance == 2 and sfn.route == "generated" and sfn.unit.scaled,
          "the scaled reference step is not the scaled unit generated for its plan")
    n_cols = 4096 // NZ
    z = (np.arange(NZ) + 0.5) * 3000.0 / NZ
    ic = np.concatenate([rs.initial_condition(z, [1e8, 1e-2, 2e-12]),
                         rs.initial_condition(z, [1e7, 1e-3, 2e-13])], axis=-1)
    amp = np.random.default_rng(29).uniform(0.5, 1.5, (n_cols, 1, 2)).repeat(3, axis=2)
    x = rs.to_soa(torch.as_tensor(np.tile(ic[None], (n_cols, 1, 1)) * amp)).to(dev, f64)
    srow = torch.linspace(0.4, 2.5, n_cols, dtype=f64, device=dev).repeat_interleave(NZ)
    sfn.launches = 0
    s_ms, got = timed(lambda: sfn(x, srow), N_FOUR_STEPS - 1)
    launches = sfn.launches
    norm6 = norm[:6].to(f64)
    err = row_scaled(got / norm6, sfn.plain(x, srow) / norm6)
    plain_ms = _time_ms(lambda: sfn.plain(x, srow), 1)
    print(f"phase 25 [scaled whole step, reference tier, {sfn.unit.label}] at [6, {x.shape[1]}] f64, scale "
          f"0.4-2.5 per column: {s_ms:.4f} ms per launch (launches {launches}), twin "
          f"{plain_ms:.4f} ms; vs twin row-scaled {err[0]:.3e} (tol {TOL['float64']:.0e}), "
          f"max abs {err[1]:.3e} (normalized) {card}")
    check(bool(torch.isfinite(got).all()) and err[0] < TOL["float64"],
          f"scaled reference step vs twin {err[0]:.3e}")
    entry("rainshaft_step[scaled, reference, f64]", sfn, B1S_REPLACES, launches, err, s_ms,
          plain_ms, bound("rainshaft_step[scaled, reference, f64]",
                          lambda v: sfn.plain(v, srow[:8 * NZ]), x[:, :8 * NZ].contiguous(),
                          x.shape[1], 7, 6, f64=True, series_exit=sfn.series_exit))
    print(json.dumps({"phase": 25, "entries": kernels[-8:]}))
    del sfn, x, got
    torch.cuda.empty_cache()
    print(f"phase 25 seconds {time.perf_counter() - t:.3f}")


def phase_26(dev, card, kernels, pod_final, pod_twin, b1_ms, plain_ms, step_bound):
    """Phase 26 (A.13): the pod `fixed2gamma` (2^20 x 32 x 120 f32) through
    `harness.run_scenario` with checkpoints every 40 steps and an output
    directory, cut after one segment and resumed; held bit for bit to phase
    6's uninterrupted state `pod_final` and, over its first 4,096 columns,
    to phase 6's twin run `pod_twin`. `b1_ms`, `plain_ms`, `step_bound`:
    phase 6's ms/step and phase 7's twin time and bound of the same step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from scipy.io import netcdf_file

    from cloudy_tpu_torch import harness
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.spec import get_moments_normalizing_factors
    from cloudy_tpu_torch.utils import checkpoint as ck

    t = time.perf_counter()
    name, seg = "pod_ensemble", 40
    n_ckpt = 120 // seg
    ckpt_bytes = 6 * N_POD_COLUMNS * NZ * 4
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    need = n_ckpt * ckpt_bytes + (1 << 30)
    check(free >= need, f"phase 26 needs {need} bytes free under {build} for {n_ckpt} "
          f"checkpoints of {ckpt_bytes} bytes, has {free}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=build))
    print(f"phase 26 checkpoint directory {tmp}: {free} bytes free, {need} needed")
    try:
        ckd, out = str(tmp / "ckpt"), str(tmp / "out")
        y, cut = harness.run_scenario(name, device=dev, ckpt_dir=ckd, outdir=out, segment=seg,
                                      max_segments=1, n_columns=N_POD_COLUMNS)
        check(y is None and not cut["completed"] and cut["n_steps_run"] == seg
              and ck.latest_step(os.path.join(ckd, name)) == seg,
              f"the cut run did not stop after one durable segment: {cut}")
        state, rep = harness.run_scenario(name, device=dev, ckpt_dir=ckd, outdir=out,
                                          segment=seg, n_columns=N_POD_COLUMNS)
        resumed_ms = rep["seconds"] / rep["n_steps_run"] * 1e3
        print(f"phase 26 cut after {cut['n_steps_run']} steps ({cut['launches']} launches), "
              f"resumed from step {rep['resumed_from_step']}: {rep['n_steps_run']} steps, "
              f"{rep['launches']} launches, {rep['seconds']:.4f} s ({rep['clock']}), "
              f"{rep['column_updates_per_s']:.4e} column-updates/s over those steps; "
              f"{resumed_ms:.4f} ms/step against phase 6's uninterrupted {b1_ms:.4f}; "
              f"checkpoint {rep['checkpoint_bytes']} bytes, save_s per segment of this call "
              f"{[round(s, 4) for s in rep['save_s']]} {card}")
        check(rep["completed"] and rep["n_steps_run"] == 120 - seg
              and rep["resumed_from_step"] == seg, f"resumed report {rep}")
        check(cut["launches"] + rep["launches"] == 120,
              f"B1 launched {cut['launches']} + {rep['launches']} times, not 120")
        check(rep["column_updates_per_s"] == N_POD_COLUMNS * (120 - seg) / rep["seconds"],
              "the resumed rate does not divide by the steps run")
        check(rep["checkpoint_bytes"] >= ckpt_bytes, f"checkpoint of {rep['checkpoint_bytes']} B")
        final = rs.to_soa(state)
        check(torch.equal(final, pod_final),
              "the resumed pod state is not bit for bit phase 6's uninterrupted one")
        norm = torch.tensor(get_moments_normalizing_factors((3, 3), (1e6, 1e-9)),
                            dtype=torch.float32, device=dev)[:, None]
        err = row_scaled(final[:, :pod_twin.shape[1]] / norm, pod_twin / norm)
        check(err[0] < TOL["float32"], f"the resumed state vs the twin {err[0]:.3e}")
        print(f"phase 26 resumed state torch.equal to phase 6's: True; first {N_CMP_COLUMNS} "
              f"columns vs phase 6's twin run row-scaled {err[0]:.3e}, max abs {err[1]:.3e} "
              f"(normalized) {card}")
        del state, final
        _, again = harness.run_scenario(name, device=dev, ckpt_dir=ckd, segment=seg,
                                        n_columns=N_POD_COLUMNS)
        check(again["n_steps_run"] == 0 and again["column_updates_per_s"] is None
              and again["launches"] == 0, f"re-run over the finished directory: {again}")
        with netcdf_file(os.path.join(out, f"{name}_mean_profile.nc"), "r", mmap=False) as f:
            mom = f.variables["moments"][:].astype(np.float64)
            times = f.variables["time"][:].astype(np.float64)
        last = np.concatenate([mom[-1, :, i, :] for i in range(2)], axis=-1)
        want = harness.column_mean(pod_final, NZ).double().cpu().numpy()
        check(mom.shape[0] == 12 and np.array_equal(times, 10.0 * np.arange(1, 13)),
              f"mean profile frames {mom.shape}, times {times}")
        check(np.array_equal(last, want),
              "the mean profile's last frame is not the column mean of phase 6's state")
        print(f"phase 26 re-run over the finished directory: n_steps_run "
              f"{again['n_steps_run']}, rate {again['column_updates_per_s']}; "
              f"{name}_mean_profile.nc: {mom.shape[0]} frames at t = {times[0]:g}..{times[-1]:g}, "
              f"the last equal to the column mean of phase 6's state; files "
              f"{sorted(os.listdir(out))}")
        kernels.append({"name": "rainshaft_step[fixed2gamma, checkpointed]", "route": "cuda",
                        "source": GEN_SOURCE, "generator": GEN_GENERATOR,
                        "kernel_path": "generated", "replaces": B1_REPLACES,
                        "launches": cut["launches"] + rep["launches"],
                        "max_abs_err": err[1], "max_row_scaled_err": err[0], "ms": resumed_ms,
                        "plain_ms": plain_ms, "save_s": rep["save_s"],
                        "checkpoint_bytes": rep["checkpoint_bytes"], **step_bound})
    finally:
        shutil.rmtree(tmp)
    print(f"phase 26 seconds {time.perf_counter() - t:.3f}")


def phase_27(dev, card, kernels, bound):
    """Phase 27 (A.14): `tools.longhorizon` at both depths, 1000 steps of
    the generated f32 B1 and of the generated f64 reference-tier B1 at [6, 4096],
    the JAX gates' bounds as checks; the f64 run's state at t = 100 against
    the twin run on the card over the first 4 columns, the f32 kernel
    against its twin for one step at [6, 4096]; a `kernels` entry each."""
    import torch

    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.tools import longhorizon as lh

    t = time.perf_counter()
    n_twin, n_cols = 100, 4
    for name, nz in lh.DEPTHS.items():
        fast, ref = lh.make_steps(nz, dev)
        check(fast.route == "generated" and ref.route == "generated" and ref.plan.ref,
              f"long-horizon routes {fast.route}, {ref.route}")
        rec, states = lh.run_depth(name, nz, fast, ref, n_steps=lh.N_STEPS)
        print(json.dumps({"phase": 27, **rec}))
        rows = {r["t"]: r for r in rec["checkpoints"]}
        print(f"phase 27 nz {nz}, {rec['n_columns']} columns x {rec['n_steps']} steps: f32 "
              f"generated B1 {rec['ms_per_step_f32']:.4f} ms/step, f64 reference B1 "
              f"{rec['ms_per_step_f64']:.4f} ms/step at [6, {rec['n_columns'] * nz}]; scaled "
              "error / drift32 - drift64 at gated t: "
              + ", ".join(f"t={k} {rows[k]['traj_err_max_scaled']:.3e} / "
                          f"{rows[k]['f32_mass_drift_vs_t0'] - rows[k]['f64_mass_drift_vs_t0']:.3e}"
                          for k in lh.ERR_GATES[nz] if k in rows)
              + f"; failures {rec['gate_failures']} {card}")
        check(not rec["gate_failures"], f"long horizon nz {nz}: {rec['gate_failures']}")
        check(rec["launches_f32"] == rec["launches_f64"] == rec["n_steps"],
              f"long horizon launches {rec['launches_f32']}, {rec['launches_f64']}")
        x0 = rs.to_soa(torch.as_tensor(lh.start_state(nz)))
        k100 = [r["t"] for r in rec["checkpoints"]].index(n_twin)
        for tag, fn, f64 in (("f32", fast, False), ("f64", ref, True)):
            tol = TOL["float64" if f64 else "float32"]
            norm = torch.tensor(fn.plan.mom_norms, dtype=torch.float64, device=dev)[:, None]
            x = x0.to(dev, fn.dtype).contiguous()
            if f64:  # the run's state at t = 100 against the twin's
                y = x[:, :n_cols * nz].contiguous()
                for _ in range(n_twin):
                    y = fn.plain(y)
                got = rs.to_soa(torch.as_tensor(states[tag][k100][:n_cols])).to(dev)
                what = f"at t = {n_twin}, first {n_cols} columns"
            else:  # one step at the run's shape (phase 6 holds this unit for 120 steps)
                got, y = fn(x), fn.plain(x)
                what = f"one step at [6, {x.shape[1]}]"
            err = row_scaled(got.double() / norm, y.double() / norm)
            print(f"phase 27 nz {nz} {tag} kernel vs twin on the card, {what}: row-scaled "
                  f"{err[0]:.3e} (tol {tol:.0e}), max abs {err[1]:.3e} (normalized) {card}")
            check(err[0] < tol, f"long horizon nz {nz} {tag} kernel vs twin {err[0]:.3e}")
            label = (f"rainshaft_step[reference, f64, longhorizon nz{nz}]" if f64
                     else f"rainshaft_step[longhorizon nz{nz} f32]")
            kernels.append({"name": label, "route": "cuda", **kernel_source(fn),
                            "replaces": B1_REPLACES, "launches": rec[f"launches_{tag}"],
                            "max_abs_err": err[1], "max_row_scaled_err": err[0],
                            "ms": rec[f"ms_per_step_{tag}"],
                            "plain_ms": _time_ms(lambda: fn.plain(x), 1),
                            **bound(label, fn.plain, x[:, :8 * nz].contiguous(), x.shape[1], 6,
                                    6, f64=f64)})
        del fast, ref, states
    print(json.dumps({"phase": 27, "entries": kernels[-4:]}))
    print(f"phase 27 seconds {time.perf_counter() - t:.3f}")


def phase_28(dev, card):
    """Phase 28 (A.9): the parcel and the condensation box in f64 on the
    card, each against the same call on the CPU; the Rogers (1975) curves
    at tests/test_parcel.py's bounds; the adaptive parcel's trials. The
    path is torch ops on a state of 7-10 numbers: host-bound, no
    hand-written kernel."""
    import numpy as np
    import torch

    from cloudy_tpu_torch.models import box, parcel as pm
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    t = time.perf_counter()
    cpu = torch.device("cpu")

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for kind in PARCEL_KINDS:
        spec, mom0, ml_v = pm.init_conditions(kind)
        config = pm.ParcelConfig(spec=spec, w=10.0, dt=0.25, t_end=20.0)
        Y0 = pm.initial_state(config, mom0, ml_v, p0=8e4, T0=273.15 + 7.0, S0=1.0)
        (ts, ys), sec = host_s(lambda: pm.run_parcel(config, Y0, device=dev))
        _, ys_cpu = pm.run_parcel(config, Y0, device=cpu)
        n_ops = _count_ops(pm.make_parcel_rhs(config), ys[0], 0.0)
        check(ys.device.type == "cuda" and ys.dtype == torch.float64, "parcel not on the card")
        y = ys.cpu().numpy()
        rel = float(np.max(np.abs(y - ys_cpu.numpy()) / np.abs(ys_cpu.numpy())))
        S, p, T, qv = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
        sane = (np.all(np.isfinite(y)) and p[-1] < p[0] and T[-1] < T[0] and 1.0005 < S.max() < 1.02
                and qv[-1] < qv[0] and y[-1, 5] > y[0, 5])
        extra = ""
        if kind == "gamma":
            tn = ts.numpy()
            got = np.interp(pm.ROGERS_TIME_SUPERSAT, tn, (S - 1.0) * 100.0)
            r_um = (y[:, 5] / y[:, 4] / config.tps.rho_w * 3 / 4 / np.pi) ** (1 / 3) * 1e6
            d_end = abs(got[-1] - pm.ROGERS_SUPERSAT[-1])
            d_s = float(np.max(np.abs(got - pm.ROGERS_SUPERSAT)))
            d_r = float(np.max(np.abs(np.interp(pm.ROGERS_TIME_RADIUS, tn, r_um)
                                      - pm.ROGERS_RADIUS)))
            extra = (f"; Rogers: end {d_end:.4f} (< 0.35), supersaturation {d_s:.4f} (< 0.45) "
                     f"percentage points, radius {d_r:.4f} um (< 0.6)")
            check(d_end < 0.35 and d_s < 0.45 and d_r < 0.6, f"parcel vs Rogers {extra}")
        n_steps = len(ts) - 1
        print(f"phase 28 run_parcel {kind} f64 on the card, {n_steps} SSPRK33 steps: "
              f"{sec:.4f} host s ({sec / n_steps * 1e3:.4f} ms/step; {n_ops} torch operations "
              f"per RHS, {sec / (3 * n_ops * n_steps) * 1e6:.2f} host us each), vs the CPU max rel "
              f"{rel:.3e} (tol {PARCEL_TOL:.0e}), sane {sane}{extra} {card}")
        check(sane, f"parcel {kind} fails tests/test_parcel.py's sanity checks")
        check(rel < PARCEL_TOL, f"parcel {kind} on the card vs the CPU {rel:.3e}")

    spec, mom0, ml_v = pm.init_conditions("mixture")
    config = pm.ParcelConfig(spec=spec, w=10.0, dt=0.25, t_end=20.0)
    Y0 = pm.initial_state(config, mom0, ml_v, p0=8e4, T0=273.15 + 7.0, S0=1.0)
    (y_ad, st), sec = host_s(lambda: pm.run_parcel_adaptive(config, Y0, device=dev))
    y_cpu, st_cpu = pm.run_parcel_adaptive(config, Y0, device=cpu)
    trials = st["n_accept"] + st["n_reject"]
    rel = float(((y_ad.cpu() - y_cpu).abs() / y_cpu.abs()).max())
    print(f"phase 28 run_parcel_adaptive mixture f64 on the card: n_accept {st['n_accept']}, "
          f"n_reject {st['n_reject']}, reached {st['reached']}, t_final "
          f"{float(st['t_final'])}; {sec:.4f} host s, {sec / trials * 1e3:.4f} ms per trial "
          f"(one host read each); the CPU's trials {st_cpu['n_accept']}/{st_cpu['n_reject']}, "
          f"y max rel {rel:.3e} {card}")
    check(st["reached"] and (st["n_accept"], st["n_reject"]) == (st_cpu["n_accept"],
                                                                st_cpu["n_reject"]),
          f"adaptive parcel trials {st} against the CPU's {st_cpu}")
    check(rel < PARCEL_TOL, f"adaptive parcel on the card vs the CPU {rel:.3e}")

    bspec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA))
    bcfg = box.BoxConfig(spec=bspec, t_end=100.0, dt=1.0)
    rhs = box.make_box_condensation_rhs(bcfg, 0.01, 3.5e-3)
    mom = [1e8, 1e-2, 1e6, 1e-3, 2e-15]
    (_, ys), sec = host_s(lambda: box.run_box(
        bcfg, rhs, torch.tensor(mom, dtype=torch.float64, device=dev)))
    _, ys_cpu = box.run_box(bcfg, rhs, torch.tensor(mom, dtype=torch.float64))
    rel = float(((ys.cpu() - ys_cpu).abs() / ys_cpu.abs()).max())
    print(f"phase 28 condensation box (exp + gamma) f64 on the card, 100 steps: {sec:.4f} host "
          f"s, vs the CPU max rel {rel:.3e} (tol {PARCEL_TOL:.0e}), finite "
          f"{bool(torch.isfinite(ys).all())} {card}")
    check(bool(torch.isfinite(ys).all()) and rel < PARCEL_TOL,
          f"condensation box on the card vs the CPU {rel:.3e}")
    print("phase 28: the parcel and the condensation box are torch ops on 5-10 numbers, "
          "host-bound; no hand-written kernel is on this path")
    print(f"phase 28 seconds {time.perf_counter() - t:.3f}")


def _count_ops(fn, *args):
    """The number of torch operations (ATen calls) of one ``fn(*args)``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return Count.n


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _children(case, world, env_extra=None, timeout=600):
    """Run phase 29's `case` in `world` child processes of this script (one
    rank each, a free local port); returns each rank's JSON result. A child
    that fails, or leaves no result, fails the phase (its output is shown)."""
    import tempfile

    port = _free_port()
    (ROOT / "build").mkdir(exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_29_", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, "-u", str(ROOT / "chip_smoke.py"), "--phase29", case, str(port),
         str(r), str(world), str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(ROOT)) for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        f = out / f"{case}_rank{r}.json"
        if p.returncode != 0 or not f.exists():
            print(text[-6000:])
            raise SystemExit(f"chip_smoke: phase 29 child {case} rank {r} failed "
                             f"(exit {p.returncode})")
        results.append(json.loads(f.read_text()))
    import shutil

    shutil.rmtree(out)
    return results


def _shard_hashes(y, parts):
    """SHA-256 of the bytes of each of `parts` equal column slices of a SoA
    state ``[n_tot, B]`` (in column order)."""
    import hashlib

    w = y.shape[1] // parts
    return [hashlib.sha256(y[:, i * w:(i + 1) * w].contiguous().cpu().numpy().tobytes())
            .hexdigest() for i in range(parts)]


def phase_29(dev, card, kernels, pod_hashes, step_row, bound):
    """Phase 29 (A.10): the pod through the harness's sharded route and the
    parallel package on the card, in child processes (no process group
    outlives the phase): (a) W = 1 under NCCL, its state held to phase 6's
    by SHA-256 over the bytes of each half, ms/step in turns against the
    unsharded step, the all-reduced mass against the local sum; (b) W = 2
    under gloo, both ranks on cuda:0, 2^19 columns each, each rank's shard
    held to (a)'s half; (c) the z-split step over 2 gloo ranks on cuda:0,
    4,096 columns x 32 levels split 2 x 16, f64, against the unsplit AoS
    step; (d) `tools.scaling_measure` at W = 1 through B4. `pod_hashes`:
    phase 6's state's halves; `step_row`: phase 7's B1 entry."""
    import torch

    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.tools import scaling_measure as sm

    t = time.perf_counter()
    (a,) = _children("a", 1, {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
                              "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"})
    print(f"phase 29(a) W = 1 {a['backend']}: pod fixed2gamma {a['report']['n_columns']} x {NZ} "
          f"x 120 f32 through ensemble_whole_step: {a['report']['seconds']:.4f} s, "
          f"{a['report']['column_updates_per_s']:.4e} column-updates/s, launches "
          f"{a['report']['launches']}; halves' SHA-256 equal to phase 6's: "
          f"{a['hashes'] == pod_hashes}; ms/step in turns sharded / unsharded / unsharded / "
          f"sharded {[round(x, 4) for x in a['turns_ms']]}; all-reduced mass "
          f"{a['report']['total_mass']!r} vs local sum {a['local_mass']!r}; child host s "
          f"{a['host_s']:.3f} {card}")
    check(a["backend"] == "nccl" and a["report"]["world_size"] == 1, f"(a) ran {a['backend']}")
    check(a["hashes"] == pod_hashes, "the W = 1 sharded pod state is not phase 6's")
    check(a["report"]["launches"] == 120 and a["report"]["finite"]
          and a["report"]["negative_fraction"] == 0.0, f"(a) report {a['report']}")
    check(a["report"]["total_mass"] == a["local_mass"], "(a) all-reduced mass != local sum")
    sharded_ms = min(a["turns_ms"][0], a["turns_ms"][3])
    check(sharded_ms < 1.05 * min(a["turns_ms"][1:3]),
          f"(a) the sharded route costs more than the unsharded step: {a['turns_ms']}")

    b = _children("b", 2)
    print(f"phase 29(b) W = 2 {b[0]['backend']} on cuda:0 (both ranks): "
          f"{b[0]['report']['n_local_columns']} columns per rank, "
          f"{b[0]['report']['seconds']:.4f} s (slowest rank, both on one card), "
          f"{b[0]['report']['column_updates_per_s']:.4e} column-updates/s over "
          f"{b[0]['report']['n_columns']} columns, launches per rank "
          f"{[r['report']['launches'] for r in b]}; each shard's SHA-256 equal to (a)'s half: "
          f"{[r['hashes'][0] for r in b] == a['hashes']}; total_mass {b[0]['report']['total_mass']!r} "
          f"(a: {a['report']['total_mass']!r}) {card}")
    check(all(r["backend"] == "gloo" and r["report"]["world_size"] == 2 for r in b),
          "(b) did not run two gloo ranks")
    check([r["hashes"][0] for r in b] == a["hashes"],
          "the union of the W = 2 shards is not the W = 1 state")
    check(all(r["report"]["launches"] == 120 for r in b), "(b) launches")
    check(abs(b[0]["report"]["total_mass"] / a["report"]["total_mass"] - 1.0) < 1e-6,
          "(b) total mass")

    c = _children("c", 2)
    print(f"phase 29(c) z split over 2 {c[0]['backend']} ranks on cuda:0, {Z_COLUMNS} columns x "
          f"{NZ} levels as 2 x {NZ // 2}, one f64 step: equal to the unsplit AoS step bit for "
          f"bit {[r['equal'] for r in c]}, max rel {max(r['max_rel'] for r in c):.3e} (bound "
          f"{Z_TOL:.0e}); host s {[round(r['step_s'], 4) for r in c]} {card}")
    check(all(r["max_rel"] <= Z_TOL for r in c), "(c) z-split step vs unsplit")

    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "cloudy_tpu_torch.tools.scaling_measure",
                          "--device", "cuda", "--columns", str(N_POD_COLUMNS), "--steps",
                          str(N_SCALE_STEPS), "--reps", "3"], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=600)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:])
        raise SystemExit(f"chip_smoke: phase 29(d) scaling_measure failed ({res.returncode})")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps({"phase": 29, **rec}))
    check(rec["launches"] == 3 * 3 * N_SCALE_STEPS and rec["world_size"] == 1,
          f"(d) B4 launches {rec['launches']}")
    _, cfg, _, rfn = sm.build_step(True, None, dev)
    state = sm.make_state(cfg, N_POD_COLUMNS, True, dev, torch.float32)
    norm = torch.tensor(rfn.plan.mom_norms * 2, dtype=torch.float32, device=dev)[:, None]
    rerr, rabs = row_scaled(rfn.soa(state) / norm, rfn.plain(state) / norm)
    rhs_ms, rhs_plain = _time_ms(lambda: rfn.soa(state), 5), _time_ms(lambda: rfn.plain(state), 1)
    print(f"phase 29(d) scaling_measure W = 1, fused-RHS route through "
          f"ensemble_rainshaft_step_soa at {N_POD_COLUMNS} x {NZ}: {rec['ms_per_step']:.4f} "
          f"ms/step, {rec['column_updates_per_s']:.4e} column-updates/s, B4 launches "
          f"{rec['launches']}; B4 at [6, {N_POD_COLUMNS * NZ}] {rhs_ms:.4f} ms per launch, vs "
          f"twin row-scaled {rerr:.3e}, max abs {rabs:.3e} (normalized), twin {rhs_plain:.4f} ms "
          f"{card}")
    check(rerr < TOL["float32"], f"(d) B4 vs twin {rerr:.3e}")
    same = {k: step_row[k] for k in ("max_abs_err", "max_row_scaled_err", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}
    kernels.append({"name": "rainshaft_step[fixed2gamma, sharded W=1 nccl]", "route": "cuda",
                    "source": GEN_SOURCE, "generator": GEN_GENERATOR,
                    "kernel_path": "generated", "replaces": B1_REPLACES,
                    "launches": a["report"]["launches"], "ms": sharded_ms, **same,
                    "errors_from": "phase 7 (the state is phase 6's, byte for byte)"})
    kernels.append({"name": "rainshaft_step[fixed2gamma, sharded W=2 gloo, one card]",
                    "route": "cuda", "source": GEN_SOURCE, "generator": GEN_GENERATOR,
                    "kernel_path": "generated", "replaces": B1_REPLACES,
                    "launches": sum(r["report"]["launches"] for r in b),
                    "ms": b[0]["report"]["seconds"] / 120 * 1e3, **same,
                    "errors_from": "phase 7 (the shards' union is phase 6's state)"})
    kernels.append({"name": "rainshaft_rhs[fixed2gamma, scaling_measure W=1]", "route": "cuda",
                    **kernel_source(rfn), "replaces": B4_REPLACES, "launches": rec["launches"],
                    "max_abs_err": rabs, "max_row_scaled_err": rerr, "ms": rhs_ms,
                    "plain_ms": rhs_plain, "route_ms_per_step": rec["ms_per_step"],
                    **bound("rainshaft_rhs[scaling_measure]", rfn.plain,
                            state[:, :8 * NZ].contiguous(), N_POD_COLUMNS * NZ, 6, 12)})
    del rfn, state
    torch.cuda.empty_cache()
    print(json.dumps({"phase": 29, "entries": kernels[-3:]}))
    print(f"phase 29 seconds {time.perf_counter() - t:.3f}")


def child_29(case, port, rank, world, outdir):
    """One rank of a phase-29 case (see `phase_29`); writes its result to
    OUTDIR/CASE_rank{RANK}.json."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from cloudy_tpu_torch import harness
    from cloudy_tpu_torch.models import rainshaft as rs
    from cloudy_tpu_torch.parallel import mesh as pmesh
    from cloudy_tpu_torch.utils import metrics

    rank, world = int(rank), int(world)
    dev = torch.device("cuda", 0)
    if case == "a":  # torchrun's environment, set by the parent
        pmesh.initialize_distributed(device=dev)
    else:
        pmesh.initialize_distributed(f"tcp://localhost:{port}", world, rank, device=dev,
                                     backend="gloo")
    out = {"backend": dist.get_backend(), "rank": rank}
    try:
        if case in ("a", "b"):
            state, rep = harness.run_scenario("pod_ensemble", device=dev,
                                              n_columns=N_POD_COLUMNS)
            y = rs.to_soa(state)
            out["report"], out["hashes"] = rep, _shard_hashes(y, 2 if case == "a" else 1)
            m1 = state[..., 1] + state[..., 4]
            out["local_mass"] = float(torch.sum(m1))
            del state, y
            if case == "a":
                sc = harness.SCENARIOS["pod_ensemble"](n_columns=N_POD_COLUMNS, device=dev)
                turns = []
                for sharded in (True, False, False, True):
                    fn = sc["run"] if sharded else (
                        lambda: metrics.timed_steps(sc["step"], sc["state0"], sc["n_steps"]))
                    _, s, _ = fn()
                    turns.append(s / sc["n_steps"] * 1e3)
                out["turns_ms"] = turns
        else:  # "c": the z-split step against the unsplit one
            import numpy as np

            from cloudy_tpu_torch import kernels as K
            from cloudy_tpu_torch import stepper
            from cloudy_tpu_torch.coalescence import build_coalescence_data
            from cloudy_tpu_torch.parallel import halo
            from cloudy_tpu_torch.spec import Family, SpectrumSpec

            spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
            ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
            data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
            cfg = rs.RainshaftConfig(spec=spec, nz=NZ, zmax=3000.0, norms=(1e6, 1e-9), dt=1.0)
            ic1 = rs.initial_condition(cfg.z, [1e8, 1e-2, 2e-12])
            ic = np.concatenate([ic1, 0.3 * ic1], axis=-1)
            amp = np.linspace(0.5, 1.5, Z_COLUMNS)[:, None, None]
            full = torch.as_tensor(np.tile(ic[None], (Z_COLUMNS, 1, 1)) * amp, device=dev)
            mesh = pmesh.make_mesh(("columns", "z"), (1, world))
            rhs = halo.make_z_sharded_rainshaft_rhs(spec, data, cfg.dz, cfg.vel, cfg.norms,
                                                    mesh=mesh)
            nzl = NZ // world
            block = full[:, rank * nzl:(rank + 1) * nzl].contiguous()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            got = halo.z_sharded_step(rhs, cfg.dt, mesh)(block)
            torch.cuda.synchronize()
            out["step_s"] = time.perf_counter() - ts
            want = stepper.ssprk33_step(rs.make_rainshaft_rhs(cfg, data), full,
                                        torch.zeros((), dtype=full.dtype), cfg.dt)
            want = want[:, rank * nzl:(rank + 1) * nzl]
            out["equal"] = bool(torch.equal(got, want))
            scale = want.abs().amax(dim=(0, 1))
            out["max_rel"] = float(((got - want).abs() / scale).max())
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out["host_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"{case}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"phase 29 child {case} rank {rank} done in {out['host_s']:.3f} s", flush=True)


def phase_30(dev, card, kernels, bound, b1_ms, log):
    """Phase 30: (a) B5 with a traced kernel function against its
    twin and in the bench chain, timed in turns with B5's Long; (b) the
    native oracle against `get_coal_ints` and B3's reference tier on the
    card's f64 state; (c) five examples on the card in child processes, and
    the calibration example's forward under the profiler; (d)
    `tools.whole_step_1m` beside phase 6's B1. Appends the traced kernel
    functions' entries to `kernels`."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cloudy_tpu_torch import bench, native
    from cloudy_tpu_torch import distributions as pd
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data, get_coal_ints
    from cloudy_tpu_torch.examples import calibration_example
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec
    from cloudy_tpu_torch.tools import opcount, whole_step_1m
    from cloudy_tpu_torch.tools import traced_kernels as tk
    from cloudy_tpu_torch.utils import plotting

    t = time.perf_counter()
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    G2 = SpectrumSpec((Family.GAMMA, Family.GAMMA))

    # (a) B5's traced arm against its twin on the CPU (the reference
    # semantics: torch's CUDA hardsigmoid and hardswish round otherwise) at
    # 128 boxes, (64, 32) nodes
    rng = np.random.default_rng(5)
    par = np.stack([np.stack([rng.uniform(10, 200, N_NUM_BOXES), rng.uniform(0.05, 5.0, N_NUM_BOXES),
                              rng.uniform(0.5, 5.0, N_NUM_BOXES)], -1) for _ in range(2)], 1)
    mom = pd.get_moments(G2, torch.as_tensor(par)).numpy().T.copy()
    mom[:, 5] = 0.0  # an empty box
    built = {r["label"]: r for r in _build.GEN_BUILDS}
    for kname in traced_kernels():
        for name, dt in dtypes.items():
            fn = traced_numerical(dev, dt, NUM_NODES)[kname]
            x = torch.as_tensor(mom, dtype=dt, device=dev)
            got = fn.soa(x)
            check(fn.launches == 1, f"[B5 gen {kname}] did not count one launch")
            want = fn.plain(x.cpu()).to(dev)
            err, abs_err = row_scaled(got, want)
            finite = bool(torch.isfinite(got).all())
            empty_zero = bool((got[:, 5] == 0).all())
            repeat = bool(torch.equal(got, fn.soa(x)))
            rec = built.get(fn.unit.label, {})
            pt = _build.ptxas_report(rec.get("log", ""))
            gen = dict(fn.unit.gen)
            r_form = (f"R by block sums of {gen['terms']} separable terms" if gen["terms"]
                      else "R without block sums")
            r_form += (f" and a pair loop over a remainder of {gen['remainder_nodes']} operations "
                       f"({gen['x_values']} x values, {gen['tabled']} y values tabled per node)"
                       if gen["remainder"] else ", no G x G loop")
            print(f"phase 30 (a) B5 gen [{kname}] {fn.unit.label} vs twin (CPU) {name} at "
                  f"[{x.shape[0]}, {x.shape[1]}], nodes {NUM_NODES}: row-scaled {err:.3e} (tol "
                  f"{NUM_TOL[name]:.0e}), max abs {abs_err:.3e}, finite {finite}, empty box zero "
                  f"{empty_zero}, second launch bit-identical {repeat}; nvcc "
                  f"{rec.get('seconds', float('nan')):.3f} s (phase 2), ptxas {pt}; {r_form} "
                  f"{card}")
            print(json.dumps({"phase": 30, "kind": "numerical_gen_unit", "unit": kname,
                              "dtype": name, "label": fn.unit.label, "ptxas": pt, **gen}))
            check(bool(rec), f"[B5 gen {kname}] {fn.unit.label} was not built in phase 2")
            check(kname != "tensor" or (gen["terms"] > 0 and not gen["remainder"]),
                  "[B5 gen tensor] R is not block sums alone")
            check(finite and empty_zero and repeat, f"[B5 gen {kname}] {name}: not finite, "
                  "empty box not zero or two launches differ")
            check(err < NUM_TOL[name], f"[B5 gen {kname}] {name} vs twin {err:.3e}")
    for ln in ptxas_summary(log):
        if ln.startswith("quad_kernel<") and "2 modes" in ln:
            print(f"phase 30 (a) the tagged instances, ptxas (phase 2): {ln}")

    # the numerical bench chain through each traced kernel function at
    # [6, 262144] f32, (96, 48) nodes (`tools.traced_kernels.CAPPED`'s at
    # fewer boxes); B5's Long and both in turns
    x_bench = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=torch.float32,
                              device=dev)
    fns = {"long": bench.numerical_fn(dev), **traced_numerical(dev, torch.float32)}
    xs = {"long": x_bench}
    for kname in traced_kernels():
        fn = fns[kname]
        fn.soa(x_bench[:, :64].contiguous())  # loads the unit, outside the count
        torch.cuda.synchronize()
        n_box = tk.CAPPED.get(kname, x_bench.shape[1])
        x = xs[kname] = x_bench[:, :n_box].contiguous()
        if n_box < x_bench.shape[1]:
            print(f"phase 30 (a) [{kname}] its chain and turns run at [6, {n_box}], beside B5's "
                  f"Long at that width")
            xs[f"long@{n_box}"], fns[f"long@{n_box}"] = x, fns["long"]
        fn.launches = 0
        s_chain = bench.time_chain(fn.soa, x, N_NUM_STEPS)
        n_launch = fn.launches
        check(n_launch == N_NUM_STEPS + 3,
              f"[B5 gen {kname}] chain launched {n_launch} times, not {N_NUM_STEPS + 3}")
        got = fn.soa(x)
        fn.plain(x[:, :64].contiguous())  # torch's first-use kernel builds, outside the time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fn.plain(x, chunk=NUM_CHUNK)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err, abs_err = row_scaled(got, want)
        ms = _time_ms(lambda: fn.soa(x), 10)
        print(f"phase 30 (a) numerical RHS chain [{kname}] {n_box} boxes f32, nodes "
              f"{fn.plan.g_total} outer x {fn.plan.g_inner} inner: {s_chain * 1e3:.4f} ms per "
              f"step, launches {n_launch}; kernel vs twin at [6, {n_box}] row-scaled {err:.3e} "
              f"(tol {NUM_TOL['float32']:.0e}), max abs {abs_err:.3e}; kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms {card}")
        check(bool(torch.isfinite(got).all()), f"[B5 gen {kname}] not finite at the bench shape")
        check(err < NUM_TOL["float32"], f"[B5 gen {kname}] vs twin at the bench shape {err:.3e}")
        kernels.append({"name": f"numerical_rhs_gen[{kname}]", "route": "cuda",
                        **kernel_source(fn), "replaces": B5_REPLACES, "launches": n_launch,
                        "max_abs_err": abs_err, "max_row_scaled_err": err, "ms": ms,
                        "plain_ms": plain_ms,
                        **bound(f"numerical_rhs_gen[{kname}]", fn, x[:, :64].contiguous(),
                                n_box, 6, 6, count=opcount.count_ops_traced)})
        del got, want
    order = list(fns)
    turns = {k: [] for k in order}
    for seq in (order, order[::-1], order, order[::-1]):
        for k in seq:
            turns[k].append(_time_ms(lambda: fns[k].soa(xs[k]), 5))
    med = {k: float(np.median(v)) for k, v in turns.items()}
    print(f"phase 30 (a) B5 f32 in turns (5 launches per turn; [6, {x_bench.shape[1]}] unless "
          "named): " + ", ".join(f"{k} [6, {xs[k].shape[1]}] {med[k]:.4f} ms "
                                 f"{[round(v, 4) for v in turns[k]]}" for k in order)
          + f" {card}")
    print(json.dumps({"phase": 30, "kind": "numerical_gen_turns", "median_ms": med,
                      "turns_ms": turns, "boxes": {k: xs[k].shape[1] for k in order}}))
    del x, xs, x_bench, fns
    torch.cuda.empty_cache()
    print(f"phase 30 (a) seconds {time.perf_counter() - t:.3f}")

    # (b) the native oracle on the card's f64 state, at the Simpson switches
    t = time.perf_counter()
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(G2, ker, (5e-10, np.inf), norms=bench.NORMS)
    m = torch.as_tensor(bench.bench_moments(NATIVE_BOXES, seed=1), dtype=torch.float64,
                        device=dev)
    t0 = time.perf_counter()
    gold = native.coal_ints_golden(data, m)
    native_s = time.perf_counter() - t0
    gci = get_coal_ints(data, pd.params_from_moments(G2, m)).cpu().numpy()
    ref = fc.make_coal_fn(data, device=dev, dtype=torch.float64)
    check(ref.plan.ref, "B3 at the Simpson switches is not the reference tier")
    b3 = ref.soa(m.T.contiguous()).T.cpu().numpy()
    for label, other in (("get_coal_ints on the card", gci),
                         (f"B3's reference tier (kernel, {ref.layout(NATIVE_BOXES)})", b3)):
        close = bool(np.allclose(gold, other, rtol=NATIVE_RTOL, atol=1e-12))
        col = np.abs(gold - other).max(axis=0) / np.maximum(np.abs(other).max(axis=0), 1e-300)
        nz = other != 0.0
        rel = float(np.max(np.abs(gold - other)[nz] / np.abs(other)[nz]))
        print(f"phase 30 (b) native oracle ({NATIVE_BOXES} boxes f64, {native_s:.3f} host s) "
              f"vs {label}: allclose rtol {NATIVE_RTOL:.0e} atol 1e-12 {close}, row-scaled "
              f"{float(col.max()):.3e}, largest elementwise relative {rel:.3e} {card}")
        check(close and bool(np.isfinite(other).all()),
              f"native oracle vs {label}: row-scaled {float(col.max()):.3e}")
    del m, gold, gci, b3, ref
    torch.cuda.empty_cache()
    print(f"phase 30 (b) seconds {time.perf_counter() - t:.3f}")

    # (c) examples on the card in FAST mode, each a child process, all five
    # at once (their starts and host-bound steps overlap on the host's cores)
    t = time.perf_counter()
    env = dict(os.environ, CLOUDY_EXAMPLE_FAST="1", PYTHONPATH=str(ROOT))
    with tempfile.TemporaryDirectory() as tmp:
        procs, secs = {}, {}
        try:
            for name in CARD_EXAMPLES:
                out = Path(tmp) / name
                out.mkdir()
                with open(out / "stdout.txt", "w") as fo, open(out / "stderr.txt", "w") as fe:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", f"cloudy_tpu_torch.examples.{name}", "--device",
                         "cuda", "--outdir", str(out)], cwd=ROOT, env=env, stdout=fo, stderr=fe)
            while len(secs) < len(procs):
                for name, proc in procs.items():
                    if name not in secs and proc.poll() is not None:
                        secs[name] = time.perf_counter() - t
                check(time.perf_counter() - t < 600, "the examples ran past 600 s")
                time.sleep(0.05)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name in CARD_EXAMPLES:
            out = Path(tmp) / name
            stdout = (out / "stdout.txt").read_text()
            lines = stdout.strip().splitlines()
            check(procs[name].returncode == 0, f"example {name} exited {procs[name].returncode}: "
                  f"{(out / 'stderr.txt').read_text()[-2000:]}")
            check(any(k in stdout for k in ("final moments", "total mass", "done")),
                  f"example {name} printed none of its result lines")
            # figures where matplotlib is installed (`plotting.available`), else
            # the example says it skips them; the calibration draws none
            pngs = len(list(out.glob("*.png")))
            if name != "calibration_example":
                check(pngs > 0 if plotting.available() else "figures skipped" in stdout,
                      f"example {name}: {pngs} figures, matplotlib installed "
                      f"{plotting.available()}")
            print(f"phase 30 (c) example {name} on the card (FAST, child process, its start "
                  f"included, five at once): {secs[name]:.3f} host s, {pngs} figures, "
                  f"{len(list(out.glob('*.nc')))} NetCDF files; last line: "
                  f"{lines[-1] if lines else ''} {card}")
            if name == "calibration_example":
                s_eki = float(re.search(r"EKI:\s+s = ([0-9.]+)", stdout).group(1))
                check(abs(s_eki - 1.7) / 1.7 < 0.02, f"calibration example EKI s = {s_eki}")
    # the calibration example's batched forward (24 members) under the
    # profiler: the device's share of its host time
    forward, _, _ = calibration_example.make_forward(dev)
    theta = torch.linspace(-0.7, 0.7, 24, dtype=torch.float64, device=dev)[:, None]
    forward(theta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(theta)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0)
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
    share = dev_ms / host_ms if dev_ms > 0 else None
    print(f"phase 30 (c) calibration example forward (24 members, 15 SSPRK33 steps, f64) under "
          f"the profiler: {host_ms:.3f} host ms, device activities {dev_ms:.3f} ms, busy share "
          f"{'not measured (no device time in the trace)' if share is None else f'{share:.4f}'}"
          f" {card}")
    print(f"phase 30 (c) seconds {time.perf_counter() - t:.3f}")

    # (d) tools.whole_step_1m: B1 at 2^20 x 32, beside phase 6's reading
    t = time.perf_counter()
    rec = whole_step_1m.measure(device=dev)
    print(json.dumps(rec))
    print(f"phase 30 (d) whole_step_1m {rec['n_columns']} x {rec['nz']} f32 ({rec['route']}): "
          f"{rec['ms_per_step']:.4f} ms/step, {rec['column_updates_per_s']:.4e} column-updates/s, "
          f"launches {rec['launches']}; phase 6 in this call (median of three runs) {b1_ms:.4f} "
          f"ms/step {card}")
    check(rec["route"] == "generated" and rec["launches"] > 0, "whole_step_1m launched no kernel")
    check(abs(rec["ms_per_step"] / b1_ms - 1.0) < 0.03,
          f"whole_step_1m {rec['ms_per_step']:.4f} ms/step against phase 6's {b1_ms:.4f}")
    torch.cuda.empty_cache()
    print(f"phase 30 (d) seconds {time.perf_counter() - t:.3f}")


def phase_31(dev, card):
    """Phase 31: the reference tier of B1, B1s and B4 generated per
    configuration against the table-driven instances they replace
    (`tools.reference_tune`): each reading's units (`ptxas`, SASS counts of
    LDL, STL and CALL), both instances against the twin and their ms in
    turns; the series early exit against the fixed loop on 2^20 lanes per
    type. The block sizes and the step without the exit are the tool's
    alone (`python -m cloudy_tpu_torch.tools.reference_tune`)."""
    import torch

    from cloudy_tpu_torch.tools import reference_tune as rt

    t = time.perf_counter()

    def line(rep):
        pt, sass = rep["ptxas"], rep["sass"]
        return (f"{pt.get('registers')} registers, {pt.get('stack')} B stack, "
                f"{pt.get('spill_stores')}/{pt.get('spill_loads')} B spills; SASS LDL "
                f"{sass.get('LDL')} STL {sass.get('STL')} CALL {sass.get('CALL')} of "
                f"{sass.get('total')}")

    for r in rt.readings(dev):
        rec = rt.run_reading(r, card)
        tol = TOL["float32" if r.gen.dtype == torch.float32 else "float64"]
        print(json.dumps({"phase": 31, **rec}))
        print(f"phase 31 [{r.label}] on {rec['state']}: generated {rec['unit']} (flags {rec['flags']}, "
              f"{rec['threads']} threads; {line(rec['generated'])}, {rec['generated']['blocks_per_sm']} "
              f"blocks per SM) {rec['generated_ms']:.4f} ms against table-driven "
              f"({line(rec['table'])}) {rec['table_ms']:.4f} ms per "
              f"{'step' if r.kind == 'step' else 'launch'} in turns ({rec['speedup']:.3f}x); vs "
              f"twin {rec['generated_vs_twin']:.3e} / {rec['table_vs_twin']:.3e} (tol "
              f"{tol:.0e}) {card}")
        check(rec["generated_finite"] and rec["generated_vs_twin"] < tol,
              f"[{r.label}] generated vs twin {rec['generated_vs_twin']:.3e}")
        check(rec["generated"]["sass"].get("LDL") == 0 and rec["generated"]["sass"].get("STL") == 0,
              f"[{r.label}] generated unit reads or writes local memory: {rec['generated']['sass']}")
    for rec in rt.series_check(dev, card):
        print(json.dumps({"phase": 31, **rec}))
        print(f"phase 31 series early exit vs fixed loop, {rec['dtype']}, {rec['lanes']} lanes "
              f"({rec['series_lanes']} series, {rec['cf_lanes']} continued fraction): bit for "
              f"bit {rec['bit_for_bit']} ({rec['lanes_differing']} lanes differ); fixed "
              f"{rec['fixed_ms']:.4f} ms, exit {rec['exit_ms']:.4f} ms {card}")
        check(rec["bit_for_bit"], f"series early exit differs in {rec['lanes_differing']} "
              f"{rec['dtype']} lanes")
    print(f"phase 31 seconds {time.perf_counter() - t:.3f}")


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
    if sys.argv[1:2] == ["--phase29"]:
        child_29(*sys.argv[2:7])
    else:
        main()
