"""Scenario harness: the pod column ensemble, the box scenarios and the
128-level rainshaft on one device.

Port of `cloudy_tpu.harness` for the production workload,
`_scenario_pod_ensemble` in its three variants (`POD_VARIANTS`): an
ensemble of 1-D rainshaft columns (Golovin kernel fitted at order 1, 32
levels over 3000 m, v = 50·x^{1/6}, SSPRK33 at dt = 1 s for 120 steps, the
fast tier: exact F2 with the GL-12 incomplete gamma) in the flat
structure-of-arrays layout ``[6, n_columns·32]``, advanced one whole step per
launch of the CUDA whole-step kernel (`ops.fused_coalescence`). On a CPU
device the same wrapper runs its plain twin.

- ``pod_ensemble``: two gamma modes, fixed threshold 5e-10 kg;
- ``pod_ensemble_moving``: two gamma modes, MovingThreshold at the 0.9
  percentile (per-column thresholds inverted in-kernel every RK stage);
- ``pod_ensemble_lognorm``: lognormal + gamma, fixed threshold 5e-10 kg,
  lognormal F2 by the GL-16 recentred window.

The state is built on the device. One warm-up step (on one column) builds
the kernels and loads the module before anything is timed; the timed run is
measured with CUDA events on a CUDA device (host clock on the CPU) and the
rate divides by the steps actually run.

The pod runs through `parallel.ensemble.ensemble_whole_step`, as the JAX
harness runs it through `shard_map` (cloudy_tpu/harness.py:154-206): under
a process group (`parallel.mesh.initialize_distributed`, e.g. started by
torchrun) each of the W ranks advances its own ``n_columns / W`` columns on
its own device, and the report, the mean profile and a checkpoint are
global (all-reduced, or gathered to rank 0, which alone writes files and
prints). Without a process group W = 1 and no collective runs:

    torchrun --nproc_per_node=1 -m cloudy_tpu_torch.harness pod_ensemble --device cuda

    python -m cloudy_tpu_torch.harness pod_ensemble --columns 1048576 --device cuda
    python -m cloudy_tpu_torch.harness pod_ensemble_moving --columns 1048576 --device cuda
    python -m cloudy_tpu_torch.harness pod_ensemble_lognorm --columns 1048576 --device cuda

The three 0-D box scenarios (cloudy_tpu/harness.py:28-91) are single boxes
integrated in f64 through the torch reference path (`models.box`), each held
by tests against its stored trajectory under tests/golden/:

- ``box_single_gamma_golovin``: one gamma mode, Golovin kernel, 3 moments;
- ``box_exp_gamma_mixture``: exponential + gamma, constant + linear kernel
  tensor, threshold 5e-10 kg;
- ``box_long_numerical``: two gamma modes, the Long kernel by numerical
  quadrature (`coalescence_numerical.get_coal_ints_numerical`, the einsum
  path at (256, 96) nodes, as the JAX package runs it).

    python -m cloudy_tpu_torch.harness box_long_numerical --device cuda

``rainshaft_128`` (cloudy_tpu/harness.py:94-120) is one 1-D rainshaft
column of 128 levels over 3000 m, two gamma modes, Golovin 5.0 fitted at
order 1, fixed threshold 5e-10 kg, the default (reference, Simpson) tier,
SSPRK33 at dt = 1 s for 300 s, saved every 30 steps, in f64: the stored
golden tests/golden/rainshaft_128.npz. Its coalescence runs through torch
ops (`coalescence.get_coal_ints`) as in JAX, or with ``--hook`` through the
coalescence kernel's wrapper (`make_rainshaft_rhs(coal_fn=...)`, the plain
twin on the CPU):

    python -m cloudy_tpu_torch.harness rainshaft_128 --device cpu
    python -m cloudy_tpu_torch.harness rainshaft_128 --hook --device cuda

Each run prints one JSON report. ``--outdir DIR`` also writes the run's
NetCDF file there (``<name>.nc`` for a box or the rainshaft, the column-mean
profile ``<name>_mean_profile.nc`` for a pod ensemble) and appends the report
to DIR/runs.jsonl. ``--ckpt DIR`` runs a pod ensemble with a checkpoint
after every save interval (10 steps) under DIR and resumes from the newest
one there; the report's ``n_steps_run`` counts the steps this invocation
ran, and its rate divides by them:

    python -m cloudy_tpu_torch.harness pod_ensemble --columns 8 --device cpu --ckpt build/ck --outdir build/out
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cloudy_tpu_torch.spec import Family, SpectrumSpec
from cloudy_tpu_torch import kernels as K
from cloudy_tpu_torch.coalescence import build_coalescence_data
from cloudy_tpu_torch.models import box
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc
from cloudy_tpu_torch.parallel import ensemble as pens
from cloudy_tpu_torch.parallel import mesh as pmesh
from cloudy_tpu_torch.utils import checkpoint as ck
from cloudy_tpu_torch.utils import io, metrics

#: pod-scenario production variants (cloudy_tpu/harness.py:126-137):
#: (families, thresholds, moving, extra build_coalescence_data kwargs)
POD_VARIANTS = {
    "fixed2gamma": ((Family.GAMMA, Family.GAMMA), (5e-10, np.inf), False, {}),
    "moving": ((Family.GAMMA, Family.GAMMA), (0.9, 1.0), True, {}),
    "lognorm": ((Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf), False,
                {"lognorm_gl_nodes": 16}),
}


def pod_data(variant: str = "fixed2gamma"):
    """(spec, CoalescenceData) of one pod variant, fast tier, norms
    (1e6, 1e-9), Golovin 5.0 fitted at order 1."""
    fams, thresholds, moving, kw = POD_VARIANTS[variant]
    spec = SpectrumSpec(fams)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, thresholds, norms=(1e6, 1e-9),
                                  moving=moving, fast_tier=True, **kw)
    return spec, data


def _scenario_pod_ensemble(
    n_columns: int = 1 << 20,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    variant: str = "fixed2gamma",
) -> Dict:
    """The pod column ensemble in one of `POD_VARIANTS`: returns the
    configuration, the whole-step function (built and warmed up), this
    rank's initial state (mode 1 seeded, mode 2 empty) and ``run``.

    Under a process group of W ranks the ensemble is ``n_columns // W · W``
    columns (at least W), split over a mesh of one axis, "columns"
    (cloudy_tpu/harness.py:179-182); this rank's shard, ``state0``, is
    ``[6, n_local·32]`` on its device (``cuda:{LOCAL_RANK}`` for a bare
    "cuda"). Without one, W = 1 and the step is the wrapper's own call."""
    world, rank = pmesh.world()
    mesh = pmesh.make_mesh(("columns",)) if dist.is_initialized() else None
    device = pmesh.rank_device(device) if mesh is not None else torch.device(device)
    spec, data = pod_data(variant)
    norms = (1e6, 1e-9)
    nz = 32
    config = rs.RainshaftConfig(
        spec=spec, nz=nz, zmax=3000.0, norms=norms, t_end=120.0, dt=1.0
    )
    step = fc.make_rainshaft_step_fn(
        data, config.vel, config.norms, nz=nz, dz=config.dz, dt=config.dt,
        device=device, dtype=dtype,
    )
    sharded = pens.ensemble_whole_step(step, mesh)
    n_cols = max(n_columns // world, 1) * world
    n_local = n_cols // world
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)  # [nz, n_tot]
    column = torch.as_tensor(ic.T.copy(), dtype=dtype, device=device)
    state0 = column.repeat(1, n_local)  # [n_tot, n_local·nz], z fastest
    n_steps = int(round(config.t_end / config.dt))

    # warm-up outside any timed window: builds the kernels, loads the module
    step(column.contiguous())
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def advance(y, n: int):
        """`n` whole steps from `y`; returns (state, seconds, clock). Seconds
        come from CUDA events around the launches on a CUDA device."""
        return metrics.timed_steps(sharded, y, n)

    def run(n: int = n_steps):
        """Advance `state0` by `n` whole steps; returns (state, seconds,
        clock)."""
        return advance(state0, n)

    def profile(y):
        """The column-mean profile ``[nz, n_tot]`` over every rank's columns."""
        return column_mean(y, nz, mesh, n_cols)

    # the column-mean profile every `save_every` steps: the per-level
    # ensemble diagnostic a pod job monitors (the full state is GBs)
    save_every = max(n_steps // 12, 1)
    n_saves = n_steps // save_every

    def diagnostics():
        """(ts [n_saves], profiles [n_saves, nz, n_tot]) on the host: the
        column mean reduced on the device every `save_every` steps, a pass
        of its own outside `run` (cloudy_tpu/harness.py:255-261)."""
        y, profs = state0, []
        for _ in range(n_saves):
            y, _, _ = advance(y, save_every)
            profs.append(profile(y))
        ts = config.dt * save_every * np.arange(1.0, n_saves + 1.0)
        return ts, torch.stack(profs).cpu().numpy()

    def run_checkpointed(ckpt_path: str, segment: Optional[int] = None,
                         max_segments: Optional[int] = None):
        """The run at segment granularity (default `save_every` steps) with
        a checkpoint after every segment, resumed from the newest checkpoint
        under `ckpt_path` (cloudy_tpu/harness.py:269-305). A segment counts
        once its state has been copied to the host and its file renamed into
        place. `max_segments` stops after that many segments (simulated
        preemption) and returns None. Otherwise returns (state, seconds,
        clock, info): the seconds of this call's launches, and `info` with
        the step it resumed from, ``n_steps_run`` (the steps this call ran),
        the host seconds of each save (``save_s``), the bytes of one
        checkpoint, and ``profiles``: `diagnostics`' (ts, profiles), taken
        on the way at every `save_every` boundary and kept beside each
        checkpoint, or None where the run resumed from a checkpoint without
        them (one the JAX package wrote). The segments launch the kernel
        `run` launches, in the same order, so a resumed run is bit for bit
        an uninterrupted one.

        Under W > 1 ranks a checkpoint is one file holding the global state
        ``[6, n_columns·32]`` in JAX's format, as the JAX harness writes the
        global array: rank 0 gathers the shards and writes it (and the
        frames), then every rank waits at a barrier; on resume each rank
        reads its own columns from the newest file. `ckpt_path` must be on
        a file system every rank sees."""
        seg = int(segment or save_every)
        y, start, profs = state0, 0, []
        s0 = ck.latest_step(ckpt_path)
        if s0 is not None:
            y, start = _load_shard(ckpt_path, s0, state0, mesh)
            pf = _profile_file(ckpt_path, s0)
            profs = list(np.load(pf)) if os.path.exists(pf) else None
        done, seconds, save_s = start, 0.0, []
        clock = "cuda_events" if device.type == "cuda" else "host"
        n_bytes = 0 if s0 is None else os.path.getsize(ck.checkpoint_file(ckpt_path, s0))
        while done < n_steps:
            stop = min(done + seg, n_steps)
            while done < stop:  # up to the segment's end or the next frame
                k = min(stop, (done // save_every + 1) * save_every) - done
                y, s, clock = advance(y, k)
                seconds += s
                done += k
                if profs is not None and done % save_every == 0 and len(profs) < n_saves:
                    profs.append(profile(y).cpu().numpy())
            t0 = time.perf_counter()
            full = pens.gather_columns(y, mesh)
            if rank == 0:
                if profs is not None:
                    frames = np.asarray(profs).reshape(len(profs), nz, y.shape[0])
                    ck.write_atomic(_profile_file(ckpt_path, done),
                                    lambda f: np.save(f, frames))
                ck.save_checkpoint(ckpt_path, full, done)
            if mesh is not None:
                dist.barrier()
            save_s.append(time.perf_counter() - t0)
            n_bytes = os.path.getsize(ck.checkpoint_file(ckpt_path, done))
            if max_segments is not None and len(save_s) >= max_segments:
                return None
        ts = config.dt * save_every * np.arange(1.0, n_saves + 1.0)
        return y, seconds, clock, {"resumed_from_step": start, "n_steps_run": done - start,
                                   "save_s": save_s, "checkpoint_bytes": n_bytes,
                                   "profiles": None if profs is None else (ts, np.stack(profs))}

    return {
        "spec": spec,
        "data": data,
        "config": config,
        "step": step,
        "mesh": mesh,
        "state0": state0,
        "n_columns": n_cols,
        "n_local_columns": n_local,
        "n_steps": n_steps,
        "run": run,
        "diagnostics": diagnostics,
        "run_checkpointed": run_checkpointed,
        "kind": "ensemble",
    }


def _load_shard(ckpt_path: str, step: int, like: torch.Tensor, mesh):
    """(this rank's shard of the checkpoint at `step`, step): the whole
    state without a mesh; else this rank's columns of the file's global
    ``[n_tot, W·n_local·nz]`` state (a file of another width raises)."""
    if mesh is None:
        return ck.load_checkpoint(ckpt_path, step, like=like)
    _, n, idx = pmesh.axis_group(mesh, "columns")
    width = like.shape[1]
    leaves, saved = ck.load_checkpoint(ckpt_path, step)
    want = (like.shape[0], width * n)
    if len(leaves) != 1 or leaves[0].shape != want:
        raise ValueError(f"checkpoint {ck.checkpoint_file(ckpt_path, step)} holds "
                         f"{[a.shape for a in leaves]}, not one state of shape {want}")
    shard = torch.from_numpy(leaves[0][:, idx * width:(idx + 1) * width].copy())
    return shard.to(device=like.device, dtype=like.dtype), saved


def _profile_file(ckpt_path: str, step: int) -> str:
    """The mean-profile frames up to `step` of a checkpointed pod run, kept
    beside its checkpoint (`latest_step` does not read it)."""
    return f"{ckpt_path}_profile_step{step}.npy"


def column_mean(y: torch.Tensor, nz: int, mesh=None, n_columns: Optional[int] = None
                ) -> torch.Tensor:
    """The column-mean profile ``[nz, n_tot]`` of a SoA state ``[n_tot,
    n_columns·nz]``, reduced where the state lies, in a ``column_mean`` span
    (`utils.metrics.span`). With a `mesh`, `y` is this rank's shard: its
    column sums are all-reduced over the ranks (inside the span) and
    divided by the global `n_columns`."""
    with metrics.span("column_mean"):
        if mesh is None:
            return y.reshape(y.shape[0], -1, nz).mean(dim=1).T
        sums = y.reshape(y.shape[0], -1, nz).sum(dim=1).T.contiguous()
        group, _, _ = pmesh.axis_group(mesh, "columns")
        return pmesh.all_reduce(sums, group=group) / n_columns


def global_report(spec, final: torch.Tensor, mesh, finite: bool) -> Dict:
    """`metrics.conservation_report` and the finite flag of an ensemble
    state over every rank: this rank's sums and counts (and whether it is
    not finite) all-reduced, the fractions over the global element count.
    Without a mesh, the local report itself."""
    if mesh is None:
        return {"finite": finite, **metrics.conservation_report(spec, final)}
    group, _, _ = pmesh.axis_group(mesh, "columns")
    m0 = sum(final[..., spec.dist_moment_ind(i, 0)] for i in range(spec.n_modes))
    m1 = sum(final[..., spec.dist_moment_ind(i, 1)] for i in range(spec.n_modes))
    sums = pmesh.all_reduce(torch.stack([torch.sum(m0), torch.sum(m1)]), group=group)
    counts = pmesh.all_reduce(torch.stack([
        torch.sum(final < 0), torch.sum(~torch.isfinite(final)),
        torch.tensor(final.numel(), device=final.device),
        torch.tensor(int(not finite), device=final.device)]), group=group).tolist()
    return {
        "finite": counts[3] == 0,
        "total_number": float(sums[0]),
        "total_mass": float(sums[1]),
        "negative_fraction": counts[0] / counts[2],
        "nonfinite_fraction": counts[1] / counts[2],
    }


def _box_scenario(spec, config, rhs, mom0, device, data=None) -> Dict:
    """A box scenario in its stated precision, f64; `data` the analytical
    coalescence data where the box has it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); ask for "
            "device='cpu' to run the box on the host"
        )
    state0 = torch.tensor(mom0, dtype=torch.float64, device=device)

    def run():
        """Integrate; returns (ys [n_steps + 1, n_tot], seconds, clock)."""
        t0 = time.perf_counter()
        _, ys = box.run_box(config, rhs, state0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ys, time.perf_counter() - t0, "host"

    return {"spec": spec, "config": config, "rhs": rhs, "state0": state0,
            "data": data, "run": run, "kind": "box",
            "n_steps": int(round(config.t_end / config.dt))}


def _scenario_box_single_gamma(device="cuda") -> Dict:
    """0-D box, single gamma, Golovin kernel, 3 moments."""
    spec = SpectrumSpec((Family.GAMMA,))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=norms)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=120.0, dt=1.0)
    rhs = box.make_box_rhs(config, coal_data=data)
    return _box_scenario(spec, config, rhs, [1e8, 1e-2, 2e-12], device, data)


def _scenario_box_exp_gamma_mixture(device="cuda") -> Dict:
    """0-D box, exponential+gamma mixture, 5 prognostic moments, constant +
    linear kernel (summed tensor), finite threshold."""
    spec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA))
    norms = (1e6, 1e-9)
    # constant rate chosen so 1/(B·M0) ≈ 50 s — stable at dt = 1 s
    const = K.CoalescenceTensor.from_function(K.ConstantKernelFunction(2e-10), 1, 1e-6)
    lin = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    combined = K.CoalescenceTensor(const.array + lin.array)
    data = build_coalescence_data(spec, combined, (5e-10, np.inf), norms=norms)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=120.0, dt=1.0)
    rhs = box.make_box_rhs(config, coal_data=data)
    return _box_scenario(spec, config, rhs, [1e8, 1e-2, 1.0, 1e-8, 2e-16], device, data)


def _scenario_box_long_numerical(device="cuda") -> Dict:
    """0-D box, Long kernel via numerical quadrature, two-mode closure with
    parameter inversion."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=60.0, dt=2.0)
    rhs = box.make_box_rhs(config, kernel_func=kf, numerical=True)
    return _box_scenario(spec, config, rhs, [1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13], device)


def _scenario_rainshaft_128(device="cuda", dtype: torch.dtype = torch.float64,
                            hook: bool = False, t_end: float = 300.0,
                            **coal_kwargs) -> Dict:
    """1-D rainshaft, 128 levels, coalescence + upwind sedimentation, the
    default tier, f64. ``hook=True`` routes the coalescence through the
    coalescence kernel's wrapper on `device` (`coal_kwargs`: its per-call
    overrides); `t_end` shortens the run (saves stay every 30 steps)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); ask for "
            "device='cpu' to run the rainshaft on the host"
        )
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(spec=spec, nz=128, zmax=3000.0, norms=norms,
                                t_end=t_end, dt=1.0, save_every=30)
    coal_fn = (fc.make_coal_fn(data, device=device, dtype=dtype, **coal_kwargs)
               if hook else None)
    rhs = rs.make_rainshaft_rhs(config, data, coal_fn=coal_fn)
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)

    def run():
        """Integrate; returns (ys [n_saves, nz, n_tot], seconds, clock)."""
        t0 = time.perf_counter()
        _, ys = rs.run_rainshaft(config, rhs, ic, dtype=dtype, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ys, time.perf_counter() - t0, "host"

    return {"spec": spec, "data": data, "config": config, "coal_fn": coal_fn,
            "ic": ic, "run": run, "kind": "rainshaft",
            "n_steps": int(round(config.t_end / config.dt))}


SCENARIOS: Dict[str, Callable] = {
    "box_single_gamma_golovin": _scenario_box_single_gamma,
    "box_exp_gamma_mixture": _scenario_box_exp_gamma_mixture,
    "box_long_numerical": _scenario_box_long_numerical,
    "rainshaft_128": _scenario_rainshaft_128,
    "pod_ensemble": _scenario_pod_ensemble,
    "pod_ensemble_moving": functools.partial(_scenario_pod_ensemble, variant="moving"),
    "pod_ensemble_lognorm": functools.partial(_scenario_pod_ensemble, variant="lognorm"),
}


def run_scenario(name: str, device="cuda", outdir: Optional[str] = None,
                 ckpt_dir: Optional[str] = None, segment: Optional[int] = None,
                 max_segments: Optional[int] = None, **scenario_args):
    """Build, run and report one named scenario in its stated precision (the
    pod ensembles f32, the boxes and the rainshaft f64). `scenario_args` go
    to the scenario's builder (`n_columns` for a pod ensemble; `hook`,
    `t_end` and the coalescence overrides for the rainshaft; a box takes
    none). Returns (state, report): the final ``[n_columns, nz, n_tot]``
    state of an ensemble, the saved trajectory of a box or of the rainshaft
    (``[n_saves, nz, n_tot]``).

    With `ckpt_dir` a pod ensemble runs `run_checkpointed` under
    ``ckpt_dir/name`` (segments of `segment` steps, default its save
    interval): it resumes from the newest checkpoint there, and with
    `max_segments` it stops after that many segments and returns (None,
    report). The report's ``n_steps_run`` counts the steps this call ran,
    and the rate divides by them (null when it ran none); ``seconds`` are
    the launches' device seconds, ``save_s`` the host seconds of each save.
    Other scenarios ignore `ckpt_dir`, as in the JAX package.

    With `outdir` the run writes what `cloudy_tpu.harness.run_scenario`
    writes there: ``name.nc`` for a box or the rainshaft, the column-mean
    profile ``name_mean_profile.nc`` for a pod ensemble, and the report
    appended to ``runs.jsonl``. A checkpointed pod run takes the profile's
    frames on the way and keeps them beside its checkpoints, so a resumed
    run does not repeat the steps before its resume; otherwise (a plain
    run, or one resumed from a checkpoint without frames) they come from
    ``diagnostics``, a pass of its own after the timed run.

    Under a process group every rank calls this for a pod ensemble and gets
    its own shard as the state; the report is global (``n_columns`` the
    global count, ``world_size`` and ``n_local_columns`` beside it;
    ``seconds`` the slowest rank's, so the rate counts every rank's
    columns; totals and fractions all-reduced) but for ``launches``, this
    rank's count. Only rank 0 writes to `outdir`."""
    sc = SCENARIOS[name](device=device, **scenario_args)
    ensemble = sc["kind"] == "ensemble"
    mesh = sc.get("mesh")
    world, rank = pmesh.world()
    hooked = sc.get("coal_fn") is not None
    if ensemble:
        sc["step"].launches = 0
    if hooked:
        sc["coal_fn"].launches = 0
    ckpt = None
    if ckpt_dir and ensemble:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, name)
        before = ck.latest_step(path) or 0
        out = sc["run_checkpointed"](path, segment=segment, max_segments=max_segments)
        if out is None:
            report = {"scenario": name, "n_steps": sc["n_steps"], "completed": False,
                      "launches": sc["step"].launches,
                      "n_steps_run": ck.latest_step(path) - before}
            if rank == 0:
                _log_report(report, outdir)
            return None, report
        y, seconds, clock, ckpt = out
        n_run = ckpt["n_steps_run"]
        profiles = ckpt.pop("profiles")
    else:
        y, seconds, clock = sc["run"]()
        n_run, profiles = sc["n_steps"], None
    finite = bool(torch.all(torch.isfinite(y)))
    if mesh is not None:
        seconds = pmesh.slowest(seconds, y.device, pmesh.axis_group(mesh, "columns")[0])
    report = {
        "scenario": name,
        "device": (torch.cuda.get_device_name(y.device)
                   if y.device.type == "cuda" else y.device.type),
        "dtype": str(y.dtype).replace("torch.", ""),
        "n_steps": sc["n_steps"],
        "seconds": seconds,
        "clock": clock,
        "finite": finite,
    }
    if ensemble:
        nz = sc["config"].nz
        state = final = rs.from_soa(y, nz)  # [n_local_columns, nz, n_tot] view
        report.update({
            "n_columns": sc["n_columns"],
            "world_size": world,
            "n_local_columns": sc["n_local_columns"],
            "nz": nz,
            "launches": sc["step"].launches,
            "n_steps_run": n_run,
            "column_updates_per_s": sc["n_columns"] * n_run / seconds if n_run else None,
        })
        if ckpt is not None:
            report["completed"] = True
            report.update(ckpt)
    else:
        state, final = y, y[-1]
    if sc["kind"] == "rainshaft":
        report.update({"nz": sc["config"].nz, "save_every": sc["config"].save_every,
                       "coalescence": "kernel hook" if hooked else "torch ops"})
        if hooked:
            report["launches"] = sc["coal_fn"].launches
    if ensemble:
        report.update(global_report(sc["spec"], final, mesh, finite))
    else:
        report.update(metrics.conservation_report(sc["spec"], final))
    if outdir and ensemble and profiles is None:
        profiles = sc["diagnostics"]()  # every rank: its reductions are collective
    if outdir and rank == 0:
        os.makedirs(outdir, exist_ok=True)
        _write_output(name, sc, y, outdir, profiles)
    if rank == 0:
        _log_report(report, outdir)
    return state, report


def _write_output(name: str, sc: Dict, y: torch.Tensor, outdir: str,
                  profiles=None) -> None:
    """The NetCDF file of a run (cloudy_tpu/harness.py:368-389); a pod
    ensemble's mean profile is `profiles`, (ts, frames)."""
    cfg = sc["config"]
    if sc["kind"] == "ensemble":
        ts, profs = profiles
        io.rainshaft_output(os.path.join(outdir, f"{name}_mean_profile.nc"), sc["spec"], ts,
                            cfg.z, profs, cfg.norms)
        return
    ts = cfg.dt * cfg.save_every * np.arange(y.shape[0], dtype=np.float64)
    if sc["kind"] == "box":
        io.box_output(os.path.join(outdir, f"{name}.nc"), sc["spec"], ts, y, cfg.norms)
    else:
        io.rainshaft_output(os.path.join(outdir, f"{name}.nc"), sc["spec"], ts, cfg.z, y,
                            cfg.norms)


def _log_report(report: Dict, outdir: Optional[str]) -> None:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        metrics.JsonlLogger(os.path.join(outdir, "runs.jsonl")).log(report)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--columns", type=int, default=None,
                    help="width of a pod ensemble (default 2^20); a box takes none")
    ap.add_argument("--hook", action="store_true",
                    help="rainshaft_128: coalescence through the kernel's wrapper")
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    ap.add_argument("--outdir", default=None,
                    help="write the run's NetCDF file and append its report to runs.jsonl here")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="pod ensembles: checkpoint every save interval under DIR, and "
                         "resume from the newest checkpoint there")
    args = ap.parse_args(argv)
    scenario_args = {} if args.columns is None else {"n_columns": args.columns}
    if args.hook:
        scenario_args["hook"] = True
    # a launcher's environment (torchrun, SLURM, OpenMPI) brings up the
    # process group; without one this initialises nothing
    grouped = pmesh.initialize_distributed(device=args.device) or dist.is_initialized()
    try:
        _, report = run_scenario(args.scenario, device=args.device, outdir=args.outdir,
                                 ckpt_dir=args.ckpt, **scenario_args)
        if pmesh.world()[1] == 0:
            print(json.dumps(report))
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
