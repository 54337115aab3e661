"""The pod job: a million-column rainshaft ensemble advanced in jobs.

A job starts from initial conditions drawn from the seed, advances every
column `frames_per_job` × `steps_per_frame` whole steps through the
port's whole-step kernel (`ops.fused_coalescence.make_rainshaft_step_fn`
under `parallel.ensemble.ensemble_whole_step`), reduces the column-mean
profile (`harness.column_mean`) after every `steps_per_frame` steps, and
copies the job's frames to the host at its end. Jobs run back to back, a
closed loop: the next starts when the previous one's frames are on the host.

Each column is the configuration's top-hat column scaled by one of
`scale_levels` factors evenly spaced over `scale_range` (the grid shifted
by a phase drawn from the seed), chosen per column and per job from the
seed. Every column's trajectory is then one of `scale_levels`, so the
reference computes every frame of every job exactly from that many
columns, weighted by how often each job drew them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import seeds
from benchmark.core.clock import Marks
from benchmark.reference import rainshaft as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer):
        from cloudy_tpu_torch import harness
        from cloudy_tpu_torch.models import rainshaft as rs
        from cloudy_tpu_torch.ops import fused_coalescence as fc
        from cloudy_tpu_torch.parallel import ensemble as pens

        self.harness = harness
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.tracer = tracer
        phys = config["physics"]
        self.nz = int(phys["levels"])
        self.N = int(traffic["columns"])
        self.frames = int(traffic["frames_per_job"])
        self.steps = int(traffic["steps_per_frame"])
        self.K = int(traffic["scale_levels"])
        spec, data = harness.pod_data(config["program"]["variant"])
        rcfg = rs.RainshaftConfig(spec=spec, nz=self.nz, zmax=float(phys["zmax"]),
                                  norms=tuple(phys["norms"]), dt=float(phys["dt"]))
        self.step = fc.make_rainshaft_step_fn(data, rcfg.vel, rcfg.norms, nz=self.nz,
                                              dz=rcfg.dz, dt=rcfg.dt, device=self.device,
                                              dtype=torch.float32)
        self.advance = pens.ensemble_whole_step(self.step, None)
        self.n_tot = spec.n_tot
        self.base = torch.as_tensor(ref.initial_column(phys), dtype=torch.float32,
                                    device=self.device)[:, None, :]  # [n_tot, 1, nz]
        lo, hi = traffic["scale_range"]
        phase = seeds.uniform(seed, "phase")
        self.factors = torch.as_tensor(lo + (hi - lo) * (np.arange(self.K) + phase) / self.K,
                                       dtype=torch.float32, device=self.device)
        #: lanes of one launch, for the rooflines
        self.lanes = {"b1": self.N * self.nz}
        # warm-up: every shape of a job once (the kernel's build and load,
        # the allocator's blocks for the state, the reduction, the copy)
        y, _ = self._job(("warm-up",), Marks(self.device), [], n_frames=1, n_steps=1)
        del y
        self._sync()

    # -- one job -------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _assignment(self, tag) -> torch.Tensor:
        """The scale level of each column of job `tag`, [N] int64."""
        g = seeds.generator(self.device, self.seed, "job", *tag)
        return torch.randint(0, self.K, (self.N,), generator=g, device=self.device)

    def _job(self, tag, marks: Marks, frame_marks: list, n_frames=None, n_steps=None,
             dispatch=None):
        span = self.tracer.span
        with span("job"):
            with span("ic"):
                c = self.factors[self._assignment(tag)]
                y = (self.base * c[None, :, None]).reshape(self.n_tot, self.N * self.nz)
            frames = []
            for _ in range(n_frames or self.frames):
                t0, n0 = time.perf_counter(), self.step.launches
                for _ in range(n_steps or self.steps):
                    with span("b1"):
                        y = self.advance(y)
                with span("column_mean"):
                    frames.append(self.harness.column_mean(y, self.nz))
                frame_marks.append(marks.mark())
                if dispatch is not None:
                    dispatch["host_s"] += time.perf_counter() - t0
                    dispatch["launches"] += self.step.launches - n0
            with span("read"):
                out = torch.stack(frames).cpu()
        return y, out

    # -- the window ----------------------------------------------------------

    def run(self, seconds: float) -> dict:
        """Jobs back to back until the host clock passes `seconds`; the
        window ends with the read of the job in flight then. A traced run
        then profiles `trace_jobs` jobs more, outside the window, and times
        the host's enqueue in the window itself."""
        marks = Marks(self.device)
        frame_marks = [marks.mark()]
        self.jobs = []
        dispatch = {"host_s": 0.0, "launches": 0}
        t0 = time.perf_counter()
        while not self.jobs or time.perf_counter() - t0 < seconds:
            y, out = self._job((len(self.jobs),), marks, frame_marks,
                               dispatch=dispatch if self.tracer.enabled else None)
            self.jobs.append(out)
        self._sync()
        window_s = time.perf_counter() - t0
        n_window = len(self.jobs)
        with self.tracer.profiling():
            for _ in range(int(self.traffic["trace_jobs"]) if self.tracer.enabled else 0):
                y, out = self._job((len(self.jobs),), marks, [])
                self.jobs.append(out)
        # the last job's final state: a sample of its columns, drawn from the seed
        S = min(self.N, int(self.traffic["check_columns"]))
        g = seeds.generator(self.device, self.seed, "check-columns")
        self.check_cols = torch.sort(torch.randperm(self.N, generator=g, device=self.device)[:S])[0]
        self.final = y.reshape(self.n_tot, self.N, self.nz)[:, self.check_cols, :].clone()
        del y
        return {
            "window_s": window_s,
            "work": float(n_window * self.N * self.frames * self.steps),
            "intervals": {"frame": marks.intervals(frame_marks)},
            "attempted": len(self.jobs),
            "dispatch": dispatch,
            "lanes": self.lanes,
        }

    def release(self):
        """Free the program's state, keeping the outputs to be judged."""
        del self.step, self.advance
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference_states(self, control_dtype=None) -> torch.Tensor:
        """The `scale_levels` distinct columns' states after every frame,
        ``[frames, n_tot, K, nz]``, from the same float32 initial values the
        program got: the reference in float64 with the stated type's
        thresholds, or the control, in `control_dtype` with its own."""
        dtype = control_dtype or torch.float64
        kind = (str(control_dtype).replace("torch.", "") if control_dtype
                else self.cfg["program"]["dtype"])
        t = ref.build_tables(self.cfg["physics"], kind)
        ic = (self.base * self.factors[None, :, None]).reshape(self.n_tot, self.K * self.nz)
        states = ref.run(t, ic.to(dtype), self.frames * self.steps, self.steps)
        return states.reshape(self.frames, self.n_tot, self.K, self.nz).double()

    def _counts(self) -> torch.Tensor:
        """How many columns of each job drew each scale level, [jobs, K]."""
        return torch.stack([torch.bincount(self._assignment((j,)), minlength=self.K)
                            for j in range(len(self.jobs))]).double()

    def _outputs(self, states: torch.Tensor):
        """What the program would give if its columns followed `states`:
        every job's frames [jobs, F, nz, n_tot] and the sampled columns of
        the last job's final state [n_tot, S, nz]."""
        frames = torch.einsum("jk,fmkz->jfzm", self._counts(), states) / self.N
        last = self._assignment((len(self.jobs) - 1,))[self.check_cols]
        return frames, states[-1][:, last, :]

    @staticmethod
    def _gaps(got_frames, got_final, want_frames, want_final) -> dict:
        """The widest gaps, each moment's profile scaled by its largest
        reference value: of every frame of every job (with each job's own),
        and of the sampled final columns."""
        tiny = torch.finfo(torch.float64).tiny
        gap = ((got_frames - want_frames).abs().amax(dim=2)
               / want_frames.abs().amax(dim=2).clamp(min=tiny))
        per_job = gap.nan_to_num(nan=float("inf")).amax(dim=(1, 2))
        scale = want_final.abs().amax(dim=(1, 2)).clamp(min=tiny)
        gap_s = ((got_final - want_final).abs().amax(dim=(1, 2)) / scale).nan_to_num(
            nan=float("inf"))
        return {"frames": (float(per_job.max()), per_job.tolist()),
                "state": (float(gap_s.max()), None)}

    def check(self, control_dtype=None) -> dict:
        """{name: (gap, per-job gaps or None)} of the program's outputs
        against the float64 reference; with `control_dtype`, of the
        reference computed in that type put in the program's place."""
        states = self.reference_states()
        want_frames, want_final = self._outputs(states)
        if control_dtype is None:
            got_frames = torch.stack(self.jobs).to(states.device).double()
            got_final = self.final.double()
        else:
            got_frames, got_final = self._outputs(self.reference_states(control_dtype))
        return self._gaps(got_frames, got_final, want_frames, want_final)
