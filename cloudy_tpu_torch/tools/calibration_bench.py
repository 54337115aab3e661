"""Calibration throughput: EKI with the whole-step kernel as its forward.

Port of tools/calibration_bench.py. Two modes, one JSON record per ensemble
size on stdout (the JAX tool also writes ROOFLINE.json; this one writes
nothing):

- ``--pod`` (`pod_main`, the slice's main path): EKI whose forward model is
  the production whole-step CUDA kernel with its per-lane kernel scale
  (`ops.fused_coalescence.make_rainshaft_step_fn(kernel_scale=True)`). Each
  member's parameter θ = log s enters through the scale row; its rainshaft
  ensemble (32 columns × 32 levels) rides the lanes next to the other
  members', so one launch advances the whole ensemble by one step. 60 steps
  of the pod `fixed2gamma` configuration (f32), observables the member's
  log mean moment profile at every fourth level, 48 per member. J = 64 and
  256 members.
- default (`main`): the box forward (two gamma modes, 60 SSPRK33 steps of
  dt = 0.5 s, f32, exact F2 with GL-12) through the batched torch reference
  path `get_coal_ints`, as the JAX package runs it through XLA, at J = 64,
  256 and 1024: a check of the Kalman loop at width, not of a kernel.

Each ensemble size is timed with CUDA events around whole `run_eki` calls
(warm-up and build outside the window): seconds per iteration from the
difference of n1 and n2 iterations (tools/calibration_bench.py:132-135), the
median of five runs each. The record also gives the scale EKI recovers in 8
iterations from s = 1.7 and, for ``--pod``, the kernel launches of that run.

    python -m cloudy_tpu_torch.tools.calibration_bench --pod
    python -m cloudy_tpu_torch.tools.calibration_bench

``--device cpu`` runs the same code on the host (the whole-step kernel's
plain twin), for small shapes only.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from cloudy_tpu_torch import calibrate, harness, stepper
from cloudy_tpu_torch import distributions as pd
from cloudy_tpu_torch.coalescence import get_coal_ints
from cloudy_tpu_torch.models import rainshaft as rs
from cloudy_tpu_torch.ops import fused_coalescence as fc

S_TRUE = 1.7
NORMS = (1e6, 1e-9)


def make_pod_forward(J: int, J_cols: int = 32, nz: int = 32, n_steps: int = 60,
                     device="cuda"):
    """Batched forward of `J` members through the scaled whole-step kernel
    (tools/calibration_bench.py:25-87 for all members at once). Returns
    ``(forward, theta_truth)``: ``forward(theta [J, 1]) -> [J, 48]`` (for nz
    32), the log mean moment profile of each member's `J_cols` columns after
    `n_steps` steps, every fourth level, in the order of the JAX
    ``prof.reshape(-1)`` ([n_tot, nz/4] row-major); ``theta_truth`` is
    ``[log 1.7]``. ``forward.step`` is the kernel's wrapper (its
    ``launches`` count the forward's launches), ``forward.state0`` the
    initial state ``[6, J·J_cols·nz]`` every call starts from."""
    device = torch.device(device)
    spec, data = harness.pod_data("fixed2gamma")
    config = rs.RainshaftConfig(spec=spec, nz=nz, zmax=3000.0, norms=NORMS, dt=1.0)
    step = fc.make_rainshaft_step_fn(
        data, config.vel, NORMS, nz=nz, dz=config.dz, dt=config.dt,
        device=device, dtype=torch.float32, kernel_scale=True)
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    member = rs.to_soa(torch.as_tensor(
        np.tile(ic[None], (J_cols, 1, 1)) * np.linspace(0.7, 1.3, J_cols)[:, None, None],
        dtype=torch.float32))  # [n_tot, J_cols·nz], as the JAX state0
    state0 = member.to(device).repeat(1, J)  # member-major lanes
    lanes_per_member = J_cols * nz
    n_tot = spec.n_tot

    def forward(theta):
        if theta.shape[0] != J:
            raise ValueError(f"forward built for {J} members, got {theta.shape[0]}")
        # each member's scale on each of its lanes, member-major as state0
        scale = torch.exp(theta[:, 0]).to(torch.float32).repeat_interleave(lanes_per_member)
        y = state0
        for _ in range(n_steps):
            y = step(y, scale)
        prof = y.reshape(n_tot, J, J_cols, nz).mean(dim=2)[:, :, ::4]  # [n_tot, J, nz/4]
        prof = prof.permute(1, 0, 2).reshape(J, -1)
        safe = torch.clamp(torch.nan_to_num(prof, nan=1e12, posinf=1e12), 1e-12, 1e12)
        return torch.log(safe).to(theta.dtype)

    forward.step = step
    forward.state0 = state0
    theta_truth = torch.tensor([math.log(S_TRUE)], dtype=torch.float32, device=device)
    return forward, theta_truth


def make_box_forward(J: int, device="cuda"):
    """Batched box forward of tools/calibration_bench.py:198-211: two gamma
    modes, the linear kernel scaled by s = exp(θ), 60 SSPRK33 steps of
    dt = 0.5 s in f32, observed every 12th step: ``forward(theta [J, 1]) ->
    [J, 30]`` log moments, through the torch reference path."""
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.coalescence import build_coalescence_data
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); "
                           "ask for device='cpu' to run on the host")
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=NORMS,
                                  gammainc_iters=12, f2_exact=True, gammainc_gl_nodes=12)
    mom0 = torch.tensor([1e2, 1e1, 2.0, 1e-2, 1e-3, 2e-4], dtype=torch.float32,
                        device=device).repeat(J, 1)

    def forward(theta):
        s = torch.exp(theta[:, :1]).to(torch.float32)  # [J, 1]

        def rhs(m, t):
            return s * get_coal_ints(data, pd.params_from_moments(spec, m))

        _, ys = stepper.integrate(rhs, mom0, 0.0, 0.5, 60, save_every=12)
        safe = torch.clamp(torch.nan_to_num(ys[1:], nan=1e12, posinf=1e12), 1e-12, 1e12)
        return torch.log(safe).permute(1, 0, 2).reshape(J, -1).to(theta.dtype)

    return forward, torch.tensor([math.log(S_TRUE)], dtype=torch.float32, device=device)


def _seconds(fn, device: torch.device) -> float:
    """Seconds of one call of `fn` (CUDA events on a CUDA device, host clock
    on the CPU)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def time_eki(forward, theta0, y, noise_cov, device, min_step: int = 2,
             reps: int = 5) -> dict:
    """Seconds per EKI iteration: the median of `reps` whole `run_eki`
    calls of n1 = 1 and n2 iterations, differenced
    (tools/calibration_bench.py:123-135); n2 is sized from a pilot so the
    longer run takes about half a second."""

    def chain(n):
        res = calibrate.run_eki(forward, theta0, y, noise_cov, n, _generator(device, 1))
        return torch.sum(res.theta) + torch.sum(res.misfit_history)

    def t(n):
        chain(n)  # warm-up
        return float(np.median([_seconds(lambda: chain(n), device) for _ in range(reps)]))

    n1 = 1
    dt_pilot = max((t(n1 + min_step) - t(n1)) / min_step, 1e-9)
    n2 = n1 + int(np.clip(round(0.5 / dt_pilot), min_step, 500))
    sec = max((t(n2) - t(n1)) / (n2 - n1), 1e-12)
    return {"seconds_per_iter": sec, "n1": n1, "n2": n2}


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def pod_main(device="cuda", members=(64, 256), J_cols: int = 32, nz: int = 32,
             n_steps: int = 60):
    """EKI with the scaled whole-step kernel as the forward model
    (tools/calibration_bench.py:90-158); yields one record per ensemble
    size."""
    device = torch.device(device)
    forward1, th_true = make_pod_forward(1, J_cols, nz, n_steps, device)
    y = forward1(th_true[None])[0]
    y = y + 1e-3 * torch.randn(y.shape, generator=_generator(device, 0),
                               dtype=y.dtype, device=device)
    noise_cov = torch.tensor(1e-4, dtype=torch.float32, device=device)
    for J in members:
        forward, _ = make_pod_forward(J, J_cols, nz, n_steps, device)
        theta0 = calibrate.ensemble_init(_generator(device, J), [0.0], [0.7], J,
                                         dtype=torch.float32)
        timing = time_eki(forward, theta0, y, noise_cov, device)
        # the recovered parameter (accuracy, not only speed), with the
        # launches of this run alone
        forward.step.launches = 0
        res = calibrate.run_eki(forward, theta0, y, noise_cov, 8, _generator(device, 1))
        s_hat = torch.exp(torch.mean(res.theta[:, 0])).item()
        launches = forward.step.launches
        # one forward of the final ensemble alone: the forward's share of an
        # iteration, and its observables
        g = []
        fwd_s = _seconds(lambda: g.append(forward(res.theta)), device)
        sec = timing["seconds_per_iter"]
        yield {
            "ensemble_members": J,
            "member_columns": J_cols,
            "nz": nz,
            "forward_steps": n_steps,
            "eki_iters_per_s": 1.0 / sec,
            "member_forwards_per_s": J / sec,
            "member_model_steps_per_s": J * n_steps / sec,
            "member_column_steps_per_s": J * J_cols * n_steps / sec,
            "s_true": S_TRUE,
            "s_recovered_8iters": s_hat,
            "misfit_8iters": [float(v) for v in res.misfit_history.cpu()],
            "b1s_launches_8iters": launches,
            "observables_finite": bool(torch.isfinite(g[0]).all()),
            "forward_seconds": fwd_s,
            **timing,
            "device": _device_name(device),
            "clock": "cuda_events" if device.type == "cuda" else "host",
        }


def main(device="cuda", members=(64, 256, 1024)):
    """EKI over the batched box forward through the torch reference path
    (tools/calibration_bench.py:175-253); yields one record per ensemble
    size."""
    device = torch.device(device)
    forward1, th_true = make_box_forward(1, device)
    y = forward1(th_true[None])[0]
    y = y + 1e-3 * torch.randn(y.shape, generator=_generator(device, 0),
                               dtype=y.dtype, device=device)
    noise_cov = torch.tensor(1e-6, dtype=torch.float32, device=device)
    for J in members:
        forward, _ = make_box_forward(J, device)
        theta0 = calibrate.ensemble_init(_generator(device, J), [0.0], [0.7], J,
                                         dtype=torch.float32)
        timing = time_eki(forward, theta0, y, noise_cov, device, min_step=4)
        sec = timing["seconds_per_iter"]
        yield {
            "ensemble_members": J,
            "forward_steps": 60,
            "eki_iters_per_s": 1.0 / sec,
            "member_forwards_per_s": J / sec,
            "member_model_steps_per_s": J * 60 / sec,
            **timing,
            "device": _device_name(device),
            "clock": "cuda_events" if device.type == "cuda" else "host",
        }


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pod", action="store_true",
                    help="EKI through the scaled whole-step kernel (the main path)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    for rec in (pod_main if args.pod else main)(args.device):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    cli()
