"""Explicit fixed-step time integration.

Port of `cloudy_tpu.stepper` (`ssprk33_step`, `integrate`); the scan becomes
a Python loop over steps. The reference integrates with OrdinaryDiffEq's
SSPRK33 at fixed dt (e.g. test/examples/Analytical/box_single_gamma.jl:36).
The remaining steppers (`euler`, `rk4`, `integrate_adaptive`) come with the
parcel model (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Callable

import torch


def ssprk33_step(f: Callable, y, t, dt):
    """3-stage, 3rd-order strong-stability-preserving Runge–Kutta
    (Shu–Osher), the reference's integrator of record."""
    u1 = y + dt * f(y, t)
    u2 = 0.75 * y + 0.25 * (u1 + dt * f(u1, t + dt))
    return y / 3.0 + 2.0 / 3.0 * (u2 + dt * f(u2, t + 0.5 * dt))


STEPPERS = {"ssprk33": ssprk33_step}


def integrate(
    f: Callable,
    y0,
    t0: float,
    dt: float,
    n_steps: int,
    method: str = "ssprk33",
    save_every: int = 1,
):
    """Fixed-dt integration of dy/dt = f(y, t).

    Returns (ts [n_saved + 1], ys [n_saved + 1, ...]) including the initial
    state; ``save_every`` thins the saved trajectory."""
    if n_steps % save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    step = STEPPERS[method]
    y = y0
    t = t0
    ys = [y0]
    for s in range(1, n_steps + 1):
        y = step(f, y, t, dt)
        t = t + dt
        if s % save_every == 0:
            ys.append(y)
    ts = t0 + dt * save_every * torch.arange(
        n_steps // save_every + 1, dtype=torch.float64
    )
    return ts, torch.stack(ys)
