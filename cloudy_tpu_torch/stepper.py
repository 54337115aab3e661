"""Explicit fixed-step time integration.

Port of `cloudy_tpu.stepper` (`ssprk33_step`, `integrate`); the scan becomes
a Python loop over steps, `jax.checkpoint` becomes
`torch.utils.checkpoint`. The reference integrates with OrdinaryDiffEq's
SSPRK33 at fixed dt (e.g. test/examples/Analytical/box_single_gamma.jl:36).
The remaining steppers (`euler`, `rk4`, `integrate_adaptive`) come with the
parcel model (ROADMAP A.9).
"""

from __future__ import annotations

import functools
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
    remat: bool = False,
):
    """Fixed-dt integration of dy/dt = f(y, t).

    Returns (ts [n_saved + 1], ys [n_saved + 1, ...]) including the initial
    state; ``save_every`` thins the saved trajectory. ``remat=True`` wraps
    each step in `torch.utils.checkpoint.checkpoint` (non-reentrant, so
    gradients reach tensors `f` closes over): autograd keeps only the step
    inputs and recomputes the stages in the backward pass.

    `t` is carried as a 0-d tensor in the state's dtype (on the host), as
    JAX carries it in its scan (cloudy_tpu/stepper.py:178): each step adds
    dt in that dtype, so an `f` that reads `t` sees JAX's values, rounding
    included."""
    if n_steps % save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    step = STEPPERS[method]
    if remat:
        from torch.utils.checkpoint import checkpoint

        step = functools.partial(checkpoint, step, use_reentrant=False)
    y = y0
    t = torch.tensor(t0, dtype=y0.dtype)
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
