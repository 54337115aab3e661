"""Explicit time integration: fixed-step and adaptive.

Port of `cloudy_tpu.stepper` (`euler_step`, `ssprk33_step`, `rk4_step`,
`integrate`, `integrate_adaptive`); the scan becomes a Python loop over
steps, `jax.checkpoint` becomes `torch.utils.checkpoint`, the adaptive
`lax.while_loop` a Python loop with one host read per trial. The reference
integrates with OrdinaryDiffEq's SSPRK33 at fixed dt (e.g.
test/examples/Analytical/box_single_gamma.jl:36).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def euler_step(f: Callable, y, t, dt):
    return y + dt * f(y, t)


def ssprk33_step(f: Callable, y, t, dt):
    """3-stage, 3rd-order strong-stability-preserving Runge–Kutta
    (Shu–Osher), the reference's integrator of record."""
    u1 = y + dt * f(y, t)
    u2 = 0.75 * y + 0.25 * (u1 + dt * f(u1, t + dt))
    return y / 3.0 + 2.0 / 3.0 * (u2 + dt * f(u2, t + 0.5 * dt))


def rk4_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = f(y + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = f(y + dt * k3, t + dt)
    return y + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


STEPPERS = {
    "euler": euler_step,
    "ssprk33": ssprk33_step,
    "rk4": rk4_step,
}

_ORDERS = {"euler": 1, "ssprk33": 3, "rk4": 4}


def integrate_adaptive(
    f: Callable,
    y0,
    t0: float,
    t1: float,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    dt0: Optional[float] = None,
    method: str = "ssprk33",
    max_steps: int = 100_000,
    safety: float = 0.9,
):
    """Adaptive-Δt integration to ``t1`` by step doubling (the JAX
    package's `integrate_adaptive`, cloudy_tpu/stepper.py:48-136, trial for
    trial).

    An added capability beyond the reference: its parcel example passes
    reltol/abstol to OrdinaryDiffEq's SSPRK33 (parcel_example.jl:105-110),
    which has no embedded error estimator and ignores them, so the parity
    path is fixed-dt `integrate`. Each trial compares one full step against
    two half steps; their difference Δ scaled by 1/(2^p − 1) estimates the
    local error of the kept two-half-step solution, and the controller is
    ``dt ← dt·clip(safety·max(err, 1e-12)^(-1/(p+1)), 0.2, 5)`` (a NaN
    factor taken as 0.2) with rejection when the weighted RMS error exceeds
    1. `t`, `dt` and `t1` are 0-d tensors in the state's dtype, as JAX
    carries them, so the trial sequence is JAX's.

    JAX runs the loop as one `lax.while_loop` on the device. Here the loop
    is Python's: the accept test ``err <= 1`` and the loop condition are
    read on the host once per trial, which on a CUDA state is one
    synchronisation per trial (the cost of 3 steps of ``method``).

    Returns ``(y1, stats)`` with ``stats = {"n_accept", "n_reject",
    "dt_last", "t_final", "reached"}``: Python ints and bool, 0-d tensors
    for the times. ``reached`` is True iff the integration arrived at
    ``t1``; when `max_steps` trials (accepted plus rejected) run out first,
    ``y1`` is short of ``t1`` and callers must check this flag."""
    step = STEPPERS[method]
    p = _ORDERS[method]
    y = torch.as_tensor(y0)
    dtype, device = y.dtype, y.device
    t = torch.as_tensor(t0, dtype=dtype, device=device)
    t1 = torch.as_tensor(t1, dtype=dtype, device=device)
    dt = (t1 - t) / 100.0 if dt0 is None else torch.as_tensor(dt0, dtype=dtype, device=device)
    scale_err = 1.0 / (2.0**p - 1.0)
    n_accept = n_reject = 0
    more = bool(t < t1)
    while more and n_accept + n_reject < max_steps:
        dt = torch.minimum(dt, t1 - t)
        y_full = step(f, y, t, dt)
        y_half = step(f, y, t, 0.5 * dt)
        y_two = step(f, y_half, t + 0.5 * dt, 0.5 * dt)
        delta = (y_two - y_full) * scale_err
        tol = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_two))
        err = torch.sqrt(torch.mean((delta / tol) ** 2))
        # err can be 0 (exact/linear segments): guard the power law; a NaN
        # err (NaN RHS) must not poison dt, or the loop spins at the cap
        grow = safety * torch.maximum(err, err.new_tensor(1e-12)) ** (-1.0 / (p + 1))
        dt_next = dt * torch.clamp(torch.nan_to_num(grow, nan=0.2), 0.2, 5.0)
        accept = err <= 1.0
        t_try = t + dt
        # the trial's one host read: accepted, and whether t1 is still ahead
        accepted, more = torch.stack([accept, torch.where(accept, t_try, t) < t1]).tolist()
        if accepted:
            y, t = y_two, t_try
            n_accept += 1
        else:
            n_reject += 1
        dt = dt_next
    return y, {
        "n_accept": n_accept,
        "n_reject": n_reject,
        "dt_last": dt,
        "t_final": t,
        "reached": bool(t >= t1),
    }


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
