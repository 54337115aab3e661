"""Observability: step timing, physics invariant monitors, a JSONL log,
and spans.

Port of `cloudy_tpu.utils.metrics` (`StepTimer`, `conservation_report`,
`JsonlLogger`); the reductions run where the state lies (on the card for a
CUDA state), and a call whose result is a CUDA tensor is timed by CUDA
events.

The span recorder (`span`, `recording`, `take_spans`) times the port's own
work on the host clock, kept in memory (the newest `MAX_SPANS`): each
kernel launch (``launch``, `ops.fused_coalescence`) and each column-mean
frame (``column_mean``, `harness.column_mean`). It records only while a
`torch.profiler` session profiles the process, so that a profile carries
the port's spans; a profile taken by the port's own tools
(`tools/profile_step.py`, `chip_smoke.py`) pays for them too. Its clock,
`time.perf_counter_ns`, is the one whose readings a profile's trace is
fitted to.
"""

from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler


@dataclass
class StepTimer:
    """Accumulates per-call seconds: device seconds (CUDA events) for a call
    that returns a CUDA tensor, host seconds otherwise."""

    times: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def time_step(self):
        """Host seconds of the block (the caller synchronises)."""
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def timed_call(self, fn, *args):
        """``fn(*args)``, timed. The events bracket the call on the current
        stream, so the time is the device's, the launch included."""
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn(*args)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            end.record()
            end.synchronize()
            self.times.append(start.elapsed_time(end) / 1e3)
        else:
            self.times.append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, float]:
        """Statistics over the calls after the first (its build and warm-up),
        over all of them when there is one."""
        t = np.asarray(self.times[1:] or self.times)
        return {
            "n": len(self.times),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "min_s": float(t.min()),
        }


def timed_steps(step, y: torch.Tensor, n: int):
    """`n` applications of `step` from `y`; returns (state, seconds, clock):
    the seconds from CUDA events around the launches for a CUDA state
    (clock "cuda_events"), from the host clock otherwise ("host")."""
    if y.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            y = step(y)
        end.record()
        end.synchronize()
        return y, start.elapsed_time(end) / 1e3, "cuda_events"
    t0 = time.perf_counter()
    for _ in range(n):
        y = step(y)
    return y, time.perf_counter() - t0, "host"


def card_name(device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them for a CUDA
    `device`, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()


def conservation_report(spec, mom_flat) -> Dict[str, float]:
    """Mass/number totals + positivity violations for a state
    ``[..., n_tot]`` (the SCE's gain−loss structure conserves total M1;
    M0 must fall, M2 rise)."""
    mom = mom_flat
    m0 = sum(mom[..., spec.dist_moment_ind(i, 0)] for i in range(spec.n_modes))
    m1 = sum(mom[..., spec.dist_moment_ind(i, 1)] for i in range(spec.n_modes))
    return {
        "total_number": float(torch.sum(m0)),
        "total_mass": float(torch.sum(m1)),
        "negative_fraction": float(torch.mean((mom < 0).to(torch.float32))),
        "nonfinite_fraction": float(
            torch.mean((~torch.isfinite(mom)).to(torch.float32))
        ),
    }


class JsonlLogger:
    """Append-only JSONL metrics log (one dict per line)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------


#: the most spans the recorder keeps: beyond it the oldest are dropped, so a
#: profile whose spans nobody takes holds a bounded list
MAX_SPANS = 1 << 16


@dataclass(slots=True)
class Span:
    """One recorded span: its `name`, its start and end in
    `time.perf_counter_ns` nanoseconds and what its site attached
    (`attrs`)."""

    name: str
    start_ns: int
    end_ns: int
    attrs: dict


_spans: Deque[Span] = collections.deque(maxlen=MAX_SPANS)
_NULL_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether `span` records: while a `torch.profiler` session profiles
    the process."""
    return _torch_profiler._is_profiler_enabled


def take_spans() -> List[Span]:
    """The spans recorded since the last call (the newest `MAX_SPANS`), in
    the order they opened, and clear them; take them with no span open."""
    global _spans
    out, _spans = _spans, collections.deque(maxlen=MAX_SPANS)
    return list(out)


class _OpenSpan:
    __slots__ = ("_rec",)

    def __init__(self, name: str, attrs: dict):
        self._rec = Span(name, 0, 0, attrs)

    def __enter__(self) -> dict:
        rec = self._rec
        _spans.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec.attrs

    def __exit__(self, *exc) -> None:
        self._rec.end_ns = time.perf_counter_ns()


def span(name: str, **attrs):
    """A context manager that records the span `name` around its block
    while the recorder is on (`recording`); entering it gives the span's
    `attrs`, which the block may add to. While the recorder is off, the one
    shared null context (entering it gives None), after one flag test: it
    reads no clock and keeps nothing."""
    if not _torch_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _OpenSpan(name, attrs)
