"""The program's own spans on a traced stretch's clock.

The port records spans while a `torch.profiler` session runs
(`cloudy_tpu_torch.utils.metrics`), so the profiled stretch of a
``--trace 1`` run holds them: ``launch`` around each kernel launch, from
the wrapper's entry to the return of its launch call, and ``column_mean``
around each frame's reduction. They are taken from the program once per
stretch, on the host clock (`time.perf_counter_ns`, the clock of the
benchmark's own spans), and moved onto the trace's clock by the same fit
(`Trace.to_trace`). A program without the recorder gives none, and every
reader of them then reads None.

The first reading prints on standard error how the spans meet the trace:
how many of the device activities launched under the benchmark's span
`b1` were launched by a runtime call inside exactly one program ``launch``
span, the program's spans in each of the benchmark's ``job`` spans, the
device time per launch under either, the runtime's launch calls inside the
``launch`` spans, and each idle gap of the device over 0.1 ms named with
the innermost program span open at its middle.

`ProgramSpans.device_us_under` and `ProgramSpans.idle_gaps` repeat
`Trace.device_us_under` and `Trace.idle_gaps` over program spans, and this
module reads `Trace`'s private `_inside`, `_busy_intervals` and `_host_at`:
all of it belongs in `benchmark/core/trace.py`, where `Trace` would take
the program's spans beside the benchmark's. `column_mean_ms` reads the
number `frame_reduce_ms` reads; one of the two is to go with that move.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import weakref
from typing import Dict, List, Optional, Tuple

from benchmark.core.trace import Trace

#: the benchmark's span around each call of the whole step (`drivers/pod.py`)
B1 = "b1"
#: an idle gap of the device worth naming, in us
GAP_US = 100.0

_TAKEN: "weakref.WeakKeyDictionary[Trace, Optional[ProgramSpans]]" = weakref.WeakKeyDictionary()


def _take() -> list:
    """The program's recorded spans as (name, start us, end us, attrs) on the
    host clock, cleared from the program; none where it has no recorder."""
    try:
        from cloudy_tpu_torch.utils import metrics
    except ImportError:
        return []
    take = getattr(metrics, "take_spans", None)
    if take is None:
        return []
    return [(s.name, s.start_ns / 1e3, s.end_ns / 1e3, s.attrs) for s in take()]


class ProgramSpans:
    """The program's spans inside a trace's stretch, on the trace's clock,
    by name: (start, end, attrs), sorted."""

    def __init__(self, tr: Trace, spans: list):
        self.tr = tr
        lo, hi = tr.window
        self.spans: Dict[str, List[Tuple[float, float, dict]]] = {}
        for name, a, b, attrs in spans:
            a, b = tr.to_trace(a), tr.to_trace(b)
            if lo <= a and b <= hi:
                self.spans.setdefault(name, []).append((a, b, attrs))
        for v in self.spans.values():
            v.sort(key=lambda s: s[:2])
        self._longest = {name: max(b - a for a, b, _ in v) for name, v in self.spans.items()}

    def _containing(self, name: str, t: float) -> list:
        """The program spans `name` that hold the time `t`."""
        iv = self.spans.get(name, [])
        i = bisect.bisect_right(iv, t, key=lambda s: s[0])
        j = bisect.bisect_left(iv, t - self._longest.get(name, 0.0), key=lambda s: s[0])
        return [s for s in iv[j:i] if t <= s[1]]

    def b1_launches(self) -> list:
        """The program's ``launch`` spans inside the benchmark's `b1` spans."""
        return [s for s in self.spans.get("launch", [])
                if self.tr._inside(B1, 0.5 * (s[0] + s[1]))]

    def b1_kernels(self) -> list:
        """Each device activity launched under `b1`: (its start, its end, the
        program ``launch`` spans that hold its launching runtime call)."""
        out = []
        for a, b, _, corr in self.tr.device:
            t = self.tr.launch_ts.get(corr)
            if t is not None and self.tr._inside(B1, t):
                out.append((a, b, self._containing("launch", t)))
        return out

    def device_us_under(self, spans: list) -> float:
        """Device time of the activities whose launching runtime call lies
        inside one of `spans` (sorted, none overlapping another)."""
        starts = [s[0] for s in spans]
        total = 0.0
        for a, b, _, corr in self.tr.device:
            t = self.tr.launch_ts.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += b - a
        return total

    def queued_ahead(self) -> List[int]:
        """For each `b1` kernel launched inside exactly one ``launch`` span:
        how many `b1` kernels before it had yet to end on the device when
        that span ended (one stream: they end in order)."""
        kernels = sorted(self.b1_kernels(), key=lambda k: k[0])
        ends = [b for _, b, _ in kernels]
        return [i - bisect.bisect_right(ends, spans[0][1], 0, i)
                for i, (_, _, spans) in enumerate(kernels) if len(spans) == 1]

    def _innermost(self, t: float) -> Optional[str]:
        best = None
        for name in self.spans:
            for a, _, attrs in self._containing(name, t):
                if best is None or a > best[0]:
                    label = attrs.get("label")
                    best = (a, f"{name}:{label}" if label else name)
        return None if best is None else best[1]

    def idle_gaps(self) -> List[list]:
        """The device's idle gaps over `GAP_US` in the stretch, longest first,
        each named as the trace names it with the innermost program span
        open at its middle put after the benchmark's span: [name, seconds]."""
        tr = self.tr
        edges = [tr.window[0]] + [t for iv in tr._busy_intervals() for t in iv] + [tr.window[1]]
        out = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b - a > GAP_US:
                mid = 0.5 * (a + b)
                parts = tr._host_at(mid).split(" / ")
                inner = self._innermost(mid)
                out.append([" / ".join(parts[:1] + ([inner] if inner else []) + parts[1:]),
                            (b - a) / 1e6])
        return sorted(out, key=lambda g: -g[1])

    def report(self) -> str:
        """How the program's spans meet the trace, on one line."""
        kernels = self.b1_kernels()
        one = sum(1 for *_, spans in kernels if len(spans) == 1)
        jobs = self.tr.spans.get("job", [])
        per_job = {name: [sum(1 for s in self.spans.get(name, []) if a <= s[0] <= b)
                          for a, b in jobs] for name in ("launch", "column_mean")}
        launches = self.b1_launches()
        runtime = [e - s for s, e, name in self.tr.host if "LaunchKernel" in name
                   and any(a <= s <= b for a, b, _ in self._containing("launch", s))]
        under_b1 = self.tr.device_us_under(B1) / max(self.tr.calls(B1), 1)
        under_launch = self.device_us_under(launches) / max(len(launches), 1)
        return (f"program spans: {one} of {len(kernels)} b1 kernels launched inside exactly one "
                f"program launch span; per job span launch {per_job['launch']}, column_mean "
                f"{per_job['column_mean']}; device us per call under the program's b1 launch "
                f"spans {under_launch:.3f}, under b1 {under_b1:.3f}; launch span "
                f"{_mean([b - a for a, b, _ in launches])} us, of it the runtime's "
                f"launch call {_mean(runtime)} us ({len(runtime)} calls); idle gaps "
                f"over {GAP_US:g} us {self.idle_gaps()}")


def _mean(values) -> Optional[float]:
    return statistics.fmean(values) if values else None


def of(ctx) -> Optional[ProgramSpans]:
    """The program's spans of a run's traced stretch (taken from the program
    at the first call, with the report printed); None without a device
    trace or without program spans."""
    tr = ctx.trace
    if tr is None:
        return None
    if tr not in _TAKEN:
        spans = _take()
        ps = ProgramSpans(tr, spans) if spans and tr.device else None
        if ps is not None:
            print(ps.report(), file=sys.stderr, flush=True)
        _TAKEN[tr] = ps
    return _TAKEN[tr]
