"""Spans around the calls into the program, and the device trace.

A run with ``--trace 1`` profiles one stretch with `torch.profiler`,
recording the device's activity and the CUDA runtime calls that launched
it; the profiler records no host operator (on this card doing so more
than doubled the host's time per launch, and the traced loop would measure
the profiler). The benchmark marks its own spans on the host clock around
the calls it makes into the program; a device activity belongs to a span
when the runtime call that launched it (its CUPTI correlation) lies inside
that span. The program is not instrumented: nothing here reads a span or a
kernel name of its own.

The host clock and the trace's are matched by markers: a few device
synchronisations at the start of the stretch and a few at its end, each
after a reading of the host clock; the trace's runtime calls of them give
the offset at both ends, interpolated between (the profiler records the
runtime's synchronisations, not its event records). From the trace:
the device's busy time as the union of its activity intervals over the
stretch (overlapping streams counted once), the device time launched under each span, the device
operations that took most time, and the idle gaps of the device, each
named by what the host was doing at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
MARKER = "cudaDeviceSynchronize"


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


class Trace:
    """A parsed chrome trace of one profiled stretch (times in µs), with the
    benchmark's spans and the stretch, taken on the host clock, moved onto
    the trace's by the markers."""

    def __init__(self, events: list, spans: list, stretch: Tuple[float, float],
                 markers: Tuple[list, list] = ([], [])):
        self.launch_ts: Dict[int, float] = {}
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.host: List[Tuple[float, float, str]] = []
        records = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                self.launch_ts[int(args["correlation"])] = ts
            if cat in DEVICE_CATS:
                corr = args.get("correlation")
                self.device.append((ts, ts + dur, name, None if corr is None else int(corr)))
            elif cat in HOST_CATS:
                self.host.append((ts, ts + dur, name))
                if name == MARKER:
                    records.append(ts)
        self.device.sort()
        self.host.sort()
        records.sort()
        self._fit(markers, records)
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        for name, a, b in spans:
            self.spans.setdefault(name, []).append((self.to_trace(a), self.to_trace(b)))
        for v in self.spans.values():
            v.sort()
        self.window = (self.to_trace(stretch[0]), self.to_trace(stretch[1]))

    def _fit(self, markers, records):
        """The offset from the host clock to the trace's at the start and
        the end of the stretch, from the markers: the first and the last
        device synchronisations in the trace are the markers' own, each
        entered just after its host reading."""
        first, last = markers
        self.fit = None
        if not first or not last or len(records) < len(first) + len(last):
            return

        def off(reads, candidates):
            # the run of consecutive synchronisations spaced as the host
            # readings are (the profiler may add one of its own at either end)
            best = None
            for ts in candidates:
                d = np.asarray(ts) - np.asarray(reads)
                if best is None or np.ptp(d) < best[0]:
                    best = (np.ptp(d), float(np.median(d)))
            return best[1]

        n, m = len(first), len(last)
        self.fit = (first[0], off(first, [records[k:k + n] for k in range(3)]),
                    last[-1], off(last, [records[len(records) - m - k:len(records) - k]
                                         for k in range(3)]))

    def to_trace(self, t: float) -> float:
        """A host-clock time on the trace's clock."""
        if self.fit is None:
            return t
        t0, o0, t1, o1 = self.fit
        return t + o0 + (o1 - o0) * (t - t0) / max(t1 - t0, 1e-9)

    # -- the stretch -------------------------------------------------------

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def _busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity intervals inside the window."""
        lo, hi = self.window
        out: List[List[float]] = []
        for a, b, _, _ in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self._busy_intervals())

    # -- spans -------------------------------------------------------------

    def calls(self, span: str) -> int:
        """How many times the host entered `span` in the stretch."""
        return len(self.spans.get(span, []))

    def _inside(self, span: str, t: float) -> bool:
        iv = self.spans.get(span, [])
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    def device_us_under(self, span: str) -> float:
        """Device time of every activity launched inside `span`."""
        total = 0.0
        for a, b, _, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is not None and self._inside(span, t):
                total += b - a
        return total

    def device_us(self) -> float:
        """Device time of every activity in the trace (summed, not merged)."""
        return sum(b - a for a, b, _, _ in self.device)

    # -- breakdown ---------------------------------------------------------

    def top_ops(self, n: int = 10) -> List[list]:
        """The `n` device operations that took most time: [name, seconds]."""
        by: Dict[str, float] = {}
        for a, b, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span and host call active at `t`."""
        span = None
        for name, iv in self.spans.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1] and (span is None or iv[i][0] > span[0]):
                span = (iv[i][0], name)
        op = None
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        while i >= 0:
            a, b, name = self.host[i]
            if a <= t <= b and (op is None or a > op[0]):
                op = (a, name)
            if t - a > 5e6:  # host calls last far less than five seconds
                break
            i -= 1
        parts = [span[1] if span else "outside any span", op[1] if op else "no host call"]
        return " / ".join(parts)

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The `n` longest idle gaps of the device inside the window, each
        named by what the host was doing at its middle: [name, seconds]."""
        edges = [self.window[0]]
        for a, b in self._busy_intervals():
            edges += [a, b]
        edges.append(self.window[1])
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._host_at(0.5 * (a + b)), d / 1e6] for d, a, b in gaps[:n]]


class _Span:
    def __init__(self, spans: list, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = _now_us()

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t0, _now_us()))


class Tracer:
    """The spans of one run and, while `profiling`, the profiler. Outside
    the profiled stretch every span is a null context, so that the window
    measures nothing but the program."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.trace: Optional[Trace] = None
        self._spans: Optional[list] = None

    def span(self, name: str):
        if self._spans is None:
            return contextlib.nullcontext()
        return _Span(self._spans, name)

    @staticmethod
    def _markers(n: int = 8) -> list:
        """`n` device synchronisations (the device idle), each just after a
        host reading; returns the readings."""
        reads = []
        for _ in range(n):
            reads.append(_now_us())
            torch.cuda.synchronize()
        return reads

    @contextlib.contextmanager
    def profiling(self):
        """Profile the stretch inside the block (a no-op when tracing is
        off); the stretch ends synchronised. On the CPU (the rehearsal) the
        profiler records host operators, there being no device."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self._spans = []
        first = last = []
        try:
            with profile(activities=acts) as prof:
                if self.cuda:
                    first = self._markers()
                start = _now_us()
                yield
                if self.cuda:
                    torch.cuda.current_stream().synchronize()
                end = _now_us()
                if self.cuda:
                    last = self._markers()
            spans = self._spans
        finally:
            self._spans = None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.trace = Trace(events, spans, (start, end), (first, last))
