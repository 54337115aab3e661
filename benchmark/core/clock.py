"""Marks on the device's stream and the intervals between them.

On a CUDA device a mark is a CUDA event recorded on the current stream: the
time between two marks is the device's, whatever the host did meanwhile.
The CPU path (the tests' rehearsal) marks the host clock instead."""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch


class Marks:
    """An ordered list of marks on one device."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def mark(self) -> int:
        """Record a mark now (on the stream); returns its index."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def seconds(self, a: int, b: int) -> float:
        """Seconds from mark `a` to mark `b` (both recorded and reached)."""
        if self.cuda:
            return self.marks[a].elapsed_time(self.marks[b]) / 1e3
        return self.marks[b] - self.marks[a]

    def intervals(self, idx: List[int]) -> List[float]:
        """Seconds between consecutive marks of `idx`."""
        return [self.seconds(a, b) for a, b in zip(idx[:-1], idx[1:])]


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95.0))
