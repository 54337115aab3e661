"""One reader per metric, ``benchmark/metrics/<name>.py``, found by the
metric's name in BENCHMARK.json. A reader is ``read(ctx) -> number | None``:
None where the run holds nothing for it to read, and the metric is then
left out of the result line."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.core.trace import Trace


@dataclasses.dataclass
class Context:
    """What one run measured, for the readers."""

    cell: dict
    config: dict
    traffic: dict
    device: torch.device
    #: seconds from the start of the process to the start of the window
    setup_s: float
    #: the driver's record of the window: window_s, work, intervals,
    #: attempted, dispatch {host_s, launches}, lanes {kernel: lanes}
    window: dict
    #: the profiled stretch of a ``--trace 1`` run, else None
    trace: Optional[Trace]
    seed: int


def roofline_share(ctx: Context, kernel: str) -> Optional[float]:
    """The share, in %, of the least time the card could take for one
    launch of `kernel` (``benchmark/roofline/<kernel>.py``'s work at this
    cell's lanes against the card's published peaks) in the device time of
    the activities launched under the span `kernel`, per call."""
    from benchmark.roofline import bound_us

    tr = ctx.trace
    if tr is None or not tr.calls(kernel) or kernel not in ctx.window.get("lanes", {}):
        return None
    us = tr.device_us_under(kernel) / tr.calls(kernel)
    bound = bound_us(kernel, ctx.config, ctx.window["lanes"][kernel],
                     torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "")
    if not us or bound is None:
        return None
    return 100.0 * bound / us
