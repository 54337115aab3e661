"""The work of each timed kernel, one file per kernel
(``benchmark/roofline/<kernel>.py``: ``work(config) -> {"ops_per_lane",
"bytes_per_lane", "type"}``), counted on the benchmark's plain reference,
and the card's published peaks (peaks.json)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent


def work(kernel: str, config: dict) -> dict:
    """The work function of `kernel` applied to `config`."""
    path = _HERE / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_roofline_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.work(config)


def bound_us(kernel: str, config: dict, lanes: int, card: str) -> Optional[float]:
    """The least time in µs the card could take for one launch of `kernel`
    over `lanes` lanes: the larger of its operations over the card's peak
    rate in the kernel's type and its bytes over the peak memory rate
    (each input read once, each output written once). None for a card
    without published peaks here."""
    peaks = json.loads((_HERE / "peaks.json").read_text())["cards"].get(card)
    if peaks is None:
        return None
    w = work(kernel, config)
    t_ops = w["ops_per_lane"] * lanes / peaks[f"{w['type']}_ops_per_s"]
    t_bytes = w["bytes_per_lane"] * lanes / peaks["bytes_per_s"]
    return 1e6 * max(t_ops, t_bytes)
