"""Seeds: every input of a run is drawn from ``--seed`` and a tag, so that
the same seed gives the same inputs and the check can draw them again."""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tag) -> int:
    """A 63-bit seed for the stream named by `tag` (any values) under `seed`."""
    text = ":".join(str(v) for v in (seed,) + tag)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(device, seed: int, *tag) -> torch.Generator:
    """A generator on `device` seeded for the stream `tag` under `seed`."""
    return torch.Generator(device=torch.device(device)).manual_seed(derive(seed, *tag))


def uniform(seed: int, *tag) -> float:
    """One number in [0, 1) for the stream `tag` under `seed`."""
    return derive(seed, *tag) / 2.0 ** 63
