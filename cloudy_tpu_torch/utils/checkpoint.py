"""Checkpoint/resume for long runs.

Port of the npz path of `cloudy_tpu.utils.checkpoint` (:18-105), in its
file format: ``{path}_step{step}.npz`` holding ``step``, ``n_leaves`` and
``leaf{i}``, the state's leaves in JAX's pytree order (a dict by sorted key,
a list or tuple in order, anything else one leaf). A checkpoint that either
package writes therefore resumes in the other. Leaves are stored as host
arrays in their own type, so the round trip is exact. A file is written
under a temporary name and renamed into place, so a process cut while it
writes leaves no partial checkpoint for `latest_step` to find.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def _flatten(state) -> list:
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in _flatten(state[k])]
    if isinstance(state, (list, tuple)):
        return [leaf for s in state for leaf in _flatten(s)]
    return [state]


def _unflatten(like, leaves):
    """`leaves` (an iterator) in the structure of `like`: a leaf whose
    counterpart in `like` is a tensor becomes a tensor on that tensor's
    device in its dtype. A leaf whose shape is not its counterpart's
    raises: the checkpoint is of another configuration."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(s, leaves) for s in like)
    leaf = next(leaves)
    shape = getattr(like, "shape", None)
    if shape is not None and tuple(shape) != leaf.shape:
        raise ValueError(f"checkpoint leaf of shape {leaf.shape} where `like` has "
                         f"{tuple(shape)}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(leaf).to(device=like.device, dtype=like.dtype)
    return leaf


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def checkpoint_file(path: str, step: int) -> str:
    """The file of the checkpoint at `step` under `path`."""
    return f"{path}_step{step}.npz"


def write_atomic(fname: str, write: Callable) -> None:
    """``write(f)`` into a file opened under ``fname + ".tmp"``, then the file
    renamed onto `fname`: a process cut while it writes leaves the temporary
    file only, never a partial `fname`."""
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, fname)


def save_checkpoint(path: str, state, step: int) -> None:
    """Persist (state, step). A tensor on the card is copied to the host
    first, so the file holds what the device held when the call began."""
    flat = [_host(leaf) for leaf in _flatten(state)]
    write_atomic(checkpoint_file(path, step), lambda f: np.savez(
        f,
        step=np.int64(step),
        n_leaves=len(flat),
        **{f"leaf{i}": a for i, a in enumerate(flat)},
    ))


def load_checkpoint(path: str, step: int, like=None):
    """Restore (state, step) written by `save_checkpoint` (either
    package's). `like` gives the structure, and for each tensor leaf the
    device and dtype to restore to; without it the state is the list of
    host arrays."""
    with np.load(checkpoint_file(path, step)) as data:
        flat = [data[f"leaf{i}"] for i in range(int(data["n_leaves"]))]
        saved = int(data["step"])
    if like is None:
        return flat, saved
    leaves = iter(flat)
    state = _unflatten(like, leaves)
    if next(leaves, None) is not None:
        raise ValueError(f"checkpoint {checkpoint_file(path, step)} holds more leaves "
                         "than `like` has")
    return state, saved


def latest_step(path: str) -> Optional[int]:
    """Newest checkpoint step saved under ``path_step*`` (a temporary file
    of a save that was cut does not count)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path) + "_step"
    steps = []
    for name in os.listdir(d):
        if name.startswith(base):
            tail = name[len(base):].removesuffix(".npz")
            if tail.isdigit():
                steps.append(int(tail))
    return max(steps) if steps else None


def run_segments(step_fn: Callable, state, n_steps: int, segment: int,
                 ckpt_path: Optional[str] = None, resume: bool = True):
    """Apply `step_fn` ``n_steps`` times in segments of `segment` steps,
    checkpointing after each segment and resuming from the newest
    checkpoint when `resume`; returns (state, steps done)."""
    start = 0
    if ckpt_path and resume:
        s = latest_step(ckpt_path)
        if s is not None:
            state, start = load_checkpoint(ckpt_path, s, like=state)
    done = start
    while done < n_steps:
        for _ in range(segment):
            state = step_fn(state)
        done += segment
        if ckpt_path:
            save_checkpoint(ckpt_path, state, done)
    return state, done
