"""B1, the whole step of the pod (float32): the reference's operations per
lane-step, counted on a few columns of the configuration's initial state
(the fast tier's work does not depend on the data), and the bytes: the
state read once and written once."""

import numpy as np
import torch

from benchmark.reference import rainshaft as ref
from benchmark.roofline.count import count_ops

COLUMNS = 8


def state(config: dict) -> torch.Tensor:
    col = ref.initial_column(config["physics"])
    fac = np.linspace(0.7, 1.3, COLUMNS)
    return torch.as_tensor((col[:, None, :] * fac[None, :, None]).reshape(col.shape[0], -1))


def work(config: dict) -> dict:
    t = ref.build_tables(config["physics"], config["program"]["dtype"])
    y = state(config)
    ops = count_ops(lambda m: ref.step(t, m), y) / y.shape[1]
    return {"ops_per_lane": ops, "bytes_per_lane": 2 * t.n_tot * 4, "type": "f32"}
