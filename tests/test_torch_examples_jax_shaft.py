"""The port's condensation and rainshaft example scripts against the JAX
library, on the CPU in FAST mode, f64, rtol 1e-10 over the trajectory
(the method and the boxes: tests/test_torch_examples_jax.py; JAX's
condensation box run as its boxes are)."""

import pytest
import torch

from test_torch_examples_jax import check_example_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["condensation_exp_gamma", "condensation_single_gamma",
                                  "rainshaft_gamma_mixture", "rainshaft_single_gamma"])
def test_example_matches_jax(name, tmp_path, monkeypatch):
    check_example_against_jax(name, tmp_path, monkeypatch)
